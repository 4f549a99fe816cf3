"""Fused 1×1 convolution + batch-norm kernels (port of
``tools/fused_conv_bn.py``, the probe's two Pallas kernels).

* ``conv1x1_bn_stats`` — x [M, Ci] · w [Ci, Co] → y [M, Co] in x's type, and
  the per-channel sum and sum of squares [Co] f32 of the f32 product before
  y is cast: the batch-norm statistics ride in the product's epilogue, so y
  is not read again for them.
* ``conv1x1_bn_act_2pass`` — a statistics pass that does not write y, the
  [Co]-sized fold of mean, variance, scale and bias into mul/add, then a
  pass that recomputes the product and writes only act(y·mul + add): the
  raw product never reaches device memory.

Both run ``csrc/conv_bn.cu`` on CUDA tensors and their plain PyTorch
versions (``*_ref``) on CPU tensors; there is no fallback. bf16 takes the
tensor cores (``mma.sync``, f32 sums in the tensor core's order: y within
a reordered Ci-term f32 sum of the plain version's before the cast); f32
takes the CUDA cores and sums each element's products over k in order,
each product and sum rounded on its own, as the plain version does. On the
card the fold runs inside the kernel that adds the blocks' partial sums,
in ``fold_batch_norm``'s op order: ``conv1x1_bn_act_2pass`` is three
launches (statistics, finalize with the fold, normalize).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fedmlp_tpu_torch.ops import _build

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"conv1x1_bn_stats": 0, "conv1x1_bn_act_2pass": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _product_ref(x2d, w):
    """f32 x·w summed over k = 0 .. Ci−1 in order, each product and each
    sum rounded on its own: the kernel's order, so the two agree bit for
    bit."""
    xf, wf = x2d.float(), w.float()
    y = torch.zeros((x2d.shape[0], w.shape[1]), dtype=torch.float32, device=x2d.device)
    for k in range(x2d.shape[1]):
        y = y + xf[:, k:k + 1] * wf[k]
    return y


def conv1x1_bn_stats_ref(x2d, w):
    """Plain PyTorch version of ``conv1x1_bn_stats``, same arguments."""
    y = _product_ref(x2d, w)
    return y.to(x2d.dtype), y.sum(0), (y * y).sum(0)


def fold_batch_norm(s, ss, M: int, scale, bias, eps: float):
    """The [Co]-sized arithmetic between the two passes, as
    tools/fused_conv_bn.py:103-108: (mean, var, mul, add) with
    out = y·mul + add the batch-normalized product."""
    mean = s / M
    var = torch.clamp(ss / M - mean * mean, min=0.0)
    rsig = torch.rsqrt(var + eps)
    scale_f = scale.to(torch.float32)
    mul = rsig * scale_f
    add = bias.to(torch.float32) - mean * rsig * scale_f
    return mean, var, mul, add


def _activate(z, act: str):
    """swish for act == 'swish', else the identity (as the JAX kernel)."""
    return z * torch.sigmoid(z) if act == "swish" else z


def conv1x1_bn_act_2pass_ref(x2d, w, scale, bias, eps: float = 1e-3,
                             act: str = "swish"):
    """Plain PyTorch version of ``conv1x1_bn_act_2pass``, same arguments."""
    y = _product_ref(x2d, w)
    mean, var, mul, add = fold_batch_norm(y.sum(0), (y * y).sum(0), x2d.shape[0],
                                          scale, bias, eps)
    return _activate(y * mul + add, act).to(x2d.dtype), mean, var


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _check(name, x2d, w):
    if x2d.dim() != 2 or w.dim() != 2 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"{name}: x must be [M, Ci] and w [Ci, Co], got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.dtype not in _DTYPES or w.dtype != x2d.dtype:
        raise ValueError(f"{name}: x and w must both be f32 or both bf16, got "
                         f"{x2d.dtype} and {w.dtype}")
    if w.device != x2d.device:
        raise ValueError(f"{name}: w on {w.device}, x on {x2d.device}")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x2d.device}")


def _check_cuda(name, lib, x2d, w):
    if not (x2d.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    if x2d.shape[1] > lib.max_ci:
        raise ValueError(f"{name}: Ci={x2d.shape[1]} above the kernel's {lib.max_ci}")


def _partials(lib, x2d, Co, n_vectors):
    """Scratch of one launch: f32 ``n_vectors`` [Co] vectors the kernels
    pass on among themselves (mul and add), then the blocks' partial sums
    and sums of squares [row blocks, Co] each. Returns the buffer, to hold
    while the launches run, and the device address of each of its
    n_vectors + 2 parts (addresses, not views: a view costs host time on
    every call)."""
    M, Ci = x2d.shape
    nb = lib.conv1x1_row_blocks(M, Ci, Co, int(x2d.dtype == torch.bfloat16))
    if nb < 1:
        raise RuntimeError("conv1x1 launch plan failed: CUDA error")
    buf = torch.empty((n_vectors + 2 * nb) * Co, dtype=torch.float32, device=x2d.device)
    base = buf.data_ptr()
    offsets = [i * Co for i in range(n_vectors)] + [n_vectors * Co, (n_vectors + nb) * Co]
    return buf, [base + 4 * o for o in offsets]


def _check_dest(name, x2d, Co, dest):
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: the launch into a given tensor takes CUDA tensors, "
                         f"got {x2d.device}")
    if (tuple(dest.shape) != (x2d.shape[0], Co) or dest.dtype != x2d.dtype
            or dest.device != x2d.device or not dest.is_contiguous()):
        raise ValueError(f"{name}: the destination must be a contiguous [{x2d.shape[0]}, "
                         f"{Co}] {x2d.dtype} tensor on {x2d.device}, got "
                         f"{tuple(dest.shape)} {dest.dtype} on {dest.device}")


def conv1x1_bn_stats(x2d, w):
    """x2d [M, Ci] · w [Ci, Co] (both f32 or both bf16) → (y [M, Co] in x2d's
    type, channel sum [Co] f32, channel sum of squares [Co] f32), the sums
    of the f32 product before the cast. A CPU pair takes the plain version;
    a CUDA pair launches ``csrc/conv_bn.cu`` (or raises). Any M; Ci up to
    256."""
    _check("conv1x1_bn_stats", x2d, w)
    if x2d.device.type == "cpu":
        return conv1x1_bn_stats_ref(x2d, w)
    y = torch.empty((x2d.shape[0], w.shape[1]), dtype=x2d.dtype, device=x2d.device)
    return (y, *conv1x1_bn_stats_into(x2d, w, y))


def conv1x1_bn_stats_into(x2d, w, y):
    """``conv1x1_bn_stats`` on the card into the caller's y (contiguous
    [M, Co] in x2d's type, e.g. a view of a larger buffer) → (sum, sum of
    squares) [Co] f32. CUDA tensors only."""
    _check("conv1x1_bn_stats", x2d, w)
    M, Ci = x2d.shape
    Co = w.shape[1]
    _check_dest("conv1x1_bn_stats", x2d, Co, y)
    lib = _lib()
    _check_cuda("conv1x1_bn_stats", lib, x2d, w)
    sums = torch.empty((2, Co), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):  # the launch goes to the current device
        buf, (psum, pssq) = _partials(lib, x2d, Co, 0)
        err = lib.conv1x1_bn_stats_run(
            x2d.data_ptr(), w.data_ptr(), y.data_ptr(), sums.data_ptr(),
            sums.data_ptr() + 4 * Co, psum, pssq, M, Ci, Co,
            int(x2d.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1x1 statistics pass launch failed: CUDA error {err}")
    LAUNCH_COUNTS["conv1x1_bn_stats"] += 1
    return sums[0], sums[1]


def conv1x1_bn_act_2pass(x2d, w, scale, bias, eps: float = 1e-3, act: str = "swish"):
    """Two-pass pointwise convolution + batch norm (batch statistics) +
    activation: x2d [M, Ci] · w [Ci, Co], scale and bias [Co] → (out [M, Co]
    in x2d's type, mean [Co] f32, var [Co] f32 (biased)). ``act`` 'swish'
    applies z·σ(z); any other value the identity, as the JAX kernel. A CPU
    pair takes the plain version; a CUDA pair launches ``csrc/conv_bn.cu``
    three times: the statistics pass, the finalize with the fold, the
    normalize pass (or raises)."""
    _check("conv1x1_bn_act_2pass", x2d, w)
    if x2d.device.type == "cpu":
        return conv1x1_bn_act_2pass_ref(x2d, w, scale, bias, eps, act)
    out = torch.empty((x2d.shape[0], w.shape[1]), dtype=x2d.dtype, device=x2d.device)
    return (out, *conv1x1_bn_act_2pass_into(x2d, w, scale, bias, out, eps, act))


def conv1x1_bn_act_2pass_into(x2d, w, scale, bias, out, eps: float = 1e-3,
                              act: str = "swish"):
    """``conv1x1_bn_act_2pass`` on the card into the caller's out
    (contiguous [M, Co] in x2d's type) → (mean, var) [Co] f32. CUDA tensors
    only."""
    _check("conv1x1_bn_act_2pass", x2d, w)
    M, Ci = x2d.shape
    Co = w.shape[1]
    _check_dest("conv1x1_bn_act_2pass", x2d, Co, out)
    lib = _lib()
    _check_cuda("conv1x1_bn_act_2pass", lib, x2d, w)
    if M == 0:
        raise ValueError("conv1x1_bn_act_2pass: batch statistics of M=0 rows")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (Co,) or t.device != x2d.device:
            raise ValueError(f"conv1x1_bn_act_2pass: {name} must be [{Co}] on "
                             f"{x2d.device}, got {tuple(t.shape)} on {t.device}")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    moments = torch.empty((2, Co), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        buf, (mul, add, psum, pssq) = _partials(lib, x2d, Co, 2)
        err = lib.conv1x1_bn_act_run(
            x2d.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), moments.data_ptr(), moments.data_ptr() + 4 * Co, mul, add,
            psum, pssq, M, Ci, Co, int(x2d.dtype == torch.bfloat16), int(act == "swish"),
            # PyTorch divides a CUDA tensor by a scalar as a product with
            # the scalar's f32 reciprocal; the fold does the same
            float(np.float32(1.0) / np.float32(M)), float(eps),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1x1 two-pass launch failed: CUDA error {err}")
    LAUNCH_COUNTS["conv1x1_bn_act_2pass"] += 1
    return moments[0], moments[1]


def _lib():
    lib = _build.load("conv_bn")
    if not hasattr(lib, "_typed"):
        vp, ci, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.conv1x1_row_blocks.argtypes = [ll, ci, ci, ci]
        lib.conv1x1_row_blocks.restype = ci
        lib.conv1x1_max_ci.argtypes = []
        lib.conv1x1_max_ci.restype = ci
        lib.conv1x1_bn_stats_run.argtypes = [vp] * 7 + [ll, ci, ci, ci, vp]
        lib.conv1x1_bn_stats_run.restype = ci
        lib.conv1x1_bn_act_run.argtypes = [vp] * 11 + [ll, ci, ci, ci, ci, f, f, vp]
        lib.conv1x1_bn_act_run.restype = ci
        lib.max_ci = lib.conv1x1_max_ci()
        lib._typed = True
    return lib
