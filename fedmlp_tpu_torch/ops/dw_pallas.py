"""Depthwise-convolution backward kernels (port of
``fedmlp_tpu/ops/dw_pallas.py``), NCHW.

``dw_conv_pallas(x, w, stride, pads)`` is a depthwise convolution whose
forward is the framework's grouped convolution on the TF-SAME padded input
and whose backward runs two hand-written CUDA kernels
(``csrc/dw_conv.cu``):

* ``dw_conv_s1``   — stride-1 depthwise correlation; computes dx from the
  zero-dilated cotangent and the spatially flipped filter;
* ``dw_wgrad_s1``  — the weight gradient, x and dy each read once, summed
  in a fixed order (no atomics: equal inputs give equal bits).

Each wrapper takes its plain PyTorch version (``*_ref``: k² shifted
multiplies over the padded tensor, accumulated in float32) for a CPU tensor
and launches its kernel for a CUDA tensor, or raises; there is no fallback.

Layout: x, dy ``[B, C, H, W]`` contiguous, the filter as the grouped
``nn.Conv2d``'s weight ``[C, 1, k, k]``; ``pads`` is
``((top, bottom), (left, right))``. Types: float32 or bfloat16 inputs,
float32 accumulation, dx in x's type, dw float32 (the autograd function
casts it to the filter's type, as the JAX VJP does).

A strided convolution's cotangent is zero-embedded at input resolution by a
plain tensor op (``dilate_to_input``) and goes through the stride-1 kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fedmlp_tpu_torch.ops import _build

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"dw_conv_s1": 0, "dw_wgrad_s1": 0}

_KERNEL_SIZES = (3, 5)  # the filters the CUDA kernels are instantiated for
_THREADS = 256
_TILE_PIXELS = 3136     # output pixels a block works on (28 rows of 112)
_WGRAD_BLOCKS = 1056    # blocks dw_wgrad_s1 aims for: 8 on each of 132 SMs
_MAX_GROUP = 8


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# Plain versions: the arithmetic of the JAX package's ``depthwise_taps``
# ----------------------------------------------------------------------

def _padded_f32(x: torch.Tensor, k: int, pt: int, pl: int) -> torch.Tensor:
    """x as float32 with pt zero rows above, pl zero columns left and the
    rest of k−1 below and right."""
    return F.pad(x.float(), (pl, k - 1 - pl, pt, k - 1 - pt))


def dw_conv_s1_ref(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """Plain version of ``dw_conv_s1``: out[b,c,y,x] = Σ_{ky,kx}
    x_pad[b,c,y+ky,x+kx]·w[c,0,ky,kx], summed in float32 in tap order,
    returned in x's type."""
    k = w.shape[-1]
    (pt, _), (pl, _) = pads
    H, W = x.shape[2], x.shape[3]
    xp = _padded_f32(x, k, pt, pl)
    wf = w.float()
    out = None
    for ky in range(k):
        for kx in range(k):
            term = xp[:, :, ky:ky + H, kx:kx + W] * wf[None, :, 0, ky, kx, None, None]
            out = term if out is None else out + term
    return out.to(x.dtype)


def dw_wgrad_s1_ref(x: torch.Tensor, dy: torch.Tensor, k: int, pads) -> torch.Tensor:
    """Plain version of ``dw_wgrad_s1``: dw[c,0,ky,kx] = Σ_b Σ_{y,x}
    x_pad[b,c,y+ky,x+kx]·dy[b,c,y,x] in float32 → [C, 1, k, k]."""
    (pt, _), (pl, _) = pads
    H, W = x.shape[2], x.shape[3]
    xp = _padded_f32(x, k, pt, pl)
    g = dy.float()
    taps = [(xp[:, :, ky:ky + H, kx:kx + W] * g).sum(dim=(0, 2, 3))
            for ky in range(k) for kx in range(k)]
    return torch.stack(taps, dim=1).reshape(x.shape[1], 1, k, k)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check_planes(name: str, x: torch.Tensor, other: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if other.dtype != x.dtype or other.device != x.device:
        raise ValueError(f"{name}: {what} must match x's type and device, got "
                         f"{other.dtype} on {other.device} vs {x.dtype} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_pads(name: str, k: int, pads, exact: bool) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0 or pt > k - 1 or pl > k - 1:
        raise ValueError(f"{name}: pads {pads} out of range for k={k}")
    if exact and (pt + pb != k - 1 or pl + pr != k - 1):
        raise ValueError(f"{name}: pads {pads} must sum to k-1={k - 1} per axis")
    return pt, pl


def _check_cuda(name: str, k: int, **tensors) -> None:
    if k not in _KERNEL_SIZES:
        raise ValueError(f"{name}: the CUDA kernel takes k in {_KERNEL_SIZES}, got {k}")
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def tile_rows(H: int, W: int) -> int:
    """Rows of a plane that one block stages and works on."""
    return max(1, min(H, -(-_TILE_PIXELS // W)))


def wgrad_plan(B: int, C: int, H: int, W: int) -> tuple[int, int, int]:
    """(tile rows, tiles staged together, blocks a channel) of
    ``dw_wgrad_s1``. Small planes (a tile is the whole plane) are staged
    several at a time so that every thread has a pixel; the (image, tile)
    items of a channel are split over enough blocks to fill the card."""
    th = tile_rows(H, W)
    n_tiles = -(-H // th)
    group = 1
    if n_tiles == 1:
        group = max(1, min(_MAX_GROUP, B, (2 * _THREADS) // (H * W)))
    n_groups = -(-(B * n_tiles) // group)
    splits = max(1, min(n_groups, -(-_WGRAD_BLOCKS // C)))
    return th, group, splits


def _smem_bytes(th: int, W: int, k: int, group: int = 1) -> int:
    return group * (th + k - 1) * (W + k - 1) * 4


def dw_conv_s1(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """Stride-1 depthwise correlation: x [B,C,H,W], w [C,1,k,k] of x's type,
    pads summing to k−1 per axis (any split) → [B,C,H,W] in x's type. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    name = "dw_conv_s1"
    _check_planes(name, x, w, "w")
    B, C, H, W = x.shape
    if w.dim() != 4 or w.shape[0] != C or w.shape[1] != 1 or w.shape[2] != w.shape[3]:
        raise ValueError(f"{name}: w must be [{C}, 1, k, k], got {tuple(w.shape)}")
    k = w.shape[-1]
    pt, pl = _check_pads(name, k, pads, exact=True)
    if x.device.type == "cpu":
        return dw_conv_s1_ref(x, w, pads)
    _check_cuda(name, k, x=x, w=w)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    th = tile_rows(H, W)
    if _smem_bytes(th, W, k) > 48 * 1024:
        raise ValueError(f"{name}: a row of width {W} does not fit a block's "
                         "shared memory")
    threads = min(_THREADS, -(-(th * W) // 32) * 32)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _dw_lib().dw_conv_s1(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, C, H, W, k, pt, pl, th,
            threads, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCH_COUNTS[name] += 1
    return out


def dw_wgrad_s1(x: torch.Tensor, dy: torch.Tensor, k: int, pads) -> torch.Tensor:
    """Weight gradient of the stride-1 depthwise correlation: x, dy
    [B,C,H,W] of one type (dy possibly the zero-dilated embedding of a
    strided cotangent) → float32 [C,1,k,k]. Only the top and left pads
    place x; the padded x is zero wherever a window leaves the plane. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    name = "dw_wgrad_s1"
    _check_planes(name, x, dy, "dy")
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    pt, pl = _check_pads(name, k, pads, exact=False)
    if x.device.type == "cpu":
        return dw_wgrad_s1_ref(x, dy, k, pads)
    _check_cuda(name, k, x=x, dy=dy)
    B, C, H, W = x.shape
    if x.numel() == 0:
        return torch.zeros((C, 1, k, k), dtype=torch.float32, device=x.device)
    out = torch.empty((C, 1, k, k), dtype=torch.float32, device=x.device)
    th, group, splits = wgrad_plan(B, C, H, W)
    if _smem_bytes(th, W, k, group) > 40 * 1024:
        raise ValueError(f"{name}: a row of width {W} does not fit a block's "
                         "shared memory")
    partial = torch.empty((splits, C, k * k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _dw_lib().dw_wgrad_s1(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(), B, C,
            H, W, k, pt, pl, th, group, splits, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCH_COUNTS[name] += 1
    return out


def _dw_lib():
    lib = _build.load("dw_conv")
    if not hasattr(lib, "_typed"):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dw_conv_s1.argtypes = [vp, vp, vp] + [ci] * 10 + [vp]
        lib.dw_conv_s1.restype = ci
        lib.dw_wgrad_s1.argtypes = [vp, vp, vp, vp] + [ci] * 11 + [vp]
        lib.dw_wgrad_s1.restype = ci
        lib._typed = True
    return lib


# ----------------------------------------------------------------------
# The custom VJP
# ----------------------------------------------------------------------

def dilate_to_input(dy: torch.Tensor, stride: int, H: int, W: int) -> torch.Tensor:
    """Zero-embed a strided cotangent [B,C,Ho,Wo] at input resolution
    [B,C,H,W]: data at rows/columns stride·i, zeros elsewhere."""
    if stride == 1:
        return dy
    B, C, Ho, Wo = dy.shape
    span_h, span_w = (Ho - 1) * stride + 1, (Wo - 1) * stride + 1
    if span_h > H or span_w > W:
        raise ValueError(f"cotangent {tuple(dy.shape)} at stride {stride} does "
                         f"not fit the input {H}x{W}")
    out = dy.new_zeros((B, C, H, W))
    out[:, :, :span_h:stride, :span_w:stride] = dy
    return out


class _DwConvPallas(torch.autograd.Function):
    """Forward: grouped ``conv2d`` on the padded input. Backward: dx =
    ``dw_conv_s1`` of the dilated cotangent with the flipped filter under
    pads ((k−1−pt, pt), (k−1−pl, pl)); dw = ``dw_wgrad_s1``, cast to the
    filter's type. The caller hands in x and w already in the compute type,
    and the backward runs with autocast off, so under ``torch.autocast``
    the function behaves as ``F.conv2d`` does."""

    @staticmethod
    def forward(ctx, x, w, stride, pads):
        (pt, pb), (pl, pr) = pads
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads = stride, pads
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, None, stride, 0, 1,
                        x.shape[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        (pt, _), (pl, _) = ctx.pads
        k = w.shape[-1]
        H, W = x.shape[2], x.shape[3]
        with torch.autocast(x.device.type, enabled=False):
            dy_e = dilate_to_input(dy.to(x.dtype).contiguous(), ctx.stride, H, W)
            dx = dw = None
            if ctx.needs_input_grad[0]:
                wf = w.detach().flip(2, 3).contiguous()
                dx = dw_conv_s1(dy_e, wf, ((k - 1 - pt, pt), (k - 1 - pl, pl)))
            if ctx.needs_input_grad[1]:
                dw = dw_wgrad_s1(x, dy_e, k, ctx.pads).to(w.dtype)
        return dx, dw, None, None


def dw_conv_pallas(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """Depthwise convolution of x [B,C,H,W] with w [C,1,k,k] (one type) at
    ``stride`` under ``pads``, differentiated by the two kernels above."""
    if w.dtype != x.dtype:
        raise ValueError(f"dw_conv_pallas: x is {x.dtype}, w is {w.dtype}; cast "
                         "both to the compute type first")
    return _DwConvPallas.apply(x, w, stride, pads)
