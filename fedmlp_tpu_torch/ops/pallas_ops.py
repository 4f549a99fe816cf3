"""Preprocessing and loss kernels (port of ``fedmlp_tpu/ops/pallas_ops.py``,
whose name this module keeps).

* ``normalize_flip_cutout`` — uint8 → float32 ToTensor+Normalize with a
  per-image horizontal flip and a cutout box filled with gray 127 before the
  normalization, one read and one write a pixel (``csrc/preproc.cu``).
* ``bce_with_logits_masked_sum`` — Σ mask·BCE-with-logits(pos_weight) over
  [B, C] as one reduction (``csrc/bce.cu``), a ``torch.autograd.Function``
  whose backward is the closed-form gradient for the logits,
  ``bce_with_logits_masked_grad`` (a kernel of the same source): one launch
  each way.

Each wrapper takes its plain PyTorch version (``*_ref``) for CPU tensors and
launches its kernel for CUDA tensors, or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fedmlp_tpu_torch.ops import _build
from fedmlp_tpu_torch.ops.warp import norm_constants_f32

FILL_GRAY = 127.0  # CutoutAbs fill (utils/FixMatch.py:57)

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"normalize_flip_cutout": 0, "bce_with_logits_masked_sum": 0,
                 "bce_with_logits_masked_grad": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# normalize + hflip + cutout
# ----------------------------------------------------------------------

def normalize_flip_cutout_ref(images_u8, flips, boxes, mean, std):
    """Plain PyTorch version of ``normalize_flip_cutout``, same arguments."""
    x = images_u8.to(torch.float32)
    B, H, W, _ = x.shape
    if flips is not None:
        x = torch.where(flips[:, None, None, None] > 0, x.flip(2), x)
    if boxes is not None:
        ys = torch.arange(H, device=x.device)[None, :, None]
        xs = torch.arange(W, device=x.device)[None, None, :]
        x0, y0, x1, y1 = (boxes[:, i, None, None] for i in range(4))
        inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
        x = torch.where(inside[..., None], torch.full((), FILL_GRAY, device=x.device),
                        x)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - m) / s


def _check_preproc(images_u8, flips, boxes):
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[3] != 3:
        raise ValueError(f"normalize_flip_cutout: images must be u8 [B, H, W, 3], got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    B = images_u8.shape[0]
    for name, t, shape in (("flips", flips, (B,)), ("boxes", boxes, (B, 4))):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"normalize_flip_cutout: {name} must be i32 {list(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != images_u8.device:
            raise ValueError(f"normalize_flip_cutout: {name} on {t.device}, images on "
                             f"{images_u8.device}")


def normalize_flip_cutout_plan(images_u8, out, mean, std):
    """Launch plan of ``csrc/preproc.cu`` for a batch and its output buffer:
    (vec4, means, stds). ``vec4``: four pixels a thread, which needs W % 4
    == 0 and both base pointers 16-byte aligned (any other batch runs one
    pixel a thread); the constants are the f32 products 255·mean_c and
    255·std_c of the plain version (``norm_constants_f32``), from which the
    kernel builds its gray-level table."""
    W = images_u8.shape[2]
    vec4 = W % 4 == 0 and images_u8.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    m, s = norm_constants_f32(mean, std)
    return vec4, m, s


def normalize_flip_cutout(images_u8, flips, boxes, mean, std):
    """images u8 [B, H, W, 3]; flips i32 [B] (> 0: mirror horizontally);
    boxes i32 [B, 4] rows of (x0, y0, x1, y1) in output coordinates, filled
    with 127 before normalizing (a zero box disables the cutout) → f32
    [B, H, W, 3], ((x/255) − mean)/std. ``flips`` or ``boxes`` may be None:
    no flip, no box. A CPU batch takes the plain version; a CUDA batch
    launches ``csrc/preproc.cu`` (or raises), equal to the plain version's
    bits."""
    _check_preproc(images_u8, flips, boxes)
    if images_u8.device.type == "cpu":
        return normalize_flip_cutout_ref(images_u8, flips, boxes, mean, std)
    if images_u8.device.type != "cuda":
        raise ValueError(f"normalize_flip_cutout: unsupported device {images_u8.device}")
    for name, t in (("images", images_u8), ("flips", flips), ("boxes", boxes)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"normalize_flip_cutout: {name} must be contiguous")
    B, H, W, _ = images_u8.shape
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=images_u8.device)
    if out.numel() == 0:
        return out
    if B * H * W >= 2**31:
        raise ValueError(f"normalize_flip_cutout: {B * H * W} pixels exceed the "
                         "kernel's 32-bit index")
    lib = _preproc_lib()
    vec4, m, s = normalize_flip_cutout_plan(images_u8, out, mean, std)
    with torch.cuda.device(images_u8.device):  # the launch goes to the current device
        err = lib.normalize_flip_cutout_u8(
            images_u8.data_ptr(), None if flips is None else flips.data_ptr(),
            None if boxes is None else boxes.data_ptr(), out.data_ptr(), B, H, W,
            *m, *s, int(vec4), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize_flip_cutout launch failed: CUDA error {err}")
    LAUNCH_COUNTS["normalize_flip_cutout"] += 1
    return out


def _preproc_lib():
    lib = _build.load("preproc")
    if not hasattr(lib, "_typed"):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.normalize_flip_cutout_u8.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                                 cf, cf, cf, cf, cf, cf, ci, vp]
        lib.normalize_flip_cutout_u8.restype = ci
        lib._typed = True
    return lib


# ----------------------------------------------------------------------
# weighted BCE-with-logits + mask reduction
# ----------------------------------------------------------------------

def _broadcast_operands(logits, labels, pos_weight, mask):
    """Check the four operands; pos_weight ([C] or [B, C]) and mask ([C],
    [B, 1] or [B, C]) come back as [B, C] views (stride 0 where broadcast)."""
    name = "bce_with_logits_masked_sum"
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"{name}: logits must be f32 [B, C], got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    if labels.shape != logits.shape:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} must match logits "
                         f"{tuple(logits.shape)}")
    out = []
    for tname, t in (("pos_weight", pos_weight), ("mask", mask)):
        try:
            out.append(t.expand(logits.shape))
        except RuntimeError as e:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} does not broadcast to "
                             f"{tuple(logits.shape)}") from e
    for tname, t in (("labels", labels), ("pos_weight", pos_weight), ("mask", mask)):
        if t.dtype != torch.float32 or t.device != logits.device:
            raise ValueError(f"{name}: {tname} must be f32 on {logits.device}, got "
                             f"{t.dtype} on {t.device}")
    return out


def bce_with_logits_masked_sum_ref(logits, labels, pos_weight, mask):
    """Plain PyTorch version of the forward: (BCE-with-logits(pos_weight) ·
    mask).sum() with the stable log σ(x) = min(x, 0) − log1p(exp(−|x|))."""
    elem = -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    return (elem * mask).sum()


def _check_kernel_operands(name, logits, labels):
    """What both BCE kernels need beyond ``_broadcast_operands``: a CUDA
    device and contiguous logits and labels."""
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {logits.device}")
    for tname, t in (("logits", logits), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _bce_forward(logits, labels, pos_weight, mask):
    pw, m = _broadcast_operands(logits, labels, pos_weight, mask)
    if logits.device.type == "cpu":
        return bce_with_logits_masked_sum_ref(logits, labels, pw, m)
    _check_kernel_operands("bce_with_logits_masked_sum", logits, labels)
    if logits.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=logits.device)
    # the kernel writes out on every path: no fill launch before it
    out = torch.empty((), dtype=torch.float32, device=logits.device)
    lib = _bce_lib()
    B, C = logits.shape
    blocks = lib.bce_masked_sum_blocks(B * C)
    partial = (torch.empty((blocks,), dtype=torch.float32, device=logits.device)
               if blocks > 1 else out)
    with torch.cuda.device(logits.device):  # the launch goes to the current device
        err = lib.bce_masked_sum_f32(
            logits.data_ptr(), labels.data_ptr(), pw.data_ptr(), m.data_ptr(),
            out.data_ptr(), partial.data_ptr(), B, C, *pw.stride(), *m.stride(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bce_with_logits_masked_sum launch failed: CUDA error {err}")
    LAUNCH_COUNTS["bce_with_logits_masked_sum"] += 1
    return out


def _bce_lib():
    lib = _build.load("bce")
    if not hasattr(lib, "_typed"):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bce_masked_sum_blocks.argtypes = [ll]
        lib.bce_masked_sum_blocks.restype = ci
        lib.bce_masked_sum_f32.argtypes = [vp, vp, vp, vp, vp, vp, ll, ci,
                                           ll, ll, ll, ll, vp]
        lib.bce_masked_sum_f32.restype = ci
        lib.bce_masked_grad_f32.argtypes = [vp, vp, vp, vp, vp, vp, ll, ci,
                                            ll, ll, ll, ll, vp]
        lib.bce_masked_grad_f32.restype = ci
        lib._typed = True
    return lib


def bce_with_logits_masked_grad_ref(g, logits, labels, pos_weight, mask):
    """Plain PyTorch version of the gradient in the logits: g · (−pw·y·(1 − p)
    + (1 − y)·p) · mask with p = σ(x), the JAX package's closed-form VJP."""
    p = torch.sigmoid(logits)
    # d/dx [−pw·y·log σ − (1 − y)·log(1 − σ)] = −pw·y·(1 − p) + (1 − y)·p
    grad = (-pos_weight * labels * (1.0 - p) + (1.0 - labels) * p) * mask
    return g * grad


def bce_with_logits_masked_grad(g, logits, labels, pos_weight, mask):
    """d/d logits of ``bce_with_logits_masked_sum`` times the cotangent ``g``
    (f32 scalar) → f32 [B, C]. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/bce.cu``'s gradient kernel (or raise), which reads
    ``g`` on the device (no host sync) and rounds in the plain version's
    order."""
    pw, m = _broadcast_operands(logits, labels, pos_weight, mask)
    if g.dim() != 0 or g.dtype != torch.float32 or g.device != logits.device:
        raise ValueError(f"bce_with_logits_masked_grad: g must be an f32 scalar on "
                         f"{logits.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    if logits.device.type == "cpu":
        return bce_with_logits_masked_grad_ref(g, logits, labels, pw, m)
    _check_kernel_operands("bce_with_logits_masked_grad", logits, labels)
    dx = torch.empty_like(logits)
    if logits.numel() == 0:
        return dx
    if logits.numel() >= 2**31:
        raise ValueError(f"bce_with_logits_masked_grad: {logits.numel()} elements "
                         "exceed the kernel's 32-bit index")
    lib = _bce_lib()
    B, C = logits.shape
    with torch.cuda.device(logits.device):  # the launch goes to the current device
        err = lib.bce_masked_grad_f32(
            g.data_ptr(), logits.data_ptr(), labels.data_ptr(), pw.data_ptr(),
            m.data_ptr(), dx.data_ptr(), B, C, *pw.stride(), *m.stride(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bce_with_logits_masked_grad launch failed: CUDA error {err}")
    LAUNCH_COUNTS["bce_with_logits_masked_grad"] += 1
    return dx


class _BceMaskedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, pos_weight, mask):
        ctx.save_for_backward(logits, labels, pos_weight, mask)
        return _bce_forward(logits, labels, pos_weight, mask)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        logits, labels, pos_weight, mask = ctx.saved_tensors
        return (bce_with_logits_masked_grad(g, logits, labels, pos_weight, mask),
                None, None, None)


def bce_with_logits_masked_sum(logits, labels, pos_weight, mask):
    """Σ_{b,c} mask·(−pos_weight·y·log σ(x) − (1 − y)·log σ(−x)) → f32
    scalar, without the [B, C] loss tensor. logits, labels f32 [B, C];
    pos_weight [C] or [B, C]; mask [C], [B, 1] or [B, C]. Differentiable in
    the logits only (the JAX package's closed-form VJP, as
    ``bce_with_logits_masked_grad``). CPU tensors take the plain versions;
    CUDA tensors launch ``csrc/bce.cu``, one kernel forward and one backward
    (or raise); equal inputs give equal bits."""
    return _BceMaskedSum.apply(logits, labels, pos_weight, mask)
