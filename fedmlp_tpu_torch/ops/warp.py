"""Weak-view warp: random affine (Paeth three-shear form) + flip + normalize.

Port of ``fedmlp_tpu/ops/pallas_warp.py``'s fused path. A rotation θ and a
translation (tx, ty) about the image center factor into three axis-aligned
shears, each a per-row fractional shift

    shift(i) = slope · (i − center) + offset

applied as a two-tap lerp with zero fill (horizontal, vertical, horizontal).
``fused_warp_normalize`` runs all three passes and the normalization in one
CUDA kernel (``csrc/fused_warp.cu``) on a CUDA tensor, and its plain PyTorch
version ``fused_warp_normalize_ref`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from fedmlp_tpu_torch.ops import _build

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"fused_warp_normalize": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def paeth_shift_params(theta, tx, ty, H: int, W: int) -> torch.Tensor:
    """(θ, tx, ty) f32 [...] → per-pass shear params [..., 3, 3], rows of
    (slope, offset, center) for the horizontal, vertical and horizontal
    passes; their composition is the inverse affine map of
    ``fedmlp_tpu.ops.augment`` (rotation θ about the center, then
    translation)."""
    cx = (W - 1) / 2.0
    cy = (H - 1) / 2.0
    sin, cos = torch.sin(theta), torch.cos(theta)
    alpha = -torch.tan(theta / 2.0)
    beta = sin
    C = cx - cos * cx + sin * cy + (cos * -tx + (-sin) * -ty)
    F = cy - sin * cx - cos * cy + (sin * -tx + cos * -ty)
    tau = (C - alpha * F) / 2.0 + alpha * cy
    t2 = F + alpha * beta * cy + beta * cx - beta * tau
    cyt = torch.full_like(alpha, cy)
    cxt = torch.full_like(alpha, cx)
    return torch.stack([
        torch.stack([alpha, tau, cyt], -1),
        torch.stack([beta, t2, cxt], -1),
        torch.stack([alpha, tau, cyt], -1),
    ], -2)


def _norm_constants(mean, std) -> tuple[list[float], list[float]]:
    """255·mean_c and 255·std_c, each rounded once to f32."""
    m = torch.tensor([float(v) * 255.0 for v in mean], dtype=torch.float32)
    s = torch.tensor([float(v) * 255.0 for v in std], dtype=torch.float32)
    return m.tolist(), s.tolist()


def _shift_rows(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """x f32 [B, C, H, W], params [B, 3] (slope, offset, center) →
    out[b, c, y, x] = (1 − w)·x[b, c, y, x + k] + w·x[b, c, y, x + k + 1],
    s = slope·(y − center) + offset, k = ⌊s⌋, w = s − k, zero outside."""
    B, C, H, W = x.shape
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    s = params[:, 0:1] * (ys[None, :] - params[:, 2:3]) + params[:, 1:2]
    k = torch.floor(s)
    w = (s - k)[:, None, :, None]
    xs = torch.arange(W, device=x.device)
    lo_idx = k.long()[:, :, None] + xs[None, None, :]  # [B, H, W]

    def tap(idx):
        inside = (idx >= 0) & (idx < W)
        g = torch.gather(x, 3, idx.clamp(0, W - 1)[:, None].expand(B, C, H, W))
        return torch.where(inside[:, None], g, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))

    return (1.0 - w) * tap(lo_idx) + w * tap(lo_idx + 1)


def fused_warp_normalize_ref(images_u8, params, flip, mean, std):
    """Plain PyTorch version of the kernel, same arguments: u8 NHWC
    [B, S, S, 3], f32 params [B, 3, 3], flip [B] (bool or u8) →
    normalized f32 NCHW [B, 3, S, S]."""
    x = images_u8.permute(0, 3, 1, 2).to(torch.float32)
    flip = flip.to(torch.bool)[:, None, None, None]
    x = torch.where(flip, x.flip(-1), x)
    params = params.to(torch.float32)
    x = _shift_rows(x, params[:, 0])
    x = _shift_rows(x.transpose(2, 3), params[:, 1]).transpose(2, 3)
    x = _shift_rows(x, params[:, 2])
    m, s = _norm_constants(mean, std)
    m = torch.tensor(m, dtype=torch.float32, device=x.device)[None, :, None, None]
    s = torch.tensor(s, dtype=torch.float32, device=x.device)[None, :, None, None]
    return (x - m) / s


def _check(images_u8, params, flip):
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[3] != 3:
        raise ValueError(f"images must be u8 [B, S, S, 3], got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")
    B, S, S2, _ = images_u8.shape
    if S != S2:
        raise ValueError(f"images must be square, got {S}x{S2}")
    if params.dtype != torch.float32 or tuple(params.shape) != (B, 3, 3):
        raise ValueError(f"params must be f32 [{B}, 3, 3], got {params.dtype} "
                         f"{tuple(params.shape)}")
    if flip.dtype not in (torch.uint8, torch.bool) or tuple(flip.shape) != (B,):
        raise ValueError(f"flip must be bool/u8 [{B}], got {flip.dtype} "
                         f"{tuple(flip.shape)}")
    devices = {images_u8.device, params.device, flip.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def fused_warp_normalize(images_u8, params, flip, mean, std):
    """Three-shear warp + normalize of a batch: u8 NHWC [B, S, S, 3], f32
    params [B, 3, 3], flip [B] → f32 NCHW [B, 3, S, S]. A CPU batch takes the
    plain version; a CUDA batch launches ``csrc/fused_warp.cu`` (or raises)."""
    _check(images_u8, params, flip)
    if images_u8.device.type == "cpu":
        return fused_warp_normalize_ref(images_u8, params, flip, mean, std)
    if images_u8.device.type != "cuda":
        raise ValueError(f"fused_warp_normalize: unsupported device {images_u8.device}")
    for name, t in (("images", images_u8), ("params", params), ("flip", flip)):
        if not t.is_contiguous():
            raise ValueError(f"fused_warp_normalize: {name} must be contiguous")
    lib = _warp_lib()
    B, S = images_u8.shape[0], images_u8.shape[1]
    if S > lib.fused_warp_max_side():
        raise ValueError(f"image side {S} exceeds the kernel's shared-memory "
                         f"limit {lib.fused_warp_max_side()}")
    out = torch.empty((B, 3, S, S), dtype=torch.float32, device=images_u8.device)
    if B == 0:
        return out
    flip_u8 = flip.view(torch.uint8) if flip.dtype == torch.bool else flip
    m, s = _norm_constants(mean, std)
    stream = torch.cuda.current_stream(images_u8.device).cuda_stream
    err = lib.fused_warp_normalize_u8(
        images_u8.data_ptr(), params.data_ptr(), flip_u8.data_ptr(),
        out.data_ptr(), B, S, *m, *s, stream)
    if err != 0:
        raise RuntimeError(f"fused_warp_normalize launch failed: CUDA error {err}")
    LAUNCH_COUNTS["fused_warp_normalize"] += 1
    return out


def _warp_lib():
    lib = _build.load("fused_warp")
    if not hasattr(lib, "_typed"):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_warp_normalize_u8.argtypes = [vp, vp, vp, vp, ci, ci,
                                                cf, cf, cf, cf, cf, cf, vp]
        lib.fused_warp_normalize_u8.restype = ci
        lib.fused_warp_max_side.argtypes = []
        lib.fused_warp_max_side.restype = ci
        lib._typed = True
    return lib


def weak_params(B: int, H: int, W: int, generator: torch.Generator,
                device, degrees: float = 10.0, translate: float = 0.02):
    """Per-image weak-view draws: θ ~ U(−deg, deg), tx ~ U(−t, t)·W,
    ty ~ U(−t, t)·H, flip ~ Bernoulli(½). Returns (θ degrees, tx, ty, flip)."""
    u = torch.rand((4, B), generator=generator, device=device, dtype=torch.float32)
    ang = u[0] * (2.0 * degrees) - degrees
    tx = (u[1] * (2.0 * translate) - translate) * W
    ty = (u[2] * (2.0 * translate) - translate) * H
    flip = u[3] < 0.5
    return ang, tx, ty, flip


def weak_augment_batch_fused(images_u8, generator: torch.Generator, mean, std,
                             degrees: float = 10.0, translate: float = 0.02):
    """Weak view of a u8 NHWC batch → normalized f32 NCHW: RandomAffine
    (±deg, ±translate) + horizontal flip + normalize. The flip is folded
    into the params (flip∘affine(θ, tx, ty) ≡ affine(−θ, −tx, ty)∘flip) and
    applied by the kernel while it reads the u8 source."""
    B, H, W, _ = images_u8.shape
    ang, tx, ty, flip = weak_params(B, H, W, generator, images_u8.device,
                                    degrees, translate)
    ang = torch.where(flip, -ang, ang)
    tx = torch.where(flip, -tx, tx)
    params = paeth_shift_params(torch.deg2rad(ang), tx, ty, H, W).contiguous()
    return fused_warp_normalize(images_u8.contiguous(), params,
                                flip.contiguous(), mean, std)

