"""Weak-view warp: random affine (Paeth three-shear form) + flip + normalize.

Port of ``fedmlp_tpu/ops/pallas_warp.py``. A rotation θ and a
translation (tx, ty) about the image center factor into three axis-aligned
shears, each a per-row fractional shift

    shift(i) = slope · (i − center) + offset

applied as a two-tap lerp with zero fill (horizontal, vertical, horizontal).
``fused_warp_normalize`` runs all three passes and the normalization in one
CUDA kernel (``csrc/fused_warp.cu``) on a CUDA tensor, and its plain PyTorch
version ``fused_warp_normalize_ref`` on a CPU tensor.

``hshift_rows`` is one such pass on its own (``csrc/hshift.cu``, plain version
``hshift_rows_ref``), for arbitrary per-row shift vectors: ``paeth_affine``
chains three of them (the weak 'pallas'/'paeth' backends,
``weak_augment_batch_paeth``), and the strong view's geometric ops run
through it (``ops/augment.py``). Planes are NCHW here, where the JAX package
works on one planar [C, H, W] image under ``vmap``.
"""

from __future__ import annotations

import ctypes

import torch

from fedmlp_tpu_torch.ops import _build

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"fused_warp_normalize": 0, "hshift_rows": 0}


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


def norm_constants(mean, std) -> tuple[list[float], list[float]]:
    """255·mean_c and 255·std_c, each rounded once to f32: the constants of
    the warp kernel alone, as the JAX warp kernel bakes
    ``float(mean[c]) * 255.0`` into its body (``fused_warp_normalize`` and
    its plain version)."""
    m = torch.tensor([float(v) * 255.0 for v in mean], dtype=torch.float32)
    s = torch.tensor([float(v) * 255.0 for v in std], dtype=torch.float32)
    return m.tolist(), s.tolist()


def norm_constants_f32(mean, std) -> tuple[list[float], list[float]]:
    """255·mean_c and 255·std_c as the f32 product of f32 mean and std, as
    every other normalization of the JAX package forms them
    (``augment.normalize``): for std 0.224 this is 57.120003, where
    ``norm_constants`` gives 57.12."""
    m = torch.tensor(mean, dtype=torch.float32) * 255.0
    s = torch.tensor(std, dtype=torch.float32) * 255.0
    return m.tolist(), s.tolist()


def paeth_shift_vectors(theta, tx, ty, H: int, W: int):
    """(θ, tx, ty) f32 [B] → shift vectors (s1 [B, H], s2 [B, W], s3 [B, H])
    of the three passes: ``paeth_shift_params`` evaluated at every row."""
    p = paeth_shift_params(theta, tx, ty, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=p.device)
    xs = torch.arange(W, dtype=torch.float32, device=p.device)

    def line(q, at):
        return q[..., 0:1] * (at - q[..., 2:3]) + q[..., 1:2]

    return line(p[..., 0, :], ys), line(p[..., 1, :], xs), line(p[..., 2, :], ys)


def hshift_rows_ref(x: torch.Tensor, shifts: torch.Tensor, axis: int = 3):
    """Plain PyTorch version of ``hshift_rows``, same arguments. For axis 3:
    out[b, c, y, x] = (1 − w)·x[b, c, y, x + k] + w·x[b, c, y, x + k + 1],
    s = shifts[b, y], k = ⌊s⌋, w = s − k, zero outside; an integer shift is
    an exact copy, a shift beyond the plane gives zeros."""
    if axis == 2:
        return hshift_rows_ref(x.transpose(2, 3), shifts, 3).transpose(2, 3)
    B, C, H, W = x.shape
    kf = torch.floor(shifts)
    w = (shifts - kf)[:, None, :, None]
    k = kf.clamp(-(W + 1), W + 1).long()
    xs = torch.arange(W, device=x.device)
    lo_idx = k[:, :, None] + xs[None, None, :]  # [B, H, W]

    def tap(idx):
        inside = (idx >= 0) & (idx < W)
        g = torch.gather(x, 3, idx.clamp(0, W - 1)[:, None].expand(B, C, H, W))
        return torch.where(inside[:, None], g, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))

    return (1.0 - w) * tap(lo_idx) + w * tap(lo_idx + 1)


def _check_hshift(x, shifts, axis):
    if axis not in (2, 3):
        raise ValueError(f"hshift_rows: axis must be 2 or 3, got {axis}")
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"hshift_rows: x must be f32 [B, C, H, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    want = (x.shape[0], x.shape[2] if axis == 3 else x.shape[3])
    if shifts.dtype != torch.float32 or tuple(shifts.shape) != want:
        raise ValueError(f"hshift_rows: shifts must be f32 {list(want)} for axis "
                         f"{axis}, got {shifts.dtype} {tuple(shifts.shape)}")
    if shifts.device != x.device:
        raise ValueError(f"hshift_rows: inputs on different devices: {x.device}, "
                         f"{shifts.device}")


def hshift_rows(x: torch.Tensor, shifts: torch.Tensor, axis: int = 3):
    """One shear pass: x f32 [B, C, H, W] shifted along ``axis`` by a
    fractional amount per line, two-tap lerp, zero fill. ``axis=3`` shifts
    row y of image b by ``shifts[b, y]`` (shifts [B, H]); ``axis=2`` shifts
    column x by ``shifts[b, x]`` (shifts [B, W]), the vertical pass that the
    JAX package runs on a transposed copy. A positive shift samples the
    source at x + s. A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/hshift.cu`` (or raises)."""
    _check_hshift(x, shifts, axis)
    if x.device.type == "cpu":
        return hshift_rows_ref(x, shifts, axis)
    if x.device.type != "cuda":
        raise ValueError(f"hshift_rows: unsupported device {x.device}")
    for name, t in (("x", x), ("shifts", shifts)):
        if not t.is_contiguous():
            raise ValueError(f"hshift_rows: {name} must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _hshift_lib()
    B, C, H, W = x.shape
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.hshift_rows_f32(x.data_ptr(), shifts.data_ptr(), out.data_ptr(),
                                  B, C, H, W, 1 if axis == 3 else 0,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hshift_rows launch failed: CUDA error {err}")
    LAUNCH_COUNTS["hshift_rows"] += 1
    return out


def _hshift_lib():
    lib = _build.load("hshift")
    if not hasattr(lib, "_typed"):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hshift_rows_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.hshift_rows_f32.restype = ci
        lib._typed = True
    return lib


def paeth_affine(x: torch.Tensor, theta, tx, ty) -> torch.Tensor:
    """Warp planar images [B, C, H, W] f32 by the inverse affine map
    (rotation θ [B] about the center + translation) as three shear passes
    of ``hshift_rows``: horizontal, vertical, horizontal."""
    H, W = x.shape[2], x.shape[3]
    s1, s2, s3 = paeth_shift_vectors(theta, tx, ty, H, W)
    x = hshift_rows(x, s1.contiguous(), 3)
    x = hshift_rows(x, s2.contiguous(), 2)
    return hshift_rows(x, s3.contiguous(), 3)


def _shift_rows(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """``hshift_rows_ref`` with the shifts in closed form: params [B, 3]
    (slope, offset, center), s(y) = slope·(y − center) + offset."""
    ys = torch.arange(x.shape[2], dtype=torch.float32, device=x.device)
    s = params[:, 0:1] * (ys[None, :] - params[:, 2:3]) + params[:, 1:2]
    return hshift_rows_ref(x, s)


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
    return _normalize_planar_by(x, *norm_constants(mean, std))


# Output rows a block of ``csrc/fused_warp.cu`` computes (its kTileRows).
WARP_TILE_ROWS = 8


def warp_source_band(params: torch.Tensor, S: int, r0: int, r1: int):
    """Source rows that output rows [r0, r1) of ``fused_warp_normalize_ref``
    read, as the kernel stages them: (lo [B], hi [B]), rows lo..hi of the
    (flipped) u8 image, empty where lo > hi. Pass 3 shifts along x only;
    pass 2 at column j reads pass-1 rows y + k2(j) and y + k2(j) + 1, where
    k2 = ⌊slope·(j − center) + offset⌋ (each step rounded, clamped as in
    ``hshift_rows_ref``) is monotone in j, so its extremes lie at j = 0 and
    j = S − 1; pass 1 reads only its own row. (The kernel stages the rows
    of that range outside the plane too, as zeros.)"""
    p = params[:, 1].to(torch.float32)
    ends = torch.tensor([0.0, S - 1.0], dtype=torch.float32, device=p.device)
    s = p[:, 0:1] * (ends[None, :] - p[:, 2:3]) + p[:, 1:2]
    k = torch.floor(s).clamp(-(S + 1), S + 1).long()
    lo = (r0 + k.min(1).values).clamp(min=0)
    hi = (r1 + k.max(1).values).clamp(max=S - 1)
    return lo, hi


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
    plain version; a CUDA batch launches ``csrc/fused_warp.cu`` (or raises),
    whose blocks of ``WARP_TILE_ROWS`` output rows stage the rows
    ``warp_source_band`` names."""
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
    m, s = norm_constants(mean, std)
    with torch.cuda.device(images_u8.device):  # the launch goes to the current device
        err = lib.fused_warp_normalize_u8(
            images_u8.data_ptr(), params.data_ptr(), flip_u8.data_ptr(),
            out.data_ptr(), B, S, *m, *s, torch.cuda.current_stream().cuda_stream)
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
    return weak_augment_batch_fused_from_params(images_u8, ang, tx, ty, flip,
                                                mean, std)


def weak_augment_batch_fused_from_params(images_u8, ang, tx, ty, flip, mean, std):
    """``weak_augment_batch_fused`` on given draws (θ in degrees, tx, ty,
    flip, each [B]): one ``fused_warp_normalize`` launch."""
    H, W = images_u8.shape[1], images_u8.shape[2]
    ang = torch.where(flip, -ang, ang)
    tx = torch.where(flip, -tx, tx)
    params = paeth_shift_params(torch.deg2rad(ang), tx, ty, H, W).contiguous()
    return fused_warp_normalize(images_u8.contiguous(), params,
                                flip.contiguous(), mean, std)


def planar_f32(images_u8: torch.Tensor) -> torch.Tensor:
    """u8 NHWC → contiguous f32 NCHW in 0..255."""
    return images_u8.permute(0, 3, 1, 2).to(torch.float32).contiguous()


def normalize_planar(x: torch.Tensor, mean, std) -> torch.Tensor:
    """ToTensor + Normalize of f32 NCHW in 0..255: (x − 255·mean)/(255·std),
    with the constants of ``norm_constants_f32``."""
    return _normalize_planar_by(x, *norm_constants_f32(mean, std))


def _normalize_planar_by(x: torch.Tensor, m, s) -> torch.Tensor:
    m = torch.tensor(m, dtype=torch.float32, device=x.device)[None, :, None, None]
    s = torch.tensor(s, dtype=torch.float32, device=x.device)[None, :, None, None]
    return (x - m) / s


def weak_augment_batch_paeth_from_params(images_u8, ang, tx, ty, flip, mean, std):
    """``weak_augment_batch_paeth`` on given draws (θ in degrees, tx, ty,
    flip, each [B]): three ``hshift_rows`` passes over the f32 planes, then
    the flip, then the normalization."""
    warped = paeth_affine(planar_f32(images_u8), torch.deg2rad(ang), tx, ty)
    warped = torch.where(flip[:, None, None, None], warped.flip(-1), warped)
    return normalize_planar(warped, mean, std)


def weak_augment_batch_paeth(images_u8, generator: torch.Generator, mean, std,
                             degrees: float = 10.0, translate: float = 0.02):
    """The weak 'pallas' and 'paeth' backends: the weak view of
    ``weak_augment_batch_fused`` as three separate shear passes (the JAX
    package's v1 pipeline). Both names launch ``hshift_rows`` on a CUDA
    batch and take its plain version on a CPU batch."""
    B, H, W, _ = images_u8.shape
    ang, tx, ty, flip = weak_params(B, H, W, generator, images_u8.device,
                                    degrees, translate)
    return weak_augment_batch_paeth_from_params(images_u8, ang, tx, ty, flip,
                                                mean, std)
