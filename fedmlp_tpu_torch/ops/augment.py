"""View pipelines (port of ``fedmlp_tpu/ops/augment.py``): the test
transform, the weak-view backends and the strong view.

  weak view   — RandomAffine(10°, 2% translate) + RandomHorizontalFlip +
                Normalize (reference: dataset/dataset.py:24-30)
  strong view — the weak geometric prefix + RandAugmentMC(n=2, m=10), a pool
                of 14 PIL ops, + CutoutAbs(16) (utils/FixMatch.py:147-163,
                205-220)

Views leave here as normalized float32 NCHW, the layout of the port's
convolutions, from u8 NHWC batches (the dataset's layout). In between, images
are float32 NCHW planes in [0, 255], PIL's uint8 domain, where the JAX package
maps per-image functions on [H, W, 3] over the batch: every op here takes the
batch [B, 3, H, W] and per-image parameters [B].

Random draws are apart from the arithmetic: ``weak_params`` /
``strong_params`` / ``randaugment_pc_params`` draw from a
``torch.Generator``, the ``*_from_params`` functions apply given draws (the
tests feed them the JAX package's). ``view_backend`` names both halves of a
view by backend, so that a round's draws can all be made before any is
applied (``parallel/fl_runtime.py::pre_augment_views``).

The bilinear warps take cos and sin in float64, rounded once to float32, and
sharpness smooths in float64: a view made from the same draws then has the
same bits on the CPU and on the card, where a last-place difference before a
quantizing op (posterize, equalize, a solarize threshold) could move a pixel
by whole gray levels.

The JAX package computes every branch of a RandAugment layer and selects
(``lax.switch`` under ``vmap``). So does ``randaugment_op``: all nine
photometric branches run on the whole batch and ``torch.where`` picks per
image. Reading ``op_idx`` back to run only the chosen ops would cost a device
synchronization in every local step, which is host-bound already; the
branches cost device time and launches instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedmlp_tpu_torch.ops.pallas_ops import FILL_GRAY, normalize_flip_cutout
from fedmlp_tpu_torch.ops.warp import (
    hshift_rows,
    normalize_planar,
    paeth_affine,
    paeth_shift_vectors,
    planar_f32,
    weak_augment_batch_fused_from_params,
    weak_augment_batch_paeth_from_params,
    weak_params,
)

PARAMETER_MAX = 10  # utils/FixMatch.py:17


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """[B] → [B, 1, 1, 1], to broadcast against [B, C, H, W]."""
    return v[:, None, None, None]


def eval_batch(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """Test transform (normalize only) of u8 NHWC → f32 NCHW: the
    ``normalize_flip_cutout`` kernel without flip or box (its plain version
    on the CPU), seen as NCHW."""
    out = normalize_flip_cutout(images_u8.contiguous(), None, None, mean, std)
    return out.permute(0, 3, 1, 2)


# ----------------------------------------------------------------------
# Geometry: inverse-map bilinear warp (the 'gather' path)
# ----------------------------------------------------------------------

def _bilinear_sample(img, src_x, src_y, fill: float = 0.0):
    """Sample img [B, C, H, W] at float coords (src_x, src_y) [B, H, W];
    out of bounds → fill (PIL pads black on affine/rotate)."""
    B, C, H, W = img.shape
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    dx = (src_x - x0)[:, None]
    dy = (src_y - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(B, C, H * W)
    fill_t = torch.full((), fill, dtype=img.dtype, device=img.device)

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        v = torch.gather(flat, 2, idx.reshape(B, 1, H * W).expand(B, C, H * W))
        return torch.where(inb[:, None], v.reshape(B, C, H, W), fill_t)

    top = tap(y0i, x0i) * (1 - dx) + tap(y0i, x0i + 1) * dx
    bot = tap(y0i + 1, x0i) * (1 - dx) + tap(y0i + 1, x0i + 1) * dx
    return top * (1 - dy) + bot * dy


def affine_warp(img, inv_mat, fill: float = 0.0):
    """Warp img [B, C, H, W] with the PIL AFFINE convention: ``inv_mat``
    [B, 2, 3] maps output pixel (x, y) → source (x', y')
    (utils/FixMatch.py:96 uses (1, v, 0, 0, 1, 0) for ShearX)."""
    H, W = img.shape[2], img.shape[3]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, None, :]
    m = inv_mat[:, :, :, None, None]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return _bilinear_sample(img, src_x, src_y, fill)


def _cos_sin(theta):
    """(cos θ, sin θ) f32, each computed in float64 and rounded once: the
    same bits on every device (float32 sin and cos of the CPU and of the
    card differ in the last place for some angles)."""
    t = theta.double()
    return torch.cos(t).float(), torch.sin(t).float()


def _center_affine(H: int, W: int, a, b, d, e, tx=0.0, ty=0.0):
    """Inverse 2x3 matrices [B, 2, 3] for a linear map about the image
    center plus a translation (in output coords); a, b, d, e f32 [B]."""
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    c = cx - a * cx - b * cy + (a * -tx + b * -ty) + 0.0
    f = cy - d * cx - e * cy + (d * -tx + e * -ty) + 0.0
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([d, e, f], -1)], -2)


def random_affine_from_params(img, ang, tx, ty):
    """torchvision RandomAffine as one bilinear warp: rotation ``ang``
    (degrees) about the center and translation (tx, ty), each [B]."""
    cos, sin = _cos_sin(torch.deg2rad(ang))
    return affine_warp(img, _center_affine(img.shape[2], img.shape[3],
                                           cos, -sin, sin, cos, tx, ty))


def weak_augment_batch_from_params(images_u8, ang, tx, ty, flip, mean, std):
    """``weak_augment_batch`` on given draws."""
    x = random_affine_from_params(planar_f32(images_u8), ang, tx, ty)
    x = torch.where(_per_image(flip), x.flip(-1), x)
    return normalize_planar(x, mean, std)


def weak_augment_batch(images_u8, generator: torch.Generator, mean, std,
                       degrees: float = 10.0, translate: float = 0.02):
    """The weak 'gather' backend: the weak view with one bilinear warp
    (stock tensor ops, no kernel) instead of three shear passes."""
    B, H, W, _ = images_u8.shape
    ang, tx, ty, flip = weak_params(B, H, W, generator, images_u8.device,
                                    degrees, translate)
    return weak_augment_batch_from_params(images_u8, ang, tx, ty, flip, mean, std)


# ----------------------------------------------------------------------
# Photometric ops (PIL ImageEnhance / ImageOps semantics, 0..255 domain);
# img f32 [B, 3, H, W], parameters f32 or int [B]
# ----------------------------------------------------------------------

def _gray(img):
    """PIL L-mode luma → [B, H, W]."""
    return img[:, 0] * 0.299 + img[:, 1] * 0.587 + img[:, 2] * 0.114


def brightness(img, v):
    """ImageEnhance.Brightness: blend with black."""
    return torch.clamp(img * _per_image(v), 0.0, 255.0)


def color(img, v):
    """ImageEnhance.Color: blend with grayscale."""
    g = _gray(img)[:, None]
    return torch.clamp(g + _per_image(v) * (img - g), 0.0, 255.0)


def contrast(img, v):
    """ImageEnhance.Contrast: blend with the mean of the L channel (PIL
    uses the integer-rounded mean)."""
    mean = torch.round(_gray(img).mean(dim=(1, 2)) + 0.5) - 0.5  # ~int(mean + 0.5)
    mean = _per_image(mean)
    return torch.clamp(mean + _per_image(v) * (img - mean), 0.0, 255.0)


def sharpness(img, v):
    """ImageEnhance.Sharpness: blend with the SMOOTH-filtered image (3x3
    kernel [[1,1,1],[1,5,1],[1,1,1]]/13, the 1-pixel border kept). The
    filter sums in float64 and rounds once, so that its bits do not depend
    on the device's summation order."""
    B, C, H, W = img.shape
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float64,
                          device=img.device) / 13.0
    smoothed = F.conv2d(img.reshape(B * C, 1, H, W).double(), kernel[None, None],
                        padding=1).float().reshape(B, C, H, W)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    border = (ys == 0) | (ys == H - 1) | (xs == 0) | (xs == W - 1)
    smoothed = torch.where(border, img, smoothed)
    return torch.clamp(smoothed + _per_image(v) * (img - smoothed), 0.0, 255.0)


def posterize(img, bits):
    """ImageOps.posterize: keep ``bits`` (int [B]) high bits of the u8 value."""
    shift = _per_image(8 - bits.to(torch.int32))
    x = img.to(torch.uint8).to(torch.int32)
    return ((x >> shift) << shift).to(torch.float32)


def solarize(img, threshold):
    """ImageOps.solarize: invert pixels >= threshold."""
    return torch.where(img >= _per_image(threshold), 255.0 - img, img)


def invert(img):
    return 255.0 - img


def autocontrast(img):
    """ImageOps.autocontrast(cutoff=0): per-channel min→0 max→255 stretch."""
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-6)
    out = (img - lo) * scale
    return torch.where(hi > lo, torch.clamp(out, 0, 255), img)


def equalize(img):
    """ImageOps.equalize: per-channel histogram equalization with PIL's
    step/LUT construction, in integers. The 256-bin histograms of all
    (image, channel) planes come from one ``torch.bincount`` with a
    per-plane offset (the JAX package's compare-and-reduce stands in for a
    scatter-add that is slow on a TPU; the function is the histogram)."""
    B, C, H, W = img.shape
    P = B * C
    x = torch.clamp(torch.round(img), 0, 255).to(torch.int64).reshape(P, H * W)
    offs = torch.arange(P, device=img.device)[:, None] * 256
    hist = torch.bincount((x + offs).reshape(-1), minlength=P * 256).reshape(P, 256)
    bins = torch.arange(256, device=img.device)
    # PIL: step = (total − last nonzero bin's count) // 255
    last_nz = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    last_count = torch.gather(hist, 1, last_nz)
    step = (H * W - last_count) // 255
    csum = torch.cumsum(hist, dim=1)
    # lut[i] = (step//2 + csum[i−1]) // step  (csum shifted by one)
    csum_prev = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    lut = (step // 2 + csum_prev) // torch.clamp(step, min=1)
    lut = torch.clamp(lut, 0, 255)
    out = torch.gather(lut, 1, x)
    out = torch.where(step == 0, x, out)
    return out.reshape(B, C, H, W).to(torch.float32)


def solarize_add(img, v, threshold: float = 128.0):
    """ImageOps.solarize after adding v (utils/FixMatch.py:111-120)."""
    shifted = torch.clamp(img + _per_image(v), 0.0, 255.0)
    return torch.where(shifted >= threshold, 255.0 - shifted, shifted)


def cutout_abs(img, cx, cy, size: float):
    """CutoutAbs (utils/FixMatch.py:47-60): gray square of side ~size at the
    uniform center draws cx ∈ [0, W), cy ∈ [0, H), each [B]."""
    H, W = img.shape[2], img.shape[3]
    x0 = _per_image(torch.clamp(cx - size / 2.0, min=0.0).to(torch.int32))
    y0 = _per_image(torch.clamp(cy - size / 2.0, min=0.0).to(torch.int32))
    x1 = torch.clamp(x0 + size, max=W)
    y1 = torch.clamp(y0 + size, max=H)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return torch.where(inside, torch.full((), FILL_GRAY, device=img.device), img)


# ----------------------------------------------------------------------
# RandAugmentMC (utils/FixMatch.py:205-220): n ops at p=0.5 + Cutout(16)
# ----------------------------------------------------------------------

def _rand_sign(neg, v):
    return torch.where(neg, -v, v)


def _geo_magnitudes(neg, v, translate_frac: float, H: int, W: int):
    """(θ rad, shear, px, py) of the five geometric ops, all signed by the
    ONE draw ``neg`` that an op application makes."""
    th = torch.deg2rad(_rand_sign(neg, torch.floor(v * 30 / PARAMETER_MAX)))
    sv = _rand_sign(neg, v * 0.3 / PARAMETER_MAX)
    px = _rand_sign(neg, torch.floor(v * translate_frac / PARAMETER_MAX * W))
    py = _rand_sign(neg, torch.floor(v * translate_frac / PARAMETER_MAX * H))
    return th, sv, px, py


def _geo_matrices(H: int, W: int, neg, v, translate_frac: float):
    """Inverse 2x3 matrices [B, 6, 2, 3] for the pool's five geometric ops +
    identity. Order: rotate, shear_x, shear_y, translate_x, translate_y,
    identity."""
    th, sv, px, py = _geo_magnitudes(neg, v, translate_frac, H, W)
    cos, sin = _cos_sin(th)
    one, zero = torch.ones_like(v), torch.zeros_like(v)

    def mat(a, b, c, d, e, f):
        return torch.stack([torch.stack([a, b, c], -1), torch.stack([d, e, f], -1)], -2)

    return torch.stack([
        _center_affine(H, W, cos, -sin, sin, cos),
        mat(one, sv, zero, zero, one, zero),
        mat(one, zero, zero, sv, one, zero),
        mat(one, zero, px, zero, one, zero),
        mat(one, zero, zero, zero, one, py),
        mat(one, zero, zero, zero, one, zero),
    ], 1)


def _select_slot(stacked, gi):
    """stacked [B, 6, ...] → the slot gi [B] of every image."""
    idx = gi.reshape((-1, 1) + (1,) * (stacked.dim() - 2))
    return torch.take_along_dim(stacked, idx, 1).squeeze(1)


def _geo_shear_warp(img, gi, neg, v, translate_frac: float):
    """The five pool geometric ops (+ identity) as exactly THREE shear
    passes (h, v, h) of ``hshift_rows``:

      rotate      — Paeth three-shear decomposition (paeth_shift_vectors)
      shear_x     — src_x = x + v·y → h-pass shifts v·y, rest zero
      shear_y     — src_y = y + v·x → v-pass shifts v·x, rest zero
      translate   — uniform integer shift (exact: frac = 0 ⇒ pure copy)
      identity    — all-zero shifts (exact copy)

    Every image runs the same three passes; only the selected shift vectors
    differ. The kernel is exact for any shift, so the JAX package's ±96
    margin (which keeps its PC pool on the gather path) does not apply."""
    B, _, H, W = img.shape
    th, sv, px, py = _geo_magnitudes(neg, v, translate_frac, H, W)
    zero = torch.zeros_like(th)
    p1, p2, p3 = paeth_shift_vectors(th, zero, zero, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None]
    zH = torch.zeros((B, H), dtype=torch.float32, device=img.device)
    zW = torch.zeros((B, W), dtype=torch.float32, device=img.device)
    # slot order: rotate, shear_x, shear_y, translate_x, translate_y, id
    S1 = torch.stack([p1, sv[:, None] * ys, zH, px[:, None] + zH, zH, zH], 1)
    S2 = torch.stack([p2, zW, sv[:, None] * xs, zW, py[:, None] + zW, zW], 1)
    S3 = torch.stack([p3, zH, zH, zH, zH, zH], 1)
    x = hshift_rows(img, _select_slot(S1, gi).contiguous(), 3)
    x = hshift_rows(x, _select_slot(S2, gi).contiguous(), 2)
    return hshift_rows(x, _select_slot(S3, gi).contiguous(), 3)


# op_idx → geometric slot (5 = identity): rotate=7, shear_x=9, shear_y=10,
# translate_x=12, translate_y=13; and → photometric branch (5 = identity)
_GEO_SLOT = (5, 5, 5, 5, 5, 5, 5, 0, 5, 1, 2, 5, 3, 4)
_PHO_SLOT = (0, 1, 2, 3, 4, 5, 6, 5, 7, 5, 5, 8, 5, 5)


def randaugment_op(img, op_idx, v_int, neg, geo: str = "gather"):
    """One op of fixmatch_augment_pool (utils/FixMatch.py:147-163) per
    image: ``op_idx`` int [B] in [0, 14), ``v_int`` the integer magnitude
    randint(1, m), ``neg`` bool [B] the op's one sign draw. The five
    geometric ops share one warp ('shear': three ``hshift_rows`` passes;
    'gather': one bilinear ``affine_warp``); all nine photometric branches
    run on the batch and the chosen one is selected per image."""
    H, W = img.shape[2], img.shape[3]
    v = v_int.to(torch.float32)
    gi = torch.tensor(_GEO_SLOT, device=img.device)[op_idx]
    if geo == "shear":
        geo_out = _geo_shear_warp(img, gi, neg, v, 0.3)
    else:
        geo_out = affine_warp(img, _select_slot(_geo_matrices(H, W, neg, v, 0.3), gi))

    mag = v * 0.9 / PARAMETER_MAX + 0.05
    branches = [
        autocontrast(img),                                                  # 0
        brightness(img, mag),                                               # 1
        color(img, mag),                                                    # 2
        contrast(img, mag),                                                 # 3
        equalize(img),                                                      # 4
        None,                                                               # 5 identity
        posterize(img, torch.floor(v * 4 / PARAMETER_MAX).to(torch.int32) + 4),  # 6
        sharpness(img, mag),                                                # 7
        solarize(img, 256.0 - torch.floor(v * 256 / PARAMETER_MAX)),        # 8
    ]
    pi = torch.tensor(_PHO_SLOT, device=img.device)[op_idx]
    out = torch.where(_per_image(gi != 5), geo_out, img)
    for slot, branch in enumerate(branches):
        if branch is not None:
            out = torch.where(_per_image(pi == slot), branch, out)
    return out


def randaugment_mc(img, op_idx, v_int, do, neg, cut_x, cut_y, cutout: float = 16,
                   geo: str = "gather"):
    """RandAugmentMC on a batch [B, 3, H, W] f32 0..255: layer i applies op
    ``op_idx[i]`` at magnitude ``v_int[i]`` where ``do[i]``; then
    CutoutAbs at the drawn center. Draws are [n, B]."""
    for i in range(op_idx.shape[0]):
        auged = randaugment_op(img, op_idx[i], v_int[i], neg[i], geo=geo)
        img = torch.where(_per_image(do[i]), auged, img)
    return cutout_abs(img, cut_x, cut_y, cutout)


def strong_params(B: int, H: int, W: int, generator: torch.Generator, device,
                  n: int = 2, m: int = 10, degrees: float = 10.0,
                  translate: float = 0.02) -> dict:
    """Per-image strong-view draws: the weak prefix (``ang`` degrees, ``tx``,
    ``ty``, ``flip``); per RandAugment layer [n, B] ``op_idx`` ∈ [0, 14),
    ``v_int`` ∈ [1, m) (np.random.randint(1, m) excludes m), ``do`` and the
    op's one sign ``neg``; the cutout center ``cut_x`` ∈ [0, W), ``cut_y`` ∈
    [0, H)."""
    ang, tx, ty, flip = weak_params(B, H, W, generator, device, degrees, translate)
    u = torch.rand((4 * n + 2, B), generator=generator, device=device,
                   dtype=torch.float32)
    layers = u[:4 * n].reshape(n, 4, B)
    return {
        "ang": ang, "tx": tx, "ty": ty, "flip": flip,
        "op_idx": torch.clamp((layers[:, 0] * len(_GEO_SLOT)).long(),
                              max=len(_GEO_SLOT) - 1),
        "v_int": 1 + torch.clamp((layers[:, 1] * (m - 1)).long(), max=m - 2),
        "do": layers[:, 2] < 0.5,
        "neg": layers[:, 3] < 0.5,
        "cut_x": u[4 * n] * W, "cut_y": u[4 * n + 1] * H,
    }


def strong_augment_batch_from_params(images_u8, params: dict, mean, std,
                                     geo: str = "gather"):
    """Strong view of a u8 NHWC batch on given draws → normalized f32 NCHW.
    ``geo='shear'`` runs every warp (the prefix affine and the pool's
    geometric ops) through ``hshift_rows``: 3 + 3 a layer passes;
    ``geo='gather'`` uses bilinear warps."""
    x = planar_f32(images_u8)
    if geo == "shear":
        x = paeth_affine(x, torch.deg2rad(params["ang"]), params["tx"], params["ty"])
    else:
        x = random_affine_from_params(x, params["ang"], params["tx"], params["ty"])
    x = torch.where(_per_image(params["flip"]), x.flip(-1), x)
    x = randaugment_mc(x, params["op_idx"], params["v_int"], params["do"],
                       params["neg"], params["cut_x"], params["cut_y"], geo=geo)
    return normalize_planar(x, mean, std)


def strong_augment_batch(images_u8, generator: torch.Generator, mean, std,
                         n: int = 2, m: int = 10, degrees: float = 10.0,
                         translate: float = 0.02, geo: str = "gather"):
    """Strong view: weak geometric prefix + RandAugmentMC + normalize
    (reference: dataset/dataset.py:70-77)."""
    B, H, W, _ = images_u8.shape
    params = strong_params(B, H, W, generator, images_u8.device, n, m, degrees,
                           translate)
    return strong_augment_batch_from_params(images_u8, params, mean, std, geo=geo)


# ----------------------------------------------------------------------
# RandAugmentPC (utils/FixMatch.py:187-202): n ops of my_augment_pool at a
# fixed magnitude, each where random() + U(0.2, 0.8) >= 1, + Cutout(16)
# ----------------------------------------------------------------------

# my_augment_pool (utils/FixMatch.py:166-184): 0 AutoContrast, 1 Brightness,
# 2 Color, 3 Contrast, 4 Cutout, 5 Equalize, 6 Invert, 7 Posterize, 8 Rotate,
# 9 Sharpness, 10 ShearX, 11 ShearY, 12 Solarize, 13 SolarizeAdd,
# 14 TranslateX, 15 TranslateY. op_idx → geometric slot (5 = identity) and →
# photometric branch (11 = identity)
_PC_GEO_SLOT = (5, 5, 5, 5, 5, 5, 5, 5, 0, 5, 1, 2, 5, 5, 3, 4)
_PC_PHO_SLOT = (0, 1, 2, 3, 4, 5, 6, 7, 11, 8, 11, 11, 9, 10, 11, 11)


def randaugment_pc_op(img, op_idx, neg, op_cut_x, op_cut_y, m: int = 10):
    """One op of my_augment_pool per image at the fixed magnitude ``m``:
    ``op_idx`` int [B] in [0, 16), ``neg`` bool [B] the op's one sign draw
    (it signs the geometric ops and SolarizeAdd's shift), (``op_cut_x``,
    ``op_cut_y``) [B] the center of the Cutout op's box. The PC scaling:
    blends at 1.8·m/10 + 0.1, translations of 0.45·m/10 of the side, a box
    of side ⌊0.2·m/10·min(H, W)⌋, (4m // 10) + 4 posterize bits. As in
    ``randaugment_op``, the five geometric ops share one bilinear warp and
    every photometric branch runs on the batch."""
    B, _, H, W = img.shape
    v = torch.full((B,), float(m), dtype=torch.float32, device=img.device)
    gi = torch.tensor(_PC_GEO_SLOT, device=img.device)[op_idx]
    geo_out = affine_warp(img, _select_slot(_geo_matrices(H, W, neg, v, 0.45), gi))
    mag = v * 1.8 / PARAMETER_MAX + 0.1
    box = float(torch.floor(torch.tensor(float(m)) * 0.2 / PARAMETER_MAX * min(H, W)))
    branches = [
        autocontrast(img),                                                  # 0
        brightness(img, mag),                                               # 1
        color(img, mag),                                                    # 2
        contrast(img, mag),                                                 # 3
        cutout_abs(img, op_cut_x, op_cut_y, box),                           # 4
        equalize(img),                                                      # 5
        invert(img),                                                        # 6
        posterize(img, torch.div(v * 4, PARAMETER_MAX, rounding_mode="floor")
                  .to(torch.int32) + 4),                                    # 7
        sharpness(img, mag),                                                # 8
        solarize(img, 256.0 - torch.floor(v * 256 / PARAMETER_MAX)),        # 9
        solarize_add(img, _rand_sign(neg, torch.floor(v * 110 / PARAMETER_MAX))),  # 10
    ]
    pi = torch.tensor(_PC_PHO_SLOT, device=img.device)[op_idx]
    out = torch.where(_per_image(gi != 5), geo_out, img)
    for slot, branch in enumerate(branches):
        out = torch.where(_per_image(pi == slot), branch, out)
    return out


def randaugment_pc_params(B: int, H: int, W: int, generator: torch.Generator, device,
                          n: int = 2) -> dict:
    """Per-image RandAugmentPC draws: per layer [n, B] ``op_idx`` ∈ [0, 16),
    ``do`` (U + U(0.2, 0.8) ≥ 1), the op's sign ``neg`` and the Cutout op's
    center ``op_cut_x`` ∈ [0, W), ``op_cut_y`` ∈ [0, H); the final box's
    center ``cut_x``, ``cut_y`` [B]."""
    u = torch.rand((6 * n + 2, B), generator=generator, device=device,
                   dtype=torch.float32)
    layers = u[:6 * n].reshape(n, 6, B)
    n_ops = len(_PC_GEO_SLOT)
    return {
        "op_idx": torch.clamp((layers[:, 0] * n_ops).long(), max=n_ops - 1),
        "do": layers[:, 1] + (layers[:, 2] * 0.6 + 0.2) >= 1.0,
        "neg": layers[:, 3] < 0.5,
        "op_cut_x": layers[:, 4] * W, "op_cut_y": layers[:, 5] * H,
        "cut_x": u[6 * n] * W, "cut_y": u[6 * n + 1] * H,
    }


def randaugment_pc_from_params(img, params: dict, m: int = 10, cutout: float = 16):
    """RandAugmentPC on a batch [B, 3, H, W] f32 0..255 on given draws
    (``randaugment_pc_params``'s keys): layer i applies op ``op_idx[i]``
    where ``do[i]``; then CutoutAbs at the drawn center. Calls no kernel."""
    for i in range(params["op_idx"].shape[0]):
        auged = randaugment_pc_op(img, params["op_idx"][i], params["neg"][i],
                                  params["op_cut_x"][i], params["op_cut_y"][i], m)
        img = torch.where(_per_image(params["do"][i]), auged, img)
    return cutout_abs(img, params["cut_x"], params["cut_y"], cutout)


def randaugment_pc(img, generator: torch.Generator, n: int = 2, m: int = 10,
                   cutout: float = 16):
    """RandAugmentPC(n, m) on a batch [B, 3, H, W] f32 0..255."""
    B, _, H, W = img.shape
    return randaugment_pc_from_params(
        img, randaugment_pc_params(B, H, W, generator, img.device, n), m, cutout)


# ----------------------------------------------------------------------
# Backends by name
# ----------------------------------------------------------------------

AUGMENT_BACKENDS = ("auto", "fused", "pallas", "paeth", "gather", "normonly")


def _resolve_backend(augment_backend: str) -> str:
    """'auto' is 'fused' on every device: each kernel's plain version serves
    CPU tensors. The JAX package's scale rule (weak+strong programs above a
    K·B threshold fall back to 'gather') dodges a fault of its TPU worker
    and is not carried over."""
    if augment_backend not in AUGMENT_BACKENDS:
        raise ValueError(f"augment backend {augment_backend!r} is not ported; "
                         f"have {AUGMENT_BACKENDS}")
    return "fused" if augment_backend == "auto" else augment_backend


def weak_draws(B: int, H: int, W: int, generator: torch.Generator, device) -> dict:
    """``weak_params`` as a dictionary: ``ang`` (degrees), ``tx``, ``ty``,
    ``flip``, each [B]."""
    ang, tx, ty, flip = weak_params(B, H, W, generator, device)
    return {"ang": ang, "tx": tx, "ty": ty, "flip": flip}


def _no_draws(B, H, W, generator, device) -> dict:
    return {}


def view_backend(augment_backend: str, kind: str):
    """(draw, apply) of one view of ``kind`` 'weak' or 'strong':
    ``draw(B, H, W, generator, device)`` → per-image parameters, the image
    on the last axis of each; ``apply(images_u8, params, mean, std)`` → f32
    NCHW. Weak views:

    * 'fused'    — one warp + normalize kernel (``fused_warp_normalize``)
    * 'pallas', 'paeth' — three ``hshift_rows`` passes, then flip and normalize
    * 'gather'   — one bilinear warp in stock tensor ops
    * 'normonly' — diagnostic: normalize without warp or flip (no draws)

    Strong views: 'pallas' and 'fused' (and so 'auto') run every warp
    through ``hshift_rows`` (geo='shear'); 'normonly' normalizes only, so
    that both views of a parity run are plain; the others use bilinear
    warps."""
    if kind not in ("weak", "strong"):
        raise ValueError(f"unknown view kind {kind!r}")
    backend = _resolve_backend(augment_backend)
    if backend == "normonly":
        return _no_draws, lambda imgs, p, mean, std: eval_batch(imgs, mean, std)
    if kind == "strong":
        geo = "shear" if backend in ("pallas", "fused") else "gather"
        return strong_params, lambda imgs, p, mean, std: strong_augment_batch_from_params(
            imgs, p, mean, std, geo=geo)
    weak = {"fused": weak_augment_batch_fused_from_params,
            "gather": weak_augment_batch_from_params}.get(
        backend, weak_augment_batch_paeth_from_params)
    return weak_draws, lambda imgs, p, mean, std: weak(imgs, **p, mean=mean, std=std)


def _view_fn(draw, apply):
    def view(images_u8, generator, mean, std):
        B, H, W, _ = images_u8.shape
        return apply(images_u8, draw(B, H, W, generator, images_u8.device), mean, std)
    return view


def pick_weak_backend(augment_backend: str):
    """Weak-view function ``(u8 NHWC, generator, mean, std) → f32 NCHW`` of
    ``view_backend``'s weak (draw, apply)."""
    return _view_fn(*view_backend(augment_backend, "weak"))


def pick_strong_backend(augment_backend: str):
    """Strong-view function of the same signature."""
    return _view_fn(*view_backend(augment_backend, "strong"))


# ----------------------------------------------------------------------
# Two views of one batch (reference image_aug_1/image_aug_2,
# utils/local_training.py:935-936)
# ----------------------------------------------------------------------

PAIR_MODES = ("dual_weak", "weak_strong")


def augment_pair_from_params(images_u8, p1: dict, p2: dict, mean, std,
                             mode: str = "dual_weak"):
    """Two views of a u8 NHWC batch on given draws: the 'gather' weak view
    on ``p1`` (``weak_draws``' keys), and the 'gather' weak view (mode
    'dual_weak') or strong view ('weak_strong', ``strong_params``' keys) on
    ``p2``. Bilinear warps in stock tensor ops: no kernel."""
    if mode not in PAIR_MODES:
        raise ValueError(f"unknown augment_pair mode {mode!r}; have {PAIR_MODES}")
    v1 = weak_augment_batch_from_params(images_u8, **p1, mean=mean, std=std)
    if mode == "dual_weak":
        return v1, weak_augment_batch_from_params(images_u8, **p2, mean=mean, std=std)
    return v1, strong_augment_batch_from_params(images_u8, p2, mean, std, geo="gather")


def augment_pair(images_u8, generator: torch.Generator, mean, std,
                 mode: str = "dual_weak"):
    """Two independently augmented views of a batch → (v1, v2), f32 NCHW:
    the first view's draws, then the second's."""
    B, H, W, _ = images_u8.shape
    dev = images_u8.device
    p1 = weak_draws(B, H, W, generator, dev)
    p2 = (weak_draws if mode == "dual_weak" else strong_params)(B, H, W, generator, dev)
    return augment_pair_from_params(images_u8, p1, p2, mean, std, mode)
