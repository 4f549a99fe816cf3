"""Depthwise-convolution backward kernels (port of
``fedmlp_tpu/ops/dw_pallas.py``), NCHW.

``dw_conv_pallas(x, w, stride, pads)`` is a depthwise convolution whose
forward is the framework's grouped convolution on the TF-SAME padded input
and whose backward runs two hand-written CUDA kernels
(``csrc/dw_conv.cu``), each reading the strided cotangent as it is:

* ``dw_dgrad`` — dx: each of the stride² output parity classes is a
  stride-1 correlation of the cotangent with a sub-filter of the unflipped
  filter (the JAX VJP's ``dw_conv_flat_s1`` on the zero-dilated cotangent
  with the flipped filter, without the zeros);
* ``dw_wgrad`` — dw: x read once at input resolution, the cotangent once at
  output resolution, summed in a fixed order (no atomics: equal inputs give
  equal bits).

Each wrapper takes its plain PyTorch version (``dw_dgrad_ref``,
``dw_wgrad_ref``, float32 accumulation) for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; there is no fallback. The stride-1
plain versions ``dw_conv_s1_ref`` / ``dw_wgrad_s1_ref`` follow the JAX
kernels' own interface (the dilated cotangent, the flipped filter) and
``dilate_to_input`` builds that cotangent: the tests hold the port against
the JAX kernels through them.

Layout: x ``[B, C, H, W]``, dy ``[B, C, Ho, Wo]``, contiguous; the filter
as the grouped ``nn.Conv2d``'s weight ``[C, 1, k, k]``; ``pads`` is the
forward's ``((top, bottom), (left, right))``. Types: float32 or bfloat16
operands, float32 accumulation, dx in dy's type, dw float32 or the type
asked for (the autograd function asks for the filter's, as the JAX VJP
casts to it).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from fedmlp_tpu_torch.ops import _build

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCH_COUNTS = {"dw_dgrad": 0, "dw_wgrad": 0}

_KERNEL_SIZES = (3, 5)  # the filters the CUDA kernels are instantiated for
_STRIDES = (1, 2)
THREADS = 256
COL_NX = 8               # rows of a thread's column strip (of two columns)
STAGES = 2               # ring slots of a row-tile block (csrc/dw_conv.cu kStages)
ROW_MIN_WIDTH = 56       # narrowest plane staged in row tiles
_TILE_STRIPS = 256       # column strips of a row tile: about one a thread
_ROW_SMEM = 64 * 1024    # a row-tile block's ring, at most
MAX_GROUP = 64           # whole planes a block, at most: 4 threads a plane
_TARGET_BLOCKS = 1056    # wgrad blocks aimed for: 8 on each of 132 SMs
# dynamic shared memory a block may opt in to: the H100's 227 KB less the
# kernels' static reduction buffer (6.4 KB at most)
SMEM_LIMIT = 220 * 1024

# the int arrays handed to csrc/dw_conv.cu, in its DgradField / WgradField order
DGRAD_FIELDS = ("B", "C", "H", "W", "Ho", "Wo", "k", "s", "pt", "pl", "bf16",
                "rows", "th", "group", "R", "SW", "P", "smem", "dense")
WGRAD_FIELDS = ("B", "C", "H", "W", "Ho", "Wo", "k", "s", "pt", "pl", "bf16",
                "rows", "th", "group", "splits", "Rg", "RX", "SWx", "SWg", "P", "smem",
                "out_bf16")


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _padded_f32(x: torch.Tensor, k: int, pt: int, pl: int) -> torch.Tensor:
    """x as float32 with pt zero rows above, pl zero columns left and the
    rest of k−1 below and right."""
    return F.pad(x.float(), (pl, k - 1 - pl, pt, k - 1 - pt))


def dw_conv_s1_ref(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """The JAX kernel ``dw_conv_flat_s1`` in plain PyTorch: out[b,c,y,x] =
    Σ_{ky,kx} x_pad[b,c,y+ky,x+kx]·w[c,0,ky,kx], summed in float32 in tap
    order, returned in x's type."""
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
    """The JAX kernel ``dw_wgrad_flat_s1`` in plain PyTorch: dw[c,0,ky,kx]
    = Σ_b Σ_{y,x} x_pad[b,c,y+ky,x+kx]·dy[b,c,y,x] in float32 → [C,1,k,k]."""
    (pt, _), (pl, _) = pads
    H, W = x.shape[2], x.shape[3]
    xp = _padded_f32(x, k, pt, pl)
    g = dy.float()
    taps = [(xp[:, :, ky:ky + H, kx:kx + W] * g).sum(dim=(0, 2, 3))
            for ky in range(k) for kx in range(k)]
    return torch.stack(taps, dim=1).reshape(x.shape[1], 1, k, k)


def phase_taps(k: int, s: int, p: int, phase: int) -> list[tuple[int, int]]:
    """(tap, offset) of one output parity class: output index s·j + phase
    takes tap t of the filter at cotangent index j + offset, for each t
    with s | (phase + p − t) (p: the forward's pad before)."""
    return [(t, (phase + p - t) // s) for t in range(k) if (phase + p - t) % s == 0]


def dw_dgrad_ref(dy: torch.Tensor, w: torch.Tensor, stride: int, pads, hw) -> torch.Tensor:
    """Plain version of ``dw_dgrad``: dx [B,C,H,W] of the depthwise
    convolution of stride ``stride`` under the forward's ``pads``, from the
    cotangent dy [B,C,Ho,Wo] and the unflipped filter w [C,1,k,k]. Written
    as the kernel computes it: each output parity class (py, px) is a
    stride-1 correlation of dy with the sub-filter ``phase_taps`` gives,
    summed in float32 in tap order, returned in dy's type."""
    k, s = w.shape[-1], stride
    (pt, _), (pl, _) = pads
    H, W = hw
    B, C, Ho, Wo = dy.shape
    g, wf = dy.float(), w.float()
    dx = g.new_zeros((B, C, H, W))
    for py in range(min(s, H)):
        ny = len(range(py, H, s))
        rows = phase_taps(k, s, pt, py)
        for px in range(min(s, W)):
            nx = len(range(px, W, s))
            cols = phase_taps(k, s, pl, px)
            if not rows or not cols:
                continue
            # zero rows/columns around dy so that j + offset stays inside
            top = max(0, -min(o for _, o in rows))
            bottom = max(0, ny - 1 + max(o for _, o in rows) - (Ho - 1))
            left = max(0, -min(o for _, o in cols))
            right = max(0, nx - 1 + max(o for _, o in cols) - (Wo - 1))
            gp = F.pad(g, (left, right, top, bottom))
            acc = None
            for ky, oy in rows:
                for kx, ox in cols:
                    win = gp[:, :, oy + top:oy + top + ny, ox + left:ox + left + nx]
                    term = win * wf[None, :, 0, ky, kx, None, None]
                    acc = term if acc is None else acc + term
            dx[:, :, py::s, px::s] = acc
    return dx.to(dy.dtype)


def dw_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int, pads) -> torch.Tensor:
    """Plain version of ``dw_wgrad``: dw[c,0,ky,kx] = Σ_b Σ_{yo,xo}
    x_pad[b,c,s·yo+ky,s·xo+kx]·dy[b,c,yo,xo] in float32 → [C,1,k,k], only
    the products at strided positions."""
    (pt, _), (pl, _) = pads
    s = stride
    B, C, H, W = x.shape
    Ho, Wo = dy.shape[2], dy.shape[3]
    span_h, span_w = s * (Ho - 1) + 1, s * (Wo - 1) + 1
    xp = F.pad(x.float(), (pl, max(0, span_w + k - 1 - pl - W),
                           pt, max(0, span_h + k - 1 - pt - H)))
    g = dy.float()
    taps = [(xp[:, :, ky:ky + span_h:s, kx:kx + span_w:s] * g).sum(dim=(0, 2, 3))
            for ky in range(k) for kx in range(k)]
    return torch.stack(taps, dim=1).reshape(C, 1, k, k)


# ----------------------------------------------------------------------
# Launch plans
# ----------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@dataclass(frozen=True)
class DgradPlan:
    """How ``dw_dgrad`` cuts its work. A thread computes a column strip of
    ``COL_NX`` rows of two columns. rows: a block walks one plane in tiles
    of ``th`` output rows through a ring of STAGES slabs (cp.async); else a
    block takes ``group`` whole planes (``dense``: odd W, dx written from a
    dense copy in shared memory). A slab holds R cotangent rows of SW
    values, the data from column P (and, for whole planes, from row P).
    ``smem``: dynamic shared bytes of a block."""
    rows: bool
    th: int
    group: int
    R: int
    SW: int
    P: int
    smem: int
    dense: bool = False


@dataclass(frozen=True)
class WgradPlan:
    """How ``dw_wgrad`` cuts its work. A thread sums column strips of
    ``COL_NX`` rows of two cotangent columns. rows: block (c, split) walks
    the (image, tile of ``th`` cotangent rows) items of channel c through a
    ring of STAGES slots; else block (channel group of ``group``, split)
    walks whole planes image by image. x slabs: RX rows of SWx values, data
    from column P (and row pt for whole planes); cotangent slabs: Rg rows of
    SWg values, data from row and column 0, zero below the plane."""
    rows: bool
    th: int
    group: int
    splits: int
    Rg: int
    RX: int
    SWx: int
    SWg: int
    P: int
    smem: int


def _group(rows: int, cols: int) -> int:
    """Whole planes a block takes: about THREADS column strips in all (a
    strip is COL_NX rows of two columns of the plane the block iterates),
    a power of two, at most MAX_GROUP."""
    strips = -(-rows // COL_NX) * -(-cols // 2)
    return min(MAX_GROUP, _pow2_at_most(THREADS // strips))


@functools.lru_cache(maxsize=None)
def dgrad_plan(B: int, C: int, H: int, W: int, Ho: int, Wo: int, k: int, s: int,
               pt: int, pl: int, elt: int) -> DgradPlan:
    """The launch plan of ``dw_dgrad`` (``elt``: bytes of a value)."""
    vec = 16 // elt
    # past the last cotangent column the last strip (columns W-1 or W-2, W-1) reads
    x_last, pl_s = 2 * ((W - 1) // 2), pl % s
    last_col = (x_last + pl - pl_s) // s - (k - 1) // s + (pl_s + k) // s + 1
    if W >= ROW_MIN_WIDTH and (Wo * elt) % 16 == 0:
        P = vec
        SW = _round_up(max(P + Wo, last_col + P), vec)
        th = min(_round_up(H, COL_NX), COL_NX * max(1, _TILE_STRIPS // -(-W // 2)))
        while True:
            R = th // s + (k - 1) // s + (s - 1)
            smem = STAGES * R * SW * elt
            if smem <= _ROW_SMEM or th == COL_NX:
                break
            th -= COL_NX
        if smem <= SMEM_LIMIT:
            return DgradPlan(True, th, 1, R, SW, P, smem)
    P = (k - 1) // s
    SW = max(P + Wo, last_col + P)
    R = P + max(Ho, (_round_up(H, COL_NX) - 1 + pt) // s + 1)

    dense = W % 2 == 1

    def smem(group):  # the slabs, then the group's dense dx on a 16-byte boundary
        return _round_up(group * R * SW * elt, 16) + dense * group * H * W * elt

    group = _group(H, W)
    while group > 1 and smem(group) > SMEM_LIMIT:
        group //= 2
    if smem(group) > SMEM_LIMIT:
        raise ValueError(f"dw_dgrad: a {Ho}x{Wo} cotangent plane does not fit a "
                         "block's shared memory")
    return DgradPlan(False, H, group, R, SW, P, smem(group), dense)


@functools.lru_cache(maxsize=None)
def wgrad_plan(B: int, C: int, H: int, W: int, Ho: int, Wo: int, k: int, s: int,
               pt: int, pl: int, elt: int) -> WgradPlan:
    """The launch plan of ``dw_wgrad`` (``elt``: bytes of a value)."""
    vec = 16 // elt
    # past the last x column the last strip (cotangent columns xo, xo + 1) reads
    pairs = 2 * -(-Wo // 2)
    last_col = s * (pairs - 2) - pl + s + k
    if W >= ROW_MIN_WIDTH and (W * elt) % 16 == 0 and (Wo * elt) % 16 == 0:
        P = vec
        SWx = _round_up(max(P + W, last_col + P), vec)
        SWg = _round_up(pairs, vec)
        th = min(_round_up(Ho, COL_NX), COL_NX * max(1, _TILE_STRIPS // -(-Wo // 2)))
        while True:
            RX = s * (th - 1) + k
            smem = STAGES * (RX * SWx + th * SWg) * elt
            if smem <= _ROW_SMEM or th == COL_NX:
                break
            th -= COL_NX
        if smem <= SMEM_LIMIT:
            n_items = B * -(-Ho // th)
            splits = max(1, min(n_items, -(-_TARGET_BLOCKS // C)))
            return WgradPlan(True, th, 1, splits, th, RX, SWx, SWg, P, smem)
    P = k - 1
    Rg = _round_up(Ho, COL_NX)
    RX = max(s * (Rg - 1) + k, pt + H)
    SWx = max(P + W, last_col + P)
    per_channel = (RX * SWx + Rg * pairs) * elt
    group = _group(Ho, Wo)
    while group > 1 and group * per_channel > SMEM_LIMIT:
        group //= 2
    if group * per_channel > SMEM_LIMIT:
        raise ValueError(f"dw_wgrad: an {H}x{W} plane does not fit a block's "
                         "shared memory")
    splits = max(1, min(B, -(-_TARGET_BLOCKS // -(-C // group))))
    return WgradPlan(False, Ho, group, splits, Rg, RX, SWx, pairs, P,
                     group * per_channel)


@functools.lru_cache(maxsize=None)
def _dgrad_args(B, C, H, W, Ho, Wo, k, s, pt, pl, elt):
    p = dgrad_plan(B, C, H, W, Ho, Wo, k, s, pt, pl, elt)
    vals = dict(B=B, C=C, H=H, W=W, Ho=Ho, Wo=Wo, k=k, s=s, pt=pt, pl=pl,
                bf16=int(elt == 2), rows=int(p.rows), th=p.th, group=p.group,
                R=p.R, SW=p.SW, P=p.P, smem=p.smem, dense=int(p.dense))
    return (ctypes.c_int * len(DGRAD_FIELDS))(*(vals[f] for f in DGRAD_FIELDS))


@functools.lru_cache(maxsize=None)
def _wgrad_args(B, C, H, W, Ho, Wo, k, s, pt, pl, elt, out_bf16):
    p = wgrad_plan(B, C, H, W, Ho, Wo, k, s, pt, pl, elt)
    vals = dict(B=B, C=C, H=H, W=W, Ho=Ho, Wo=Wo, k=k, s=s, pt=pt, pl=pl,
                bf16=int(elt == 2), rows=int(p.rows), th=p.th, group=p.group,
                splits=p.splits, Rg=p.Rg, RX=p.RX, SWx=p.SWx, SWg=p.SWg, P=p.P,
                smem=p.smem, out_bf16=int(out_bf16))
    return p.splits, (ctypes.c_int * len(WGRAD_FIELDS))(*(vals[f] for f in WGRAD_FIELDS))


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.dim() != 4:
        raise ValueError(f"{name}: operands must be [B, C, H, W], got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: operands must be float32 or bfloat16, got {a.dtype}")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"{name}: {what} must match the cotangent's type and device, "
                         f"got {b.dtype} on {b.device} vs {a.dtype} on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")


def _out_size(name: str, n: int, k: int, s: int, before: int, after: int) -> int:
    if min(before, after) < 0 or before > k - 1 or s < 1:
        raise ValueError(f"{name}: pads ({before}, {after}) or stride {s} out of "
                         f"range for k={k}")
    return (n + before + after - k) // s + 1


def _check_cuda(name: str, k: int, stride: int, **tensors) -> None:
    if k not in _KERNEL_SIZES or stride not in _STRIDES:
        raise ValueError(f"{name}: the CUDA kernel takes k in {_KERNEL_SIZES} and "
                         f"stride in {_STRIDES}, got k={k}, stride={stride}")
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must start on a 16-byte boundary "
                             "(the kernel's vector loads)")


def _launch(t: torch.Tensor, fn, *args) -> None:
    """Call ``fn(*args, stream)`` on t's device and current stream; raise on
    a CUDA error."""
    if t.device.index != torch.cuda.current_device():
        with torch.cuda.device(t.device):
            return _launch(t, fn, *args)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def dw_dgrad(dy: torch.Tensor, w: torch.Tensor, stride: int, pads, hw) -> torch.Tensor:
    """dx [B,C,H,W] (``hw`` = (H, W)) of the depthwise convolution of stride
    ``stride`` under the forward's ``pads`` ((top, bottom), (left, right)),
    from the cotangent dy [B,C,Ho,Wo] and the filter w [C,1,k,k] of dy's
    type; in dy's type. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    name = "dw_dgrad"
    _check_pair(name, dy, w, "w")
    B, C, Ho, Wo = dy.shape
    if w.dim() != 4 or w.shape[0] != C or w.shape[1] != 1 or w.shape[2] != w.shape[3]:
        raise ValueError(f"{name}: w must be [{C}, 1, k, k], got {tuple(w.shape)}")
    k = w.shape[-1]
    (pt, pb), (pl, pr) = pads
    H, W = hw
    want = (_out_size(name, H, k, stride, pt, pb), _out_size(name, W, k, stride, pl, pr))
    if want != (Ho, Wo):
        raise ValueError(f"{name}: cotangent {Ho}x{Wo} does not match a {H}x{W} "
                         f"input at k={k}, stride {stride}, pads {pads}")
    if dy.device.type == "cpu":
        return dw_dgrad_ref(dy, w, stride, pads, hw)
    _check_cuda(name, k, stride, dy=dy, w=w)
    dx = dy.new_empty((B, C, H, W))
    if dx.numel() == 0:
        return dx
    args = _dgrad_args(B, C, H, W, Ho, Wo, k, stride, pt, pl, dy.element_size())
    _launch(dy, _dw_lib().dw_dgrad, dy.data_ptr(), w.data_ptr(), dx.data_ptr(), args)
    LAUNCH_COUNTS[name] += 1
    return dx


def dw_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int, pads,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dw [C,1,k,k] of the depthwise convolution of stride ``stride`` under
    the forward's ``pads``, from x [B,C,H,W] and the cotangent dy
    [B,C,Ho,Wo] of one type; summed in float32 and returned in
    ``out_dtype`` (float32 or bfloat16). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    name = "dw_wgrad"
    _check_pair(name, dy, x, "x")
    B, C, H, W = x.shape
    (pt, pb), (pl, pr) = pads
    want = (B, C, _out_size(name, H, k, stride, pt, pb), _out_size(name, W, k, stride, pl, pr))
    if tuple(dy.shape) != want:
        raise ValueError(f"{name}: cotangent {tuple(dy.shape)} must be {want} for x "
                         f"{tuple(x.shape)} at k={k}, stride {stride}, pads {pads}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return dw_wgrad_ref(x, dy, k, stride, pads).to(out_dtype)
    _check_cuda(name, k, stride, x=x, dy=dy)
    if x.numel() == 0 or dy.numel() == 0:
        return torch.zeros((C, 1, k, k), dtype=out_dtype, device=x.device)
    splits, args = _wgrad_args(B, C, H, W, want[2], want[3], k, stride, pt, pl,
                               x.element_size(), out_dtype == torch.bfloat16)
    partial = torch.empty((splits, C, k * k), dtype=torch.float32, device=x.device)
    out = torch.empty((C, 1, k, k), dtype=out_dtype, device=x.device)
    _launch(x, _dw_lib().dw_wgrad, x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
            out.data_ptr(), args)
    LAUNCH_COUNTS[name] += 1
    return out


_LIB = None


def _dw_lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("dw_conv")
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.dw_dgrad.argtypes = [vp, vp, vp, ip, vp]
        lib.dw_dgrad.restype = ctypes.c_int
        lib.dw_wgrad.argtypes = [vp, vp, vp, vp, ip, vp]
        lib.dw_wgrad.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ----------------------------------------------------------------------
# The custom VJP
# ----------------------------------------------------------------------

def dilate_to_input(dy: torch.Tensor, stride: int, H: int, W: int) -> torch.Tensor:
    """Zero-embed a strided cotangent [B,C,Ho,Wo] at input resolution
    [B,C,H,W]: data at rows/columns stride·i, zeros elsewhere (the JAX
    VJP's operand of its stride-1 kernels)."""
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
    ``dw_dgrad``, dw = ``dw_wgrad`` written in the filter's type, both on
    the strided cotangent as it comes. The caller hands in x and w already
    in the compute type, so under ``torch.autocast`` the function behaves
    as ``F.conv2d`` does; the backward calls no op that autocast recasts."""

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
        if dy.dtype != x.dtype:
            dy = dy.to(x.dtype)
        if not dy.is_contiguous():
            dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dw_dgrad(dy, w, ctx.stride, ctx.pads, x.shape[2:])
        if ctx.needs_input_grad[1]:
            dw = dw_wgrad(x, dy, w.shape[-1], ctx.stride, ctx.pads, w.dtype)
        return dx, dw, None, None


def dw_conv_pallas(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """Depthwise convolution of x [B,C,H,W] with w [C,1,k,k] (one type) at
    ``stride`` under ``pads``, differentiated by the two kernels above."""
    if w.dtype != x.dtype:
        raise ValueError(f"dw_conv_pallas: x is {x.dtype}, w is {w.dtype}; cast "
                         "both to the compute type first")
    return _DwConvPallas.apply(x, w, stride, pads)
