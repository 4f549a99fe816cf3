"""The strided depthwise backward of the port (``dw_dgrad`` / ``dw_wgrad``
in fedmlp_tpu_torch/ops/dw_pallas.py) against the JAX package's Pallas
kernels, and the launch plans of their CUDA kernels.

The JAX VJP runs its stride-1 kernels ``dw_conv_flat_s1`` and
``dw_wgrad_flat_s1`` (interpret mode here) on the cotangent zero-dilated to
input resolution, with the flipped filter for dx. The port's plain versions
take the strided cotangent as it is and skip the zeros: dx by output parity
class, each a stride-1 correlation with a sub-filter; dw from the products
at strided positions only. Same numpy inputs, float32, on the CPU (where
the wrappers take the plain versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.models.efficientnet import _same_pads
from fedmlp_tpu.ops.dw_pallas import dw_conv_flat_s1, dw_wgrad_flat_s1
from fedmlp_tpu_torch.ops import dw_pallas as T
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# (k, stride, H, W, pads): TF-SAME pads at odd and even sizes (stride 2, even:
# (0, 1) for k=3, (1, 2) for k=5; odd: (1, 1), (2, 2)) and other splits
_CASES = [
    (3, 1, 12, 12, None), (5, 1, 9, 9, None), (3, 1, 7, 10, ((0, 2), (2, 0))),
    (5, 1, 8, 8, ((1, 3), (4, 0))), (3, 2, 16, 16, None), (3, 2, 15, 15, None),
    (5, 2, 16, 16, None), (5, 2, 13, 13, None), (3, 2, 12, 9, ((1, 1), (1, 0))),
    (5, 2, 11, 12, ((0, 4), (4, 0))),
]


def _pads(k, s, H, W, pads):
    return pads or (_same_pads(H, k, s), _same_pads(W, k, s))


def _operands(seed, k, s, H, W, pads, B=2, C=5):
    (pt, pb), (pl, pr) = pads
    Ho, Wo = (H + pt + pb - k) // s + 1, (W + pl + pr - k) // s + 1
    rs = np.random.RandomState(seed)
    x = rs.randn(B, C, H, W).astype(np.float32)
    dy = rs.randn(B, C, Ho, Wo).astype(np.float32)
    w = rs.randn(C, 1, k, k).astype(np.float32)
    return x, dy, w


def _nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _dilated(dy, s, H, W):
    return T.dilate_to_input(torch.from_numpy(dy), s, H, W).numpy()


@pytest.mark.parametrize("k,s,H,W,pads", _CASES)
def test_dgrad_ref_matches_jax_kernel_on_the_dilated_cotangent(k, s, H, W, pads):
    """dx: ``dw_dgrad_ref`` on the strided cotangent against the Pallas conv
    kernel on the dilated one with the flipped filter under pads ((k−1−pt,
    pt), (k−1−pl, pl)), as the JAX VJP runs it, and ``dw_conv_s1_ref`` on
    that kernel's operands; rtol/atol 1e-5 (the same nonzero float32
    products; the zeros add nothing)."""
    pads = _pads(k, s, H, W, pads)
    _, dy, w = _operands(k * 100 + H, k, s, H, W, pads, B=1)
    (pt, _), (pl, _) = pads
    wf = np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 1, 0))
    want = dw_conv_flat_s1(_nhwc(_dilated(dy, s, H, W)), jnp.asarray(wf),
                           ((k - 1 - pt, pt), (k - 1 - pl, pl)), interpret=True)
    got = T.dw_dgrad(torch.from_numpy(dy), torch.from_numpy(w), s, pads, (H, W))
    assert got.shape == (1, 5, H, W)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the JAX kernel's own interface in plain PyTorch, on the same operands
    s1 = T.dw_conv_s1_ref(torch.from_numpy(_dilated(dy, s, H, W)),
                          torch.from_numpy(w).flip(2, 3), ((k - 1 - pt, pt), (k - 1 - pl, pl)))
    np.testing.assert_allclose(s1.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,s,H,W,pads", _CASES)
def test_wgrad_ref_matches_jax_kernel_on_the_dilated_cotangent(k, s, H, W, pads):
    """dw: ``dw_wgrad_ref`` on the strided cotangent against the Pallas
    wgrad kernel on x and the dilated cotangent, and ``dw_wgrad_s1_ref`` on
    that kernel's operands; rtol 1e-5, atol 1e-4 (B·Ho·Wo float32 products
    summed in another order)."""
    pads = _pads(k, s, H, W, pads)
    x, dy, _ = _operands(k * 10 + W, k, s, H, W, pads)
    want = dw_wgrad_flat_s1(_nhwc(x), _nhwc(_dilated(dy, s, H, W)), k, pads,
                            interpret=True)
    got = T.dw_wgrad(torch.from_numpy(x), torch.from_numpy(dy), k, s, pads)
    assert got.dtype == torch.float32 and got.shape == (5, 1, k, k)
    want = np.asarray(want).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    dy_e = torch.from_numpy(_dilated(dy, s, H, W))
    s1 = T.dw_wgrad_s1_ref(torch.from_numpy(x), dy_e, k, pads)
    np.testing.assert_allclose(s1.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 1), (3, 2), (5, 2), (1, 2)])
def test_phase_taps_split_the_filter(k, s):
    """Each tap falls in exactly one output parity class of each axis, at a
    cotangent offset that puts it on the forward's sampling grid: s·(j +
    offset) + tap = s·j + phase + pad. A class may have no tap (k=1, s=2),
    and then its outputs are 0."""
    for pad in range(k):
        seen = []
        for phase in range(s):
            for t, off in T.phase_taps(k, s, pad, phase):
                assert s * off + t == phase + pad
                seen.append(t)
        assert sorted(seen) == list(range(k))
    if k == 1:
        dy = torch.ones(1, 1, 2, 2)
        dx = T.dw_dgrad_ref(dy, torch.ones(1, 1, 1, 1), 2, ((0, 0), (0, 0)), (4, 4))
        assert torch.equal(dx[0, 0, 1::2], torch.zeros(2, 4))
        assert torch.equal(dx[0, 0, ::2, ::2], torch.ones(2, 2))


def test_wgrad_writes_the_type_asked_for():
    """``out_dtype`` bf16 is the float32 sum rounded once, as the autograd
    function hands it to a bf16 filter."""
    pads = ((1, 1), (1, 1))
    x, dy, _ = _operands(7, 3, 1, 6, 6, pads)
    xt, dyt = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = T.dw_wgrad(xt, dyt, 3, 1, pads, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, T.dw_wgrad_ref(xt, dyt, 3, 1, pads).bfloat16())


# the 16 depthwise layers of EfficientNet-B0 at 224 px: C, H, k, stride
_B0_LAYERS = [(32, 112, 3, 1), (96, 112, 3, 2), (144, 56, 3, 1), (144, 56, 5, 2),
              (240, 28, 5, 1), (240, 28, 3, 2), (480, 14, 3, 1), (480, 14, 3, 1),
              (480, 14, 5, 1), (672, 14, 5, 1), (672, 14, 5, 1), (672, 14, 5, 2),
              (1152, 7, 5, 1), (1152, 7, 5, 1), (1152, 7, 5, 1), (1152, 7, 3, 1)]


def _layer(C, H, k, s):
    pt, pb = _same_pads(H, k, s)
    return pt, (H + pt + pb - k) // s + 1


def _check_dgrad_plan(B, C, H, k, s, pt, Ho, elt):
    """Replays ``dw_dgrad``'s kernel loops over a plan (column strips: a
    thread takes 8 rows of two columns): every output row computed exactly
    once, every read inside its slab, the staged data inside it too, the
    alignment rules held."""
    p = T.dgrad_plan(B, C, H, H, Ho, Ho, k, s, pt, pt, elt)
    nx, py = T.COL_NX, pt % s
    assert p.smem <= T.SMEM_LIMIT
    vec = 16 // elt
    if p.rows:
        assert (Ho * elt) % 16 == 0 and p.P % vec == 0 and p.SW % vec == 0
        assert p.smem == T.STAGES * p.R * p.SW * elt and p.th % nx == 0
        tiles = [(t * p.th, min(H, (t + 1) * p.th)) for t in range(-(-H // p.th))]
        bases = [(y0 + pt - py) // s - (k - 1) // s for y0, _ in tiles]
    else:
        assert 1 <= p.group <= T.MAX_GROUP and T.THREADS % p.group == 0
        assert p.dense == (H % 2 == 1)
        slabs = -(-p.group * p.R * p.SW * elt // 16) * 16
        assert p.smem == slabs + p.dense * p.group * H * H * elt
        tiles, bases = [(0, H)], [-p.P]
        assert p.P + Ho <= p.R  # the data rows
        groups = [(g0, min(B * C, g0 + p.group)) for g0 in range(0, B * C, p.group)]
        assert [i for a, b in groups for i in range(a, b)] == list(range(B * C))
    assert p.P + Ho <= p.SW
    done = set()
    rows_read = (nx + py + k - 2) // s + 1
    for (y0t, y1t), base in zip(tiles, bases):
        for y0 in range(y0t, y1t, nx):
            first = (y0 + pt - py) // s - (k - 1) // s - base
            assert 0 <= first and first + rows_read <= p.R, (y0, first)
            done.update(y for y in range(y0, min(y0 + nx, H)))
    assert sorted(done) == list(range(H))
    pl_s = pt % s  # the replay keeps one pad for both axes
    for x in range(0, H, 2):  # a strip's two columns x, x+1
        col = (x + pt - pl_s) // s - (k - 1) // s + p.P
        assert col >= 0 and col + (pl_s + k) // s + 1 <= p.SW
    return p


def _check_wgrad_plan(B, C, H, k, s, pt, Ho, elt):
    """Replays ``dw_wgrad``'s kernel loops over a plan: every (image, row)
    of every channel summed exactly once, every read inside its slab."""
    p = T.wgrad_plan(B, C, H, H, Ho, Ho, k, s, pt, pt, elt)
    nx = T.COL_NX
    assert p.smem <= T.SMEM_LIMIT and 1 <= p.splits <= 65535
    vec = 16 // elt
    if p.rows:
        assert (H * elt) % 16 == 0 and (Ho * elt) % 16 == 0
        assert p.P % vec == 0 and p.SWx % vec == 0 and p.SWg % vec == 0
        assert p.smem == T.STAGES * (p.RX * p.SWx + p.th * p.SWg) * elt
        assert p.th % nx == 0 and p.Rg == p.th
        n_tiles = -(-Ho // p.th)
        items = sorted(i for sp in range(p.splits) for i in range(sp, B * n_tiles, p.splits))
        assert items == list(range(B * n_tiles))
        rows = sorted(t * p.th + r for t in range(n_tiles)
                      for r in range(min(p.th, Ho - t * p.th)))
        assert rows == list(range(Ho))
    else:
        assert 1 <= p.group <= T.MAX_GROUP and T.THREADS % p.group == 0
        assert p.smem == p.group * (p.RX * p.SWx + p.Rg * p.SWg) * elt
        assert p.Rg % nx == 0 and Ho <= p.Rg and pt + H <= p.RX
        images = sorted(b for sp in range(p.splits) for b in range(sp, B, p.splits))
        assert images == list(range(B))
        chans = [c for c0 in range(0, C, p.group) for c in range(c0, min(C, c0 + p.group))]
        assert chans == list(range(C))
    # x rows of the last strip of a tile (or of the planes), from the base
    assert s * (p.Rg - nx) + s * (nx - 1) + k <= p.RX
    assert p.P + H <= p.SWx and Ho <= p.SWg
    for xo in range(0, Ho, 2):  # a strip's two cotangent columns xo, xo+1
        xcol = s * xo - pt + p.P
        assert xcol >= 0 and xcol + s + k <= p.SWx and xo + 2 <= p.SWg
    return p


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("B", [32, 2])
def test_launch_plans_at_the_b0_layers(B, elt):
    """Both kernels' plans at the 16 B0 layers (bf16 and f32): row tiles
    for the large planes (every layer with 112 or 56 columns whose rows are
    whole 16-byte vectors), whole-plane groups elsewhere; the groups of
    whole planes are powers of two, and at B=32 each group's run of planes
    starts on a 16-byte boundary (G·Ho·Wo·bytes a multiple of 16: G a
    multiple of 8 for the 7×7 bf16 planes)."""
    for C, H, k, s in _B0_LAYERS:
        pt, Ho = _layer(C, H, k, s)
        d = _check_dgrad_plan(B, C, H, k, s, pt, Ho, elt)
        w = _check_wgrad_plan(B, C, H, k, s, pt, Ho, elt)
        assert d.rows == (H >= 56 and (Ho * elt) % 16 == 0)
        assert w.rows == (H >= 56 and (Ho * elt) % 16 == 0)
        for p, n in ((d, Ho * Ho), (w, Ho * Ho)):
            if not p.rows and B == 32:
                assert (p.group * n * elt) % 16 == 0 and (p.group * H * H * elt) % 16 == 0


@pytest.mark.parametrize("k,s,H,pads", [
    (3, 2, 30, ((0, 1), (0, 1))), (5, 2, 113, ((2, 2), (2, 2))), (5, 1, 7, ((2, 2), (2, 2))),
    (5, 1, 9, ((1, 3), (4, 0))), (3, 1, 56, ((1, 1), (1, 1))), (3, 2, 224, ((0, 1), (0, 1)))])
def test_launch_plans_at_the_card_test_shapes(k, s, H, pads):
    """The card tests' shapes (odd sizes, uneven pads, a plane larger than
    a tile, more padding than data) and a 224-px plane, in both types."""
    (pt, pb), (pl, _) = pads
    if pt != pl:  # the replay keeps one pad for both axes
        pads = ((pt, pb), (pt, pb))
    Ho = (H + pt + pb - k) // s + 1
    for elt in (2, 4):
        _check_dgrad_plan(3, 24, H, k, s, pt, Ho, elt)
        _check_wgrad_plan(3, 24, H, k, s, pt, Ho, elt)


def test_plans_refuse_a_plane_that_does_not_fit():
    """A plane whose rows are not whole 16-byte vectors goes whole into
    shared memory; where even one does not fit, the plan raises rather than
    take another path."""
    with pytest.raises(ValueError, match="does not fit"):
        T.wgrad_plan(1, 1, 401, 401, 401, 401, 3, 1, 1, 1, 4)
    with pytest.raises(ValueError, match="does not fit"):
        T.dgrad_plan(1, 1, 401, 401, 401, 401, 3, 1, 1, 1, 4)
