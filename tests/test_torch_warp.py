"""The port's weak-view warp (fedmlp_tpu_torch/ops/warp.py) against the JAX
package's fused Pallas warp (run in interpret mode, as the JAX package's own
tests run it on the CPU). The same numpy images and parameters go to both.

The CUDA kernel itself runs only on a card: ``test_torch_kernels_cuda.py``
(marker ``cuda``) holds it against the plain version there, and
``chip_smoke.py`` does the same at the flagship shape.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.ops import pallas_warp as PW
from fedmlp_tpu_torch.ops import warp as W

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _max_slope(degrees=10.0):
    rad = math.radians(degrees)
    return max(math.tan(rad / 2.0), math.sin(rad))


def _cases(S, n_random, seed):
    """(θ deg, tx, ty, flip) per image: the identity, an integer shift, a
    flipped image, and random weak-range draws."""
    rng = np.random.RandomState(seed)
    cases = [(0.0, 0.0, 0.0, False), (0.0, 3.0, -2.0, False),
             (7.5, 0.4, -0.9, True)]
    for _ in range(n_random):
        cases.append((rng.uniform(-10, 10), rng.uniform(-.02, .02) * S,
                      rng.uniform(-.02, .02) * S, bool(rng.rand() < 0.5)))
    return cases


def _jax_views(imgs, cases, S):
    """Compose each view as weak_augment_batch_fused.one does: the flip is
    folded into affine(−θ, −tx, ty) on the mirrored u8 image."""
    planars, params = [], []
    for img, (ang, tx, ty, flip) in zip(imgs, cases):
        if flip:
            ang, tx = -ang, -tx
        planar = img.transpose(2, 0, 1)
        if flip:
            planar = planar[:, :, ::-1]
        planars.append(np.ascontiguousarray(planar))
        params.append(np.asarray(PW.paeth_shift_params(
            jnp.deg2rad(jnp.float32(ang)), jnp.float32(tx), jnp.float32(ty), S, S)))
    params = np.stack(params)
    run = jax.jit(jax.vmap(lambda p, q: PW.fused_warp_normalize(
        p, q, MEAN, STD, interpret=True, max_slope=_max_slope())))
    return np.asarray(run(jnp.asarray(np.stack(planars)), jnp.asarray(params))), params


@pytest.mark.parametrize("S,n_random", [(32, 3), (64, 2)])
def test_fused_warp_ref_matches_jax_kernel(S, n_random):
    """Tolerance atol 1e-4 on the normalized scale (values of a few units):
    the TPU kernel sums its taps in another order and may contract them
    into FMAs, so the two differ by a few f32 ulps."""
    cases = _cases(S, n_random, seed=S)
    imgs = np.random.RandomState(S + 1).randint(0, 256, (len(cases), S, S, 3), np.uint8)
    want, params = _jax_views(imgs, cases, S)
    flip = torch.tensor([c[3] for c in cases])
    got = W.fused_warp_normalize(torch.from_numpy(imgs), torch.from_numpy(params),
                                 flip, MEAN, STD)
    assert got.shape == (len(cases), 3, S, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the identity view is the normalized image itself
    norm = (imgs[0].astype(np.float32).transpose(2, 0, 1)
            - np.float32(255) * np.asarray(MEAN, np.float32)[:, None, None])
    np.testing.assert_allclose(got[0].numpy(),
                               norm / (np.float32(255) * np.asarray(STD, np.float32)[:, None, None]),
                               rtol=0, atol=1e-4)


def test_paeth_shift_params_matches_jax():
    """rtol 1e-5: the same f32 expression, sin/cos/tan from two libraries."""
    rng = np.random.RandomState(0)
    theta = np.deg2rad(rng.uniform(-10, 10, 16)).astype(np.float32)
    tx = rng.uniform(-4, 4, 16).astype(np.float32)
    ty = rng.uniform(-4, 4, 16).astype(np.float32)
    want = np.stack([np.asarray(PW.paeth_shift_params(
        jnp.float32(a), jnp.float32(b), jnp.float32(c), 48, 40))
        for a, b, c in zip(theta, tx, ty)])
    got = W.paeth_shift_params(torch.from_numpy(theta), torch.from_numpy(tx),
                               torch.from_numpy(ty), 48, 40).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weak_param_draws_cover_the_weak_range():
    g = torch.Generator().manual_seed(0)
    n, H, Wd = 4000, 64, 48
    ang, tx, ty, flip = W.weak_params(n, H, Wd, g, "cpu")
    assert float(ang.min()) >= -10.0 and float(ang.max()) <= 10.0
    assert float(ang.min()) < -9.9 and float(ang.max()) > 9.9
    assert float(tx.abs().max()) <= 0.02 * Wd + 1e-6
    assert float(ty.abs().max()) <= 0.02 * H + 1e-6
    # Bernoulli(½) over 4000 draws: sd 0.008, so ±0.03 is ~4 sd
    assert abs(float(flip.float().mean()) - 0.5) < 0.03


def test_weak_augment_on_cpu_is_the_plain_version():
    """A CPU batch takes the plain version (no launch is counted), and the
    view equals the plain version on the generator's own draws."""
    imgs = torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3), np.uint8))
    W.reset_launch_counts()
    out = W.weak_augment_batch_fused(imgs, torch.Generator().manual_seed(5), MEAN, STD)
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 0
    ang, tx, ty, flip = W.weak_params(4, 32, 32, torch.Generator().manual_seed(5), "cpu")
    ang, tx = torch.where(flip, -ang, ang), torch.where(flip, -tx, tx)
    params = W.paeth_shift_params(torch.deg2rad(ang), tx, ty, 32, 32)
    want = W.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD)
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["dtype", "params", "flip", "square"])
def test_fused_warp_rejects_bad_inputs(bad):
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    params = torch.zeros((2, 3, 3))
    flip = torch.zeros(2, dtype=torch.bool)
    if bad == "dtype":
        imgs = imgs.float()
    elif bad == "params":
        params = params[:1]
    elif bad == "flip":
        flip = flip.float()
    else:
        imgs = torch.zeros((2, 8, 6, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        W.fused_warp_normalize(imgs, params, flip, MEAN, STD)


def _band_params(S, case, rng):
    """Shear params of three images: weak-range draws, 40° draws (one at
    each end of the range), or translations past the plane's edge."""
    n = 3
    ang = rng.uniform(-10, 10, n)
    tx = rng.uniform(-0.02, 0.02, n) * S
    ty = rng.uniform(-0.02, 0.02, n) * S
    if case == "40deg":
        ang = np.array([40.0, -40.0, rng.uniform(-40, 40)])
    elif case == "beyond":
        tx[0], ty[1], tx[2], ty[2] = S + 30.0, -(S + 30.0), -1.5 * S, 0.6 * S
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return W.paeth_shift_params(torch.deg2rad(t(ang)), t(tx), t(ty), S, S).contiguous()


@pytest.mark.parametrize("case", ["weak", "40deg", "beyond"])
@pytest.mark.parametrize("S", [224, 97])
def test_warp_source_band_holds_every_row_the_plain_version_reads(S, case):
    """For every tile of ``WARP_TILE_ROWS`` output rows: (1) every pass-1
    row that pass 2 taps for those rows, through the pass-3 columns they
    tap, lies in ``warp_source_band`` (the kernel stages that band and reads
    nothing outside it); (2) ``fused_warp_normalize_ref`` gives the tile's
    rows bit for bit when every source row outside the band is replaced by
    other bytes. At the weak range the band stays within the tile plus the
    sine of 10° of the side and two rows."""
    rng = np.random.RandomState(S + len(case))
    params = _band_params(S, case, rng)
    n = params.shape[0]
    flip = torch.tensor([False, True, False])
    imgs = torch.from_numpy(rng.randint(0, 256, (n, S, S, 3), np.uint8))
    want = W.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD)

    def shear(q, at):  # the kernel's k for pass params q [n, 3] at positions at
        s = q[:, 0:1] * (at[None, :] - q[:, 2:3]) + q[:, 1:2]
        return torch.floor(s).clamp(-(S + 1), S + 1).long()

    line = torch.arange(S, dtype=torch.float32)
    k2, k3 = shear(params[:, 1], line), shear(params[:, 2], line)
    tiles = [(r0, min(S, r0 + W.WARP_TILE_ROWS)) for r0 in range(0, S, W.WARP_TILE_ROWS)]
    masked, rows_of = [], []
    for r0, r1 in tiles:
        lo, hi = W.warp_source_band(params, S, r0, r1)
        if case == "weak":
            spread = math.ceil(math.sin(math.radians(10.0)) * (S - 1))
            assert int((hi - lo).max()) + 1 <= W.WARP_TILE_ROWS + spread + 2
        for i in range(n):
            # (1) the rows the taps reach: pass-3 columns j of rows y, then
            # pass-1 rows y + k2[j] and y + k2[j] + 1 inside the plane
            ys = torch.arange(r0, r1)
            js = torch.arange(S)[None, :] + k3[i, ys][:, None]
            js = torch.cat([js, js + 1], 1)
            inside = (js >= 0) & (js < S)
            tapped = ys[:, None] + k2[i, js.clamp(0, S - 1)]
            tapped = torch.cat([tapped[inside], tapped[inside] + 1])
            tapped = tapped[(tapped >= 0) & (tapped < S)]
            if tapped.numel():
                assert int(tapped.min()) >= int(lo[i]) and int(tapped.max()) <= int(hi[i])
            # (2) other bytes outside the band
            out = torch.ones(S, dtype=torch.bool)
            out[max(int(lo[i]), 0):int(hi[i]) + 1] = False
            img = imgs[i].clone()
            img[out] = torch.from_numpy(rng.randint(0, 256, (int(out.sum()), S, 3), np.uint8))
            masked.append(img)
            rows_of.append((i, r0, r1))
    got = W.fused_warp_normalize_ref(
        torch.stack(masked), params.repeat(len(tiles), 1, 1),
        flip.repeat(len(tiles)), MEAN, STD)
    for t, (i, r0, r1) in enumerate(rows_of):
        assert torch.equal(got[t, :, r0:r1], want[i, :, r0:r1]), (i, r0)
