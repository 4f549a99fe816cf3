"""The port's per-row shift (``hshift_rows``, fedmlp_tpu_torch/ops/warp.py)
and what is built from it, against the JAX package's ``hshift_rows_pallas``
(in interpret mode, as tests/test_pallas_warp.py runs it on the CPU) and its
jnp reference ``hshift_rows_jnp``. The same numpy planes and shifts go to
both. On the CPU the wrapper takes its plain version; the CUDA kernel is held
against that plain version on the card (tests/test_torch_kernels_cuda.py).

The JAX functions are right only for |shift| < 64 (the reference clamps
beyond its pad), so comparisons stay below that; beyond it the port is held
to the definition (zero fill).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.ops import pallas_warp as PW
from fedmlp_tpu_torch.ops import augment as A
from fedmlp_tpu_torch.ops import warp as W
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _planes(B, C, H, Wd, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 255, (B, C, H, Wd)).astype(np.float32)


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("B,C,H,Wd,span", [(3, 3, 32, 32, 12.0), (2, 1, 24, 40, 30.0),
                                           (2, 3, 16, 70, 63.0)])
def test_hshift_rows_matches_jax(which, B, C, H, Wd, span):
    """Horizontal pass, fractional shifts in (−span, span), |s| < 64. atol
    1e-4 on the 0..255 scale: the same two-tap lerp; the compilers may
    contract (1−w)·lo + w·hi into an FMA on one side."""
    x = _planes(B, C, H, Wd, 1)
    shifts = np.random.RandomState(2).uniform(-span, span, (B, H)).astype(np.float32)
    fn = ((lambda p, s: PW.hshift_rows_pallas(p, s, interpret=True))
          if which == "pallas" else PW.hshift_rows_jnp)
    want = np.stack([np.asarray(fn(jnp.asarray(x[b]), jnp.asarray(shifts[b])))
                     for b in range(B)])
    W.reset_launch_counts()
    got = W.hshift_rows(torch.from_numpy(x), torch.from_numpy(shifts))
    assert W.LAUNCH_COUNTS["hshift_rows"] == 0  # a CPU tensor: the plain version
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_hshift_rows_vertical_axis_matches_jax_under_a_transpose():
    """axis=2 shifts columns by shifts [B, W]: the JAX package's vertical
    pass, which runs the horizontal kernel on a transposed copy."""
    B, C, H, Wd = 2, 3, 20, 28
    x = _planes(B, C, H, Wd, 3)
    shifts = np.random.RandomState(4).uniform(-9, 9, (B, Wd)).astype(np.float32)
    want = np.stack([np.asarray(jnp.swapaxes(PW.hshift_rows_jnp(
        jnp.swapaxes(jnp.asarray(x[b]), 1, 2), jnp.asarray(shifts[b])), 1, 2))
        for b in range(B)])
    got = W.hshift_rows(torch.from_numpy(x), torch.from_numpy(shifts), axis=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("axis", [3, 2])
def test_integer_shift_is_an_exact_copy_and_a_far_shift_gives_zeros(axis):
    """As tests/test_pallas_warp.py holds the TPU kernel: an integer shift
    copies bit for bit (w = 0). Beyond the plane everything is zero fill,
    for any magnitude (the TPU kernel's margin ends near 96)."""
    B, C, H, Wd = 2, 3, 12, 17
    x = torch.from_numpy(_planes(B, C, H, Wd, 5))
    n = H if axis == 3 else Wd      # lines
    length = Wd if axis == 3 else H  # elements along the shifted axis
    shifts = torch.zeros((B, n))
    shifts[0, :] = 3.0
    shifts[1, :] = -2.0
    got = W.hshift_rows(x, shifts, axis=axis)
    xs = x if axis == 3 else x.transpose(2, 3)
    gs = got if axis == 3 else got.transpose(2, 3)
    assert torch.equal(gs[0, :, :, :length - 3], xs[0, :, :, 3:])
    assert torch.equal(gs[0, :, :, length - 3:], torch.zeros_like(gs[0, :, :, length - 3:]))
    assert torch.equal(gs[1, :, :, 2:], xs[1, :, :, :length - 2])
    assert torch.equal(gs[1, :, :, :2], torch.zeros_like(gs[1, :, :, :2]))
    assert torch.equal(W.hshift_rows(x, torch.zeros((B, n)), axis=axis), x)
    for far in (float(length), -float(length) - 0.5, 1e9, -3e9):
        out = W.hshift_rows(x, torch.full((B, n), far), axis=axis)
        assert torch.equal(out, torch.zeros_like(x)), far


def test_paeth_shift_vectors_match_jax():
    """rtol 1e-5: the same f32 expressions, sin/cos/tan from two libraries."""
    rng = np.random.RandomState(0)
    theta = np.deg2rad(rng.uniform(-30, 30, 8)).astype(np.float32)
    tx = rng.uniform(-4, 4, 8).astype(np.float32)
    ty = rng.uniform(-4, 4, 8).astype(np.float32)
    got = W.paeth_shift_vectors(torch.from_numpy(theta), torch.from_numpy(tx),
                                torch.from_numpy(ty), 24, 40)
    assert [tuple(g.shape) for g in got] == [(8, 24), (8, 40), (8, 24)]
    for b in range(8):
        want = PW.paeth_shift_vectors(jnp.float32(theta[b]), jnp.float32(tx[b]),
                                      jnp.float32(ty[b]), 24, 40)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _weak_draws(B, S, seed):
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-10, 10, B).astype(np.float32)
    tx = (rng.uniform(-.02, .02, B) * S).astype(np.float32)
    ty = (rng.uniform(-.02, .02, B) * S).astype(np.float32)
    ang[0] = tx[0] = ty[0] = 0.0  # the identity
    tx[1], ty[1], ang[1] = 2.0, -1.0, 0.0  # an integer translation
    return ang, tx, ty


def test_paeth_affine_matches_jax():
    """Three passes with given (θ, tx, ty), against ``paeth_affine`` on the
    jnp reference and, for one image, through the Pallas kernel in interpret
    mode. atol 2e-3 on the 0..255 scale: the shift vectors come from each
    library's sin and tan, an ulp of which moves a shift by ~1e-6 px and the
    lerp by that times the local gradient (up to 255 a pixel)."""
    B, S = 4, 32
    x = _planes(B, 3, S, S, 6)
    ang, tx, ty = _weak_draws(B, S, 7)
    got = W.paeth_affine(torch.from_numpy(x), torch.deg2rad(torch.from_numpy(ang)),
                         torch.from_numpy(tx), torch.from_numpy(ty)).numpy()
    for b in range(B):
        want = PW.paeth_affine(jnp.asarray(x[b]), jnp.deg2rad(jnp.float32(ang[b])),
                               jnp.float32(tx[b]), jnp.float32(ty[b]),
                               use_pallas=(b == 2))
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got[0], x[0])  # identity: exact
    # integer translation (2, −1): out[y, x] = in[y + 1, x − 2], exact
    np.testing.assert_array_equal(got[1][:, :-1, 2:], x[1][:, 1:, :-2])


def _jax_weak_keys_and_draws(B, S, seed):
    """keys [B, 2, 2] and the draws that ``weak_augment_batch_paeth`` and
    ``weak_augment_batch`` make from them (pallas_warp.py:421-429)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * B).reshape(B, 2, 2)
    ang, tx, ty, flip = [], [], [], []
    for b in range(B):
        ka, kb, kc = jax.random.split(keys[b, 0], 3)
        ang.append(jax.random.uniform(ka, (), minval=-10.0, maxval=10.0))
        tx.append(jax.random.uniform(kb, (), minval=-0.02, maxval=0.02) * S)
        ty.append(jax.random.uniform(kc, (), minval=-0.02, maxval=0.02) * S)
        flip.append(jax.random.bernoulli(keys[b, 1], 0.5))
    f32 = lambda v: torch.from_numpy(np.array(jnp.stack(v), np.float32))  # noqa: E731
    return keys, f32(ang), f32(tx), f32(ty), torch.from_numpy(np.array(jnp.stack(flip)))


@pytest.mark.parametrize("backend", ["paeth", "gather"])
def test_weak_backends_match_jax_on_the_same_draws(backend):
    """``weak_augment_batch_paeth`` (the 'pallas'/'paeth' backends) and
    ``weak_augment_batch`` ('gather') with draws rebuilt from the JAX keys.
    atol 1e-4 on the normalized scale (2e-3·/58 plus the division), the
    tolerance of tests/test_torch_warp.py."""
    B, S = 6, 32
    imgs = np.random.RandomState(8).randint(0, 256, (B, S, S, 3), np.uint8)
    keys, ang, tx, ty, flip = _jax_weak_keys_and_draws(B, S, 11)
    assert flip.any() and not flip.all()
    if backend == "paeth":
        want = PW.weak_augment_batch_paeth(jnp.asarray(imgs), None, MEAN, STD,
                                           use_pallas=False, keys=keys)
        got = W.weak_augment_batch_paeth_from_params(torch.from_numpy(imgs), ang, tx,
                                                     ty, flip, MEAN, STD)
    else:
        from fedmlp_tpu.ops import augment as JA

        want = JA.weak_augment_batch(jnp.asarray(imgs), None, MEAN, STD, keys=keys)
        got = A.weak_augment_batch_from_params(torch.from_numpy(imgs), ang, tx, ty,
                                               flip, MEAN, STD)
    assert got.shape == (B, 3, S, S)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["auto", "fused", "pallas", "paeth", "gather",
                                     "normonly"])
def test_every_weak_backend_name_gives_a_view(backend):
    imgs = torch.from_numpy(
        np.random.RandomState(9).randint(0, 256, (3, 16, 16, 3), np.uint8))
    weak = A.pick_weak_backend(backend)
    out = weak(imgs, torch.Generator().manual_seed(0), MEAN, STD)
    assert out.shape == (3, 3, 16, 16) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    if backend == "normonly":
        assert torch.equal(out, A.eval_batch(imgs, MEAN, STD))
    if backend in ("pallas", "paeth"):
        # the two names are one function, so equal draws give equal views
        other = A.pick_weak_backend("paeth" if backend == "pallas" else "pallas")
        assert torch.equal(out, other(imgs, torch.Generator().manual_seed(0), MEAN, STD))


def test_unknown_backend_and_bad_inputs_raise():
    with pytest.raises(ValueError, match="not ported"):
        A.pick_weak_backend("bilinear")
    x = torch.zeros((2, 3, 8, 8))
    with pytest.raises(ValueError, match="shifts must be f32"):
        W.hshift_rows(x, torch.zeros((2, 7)))
    with pytest.raises(ValueError, match="shifts must be f32"):
        W.hshift_rows(x, torch.zeros((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="axis"):
        W.hshift_rows(x, torch.zeros((2, 8)), axis=1)
    with pytest.raises(ValueError, match="x must be f32"):
        W.hshift_rows(x.to(torch.float64), torch.zeros((2, 8)))
