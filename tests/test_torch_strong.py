"""The port's strong view (fedmlp_tpu_torch/ops/augment.py) against the JAX
package's: each photometric op, the pool's geometric ops through the shear
passes and through the bilinear gather, and ``strong_augment_batch`` on draws
rebuilt from JAX keys exactly as fedmlp_tpu/ops/augment.py consumes them.

The port works on batches [B, 3, H, W] with per-image parameters [B]; the JAX
functions take one [H, W, 3] image and are mapped here. Images are float32 in
0..255. Tolerances, on that scale: integer-exact ops bitwise; lerps and
blends 1e-4; sharpness 1e-3 (the convolution sums its nine taps in another
order); a warp whose shifts come from each library's own sin/cos/tan 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.ops import augment as JA
from fedmlp_tpu_torch.ops import augment as TA
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
S = 32


def _images(B, seed, fractional=True):
    """[B, S, S, 3] f32 in 0..255; image 1 has a constant channel (equalize's
    step == 0 and autocontrast's hi == lo branches)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, S, S, 3)).astype(np.float32)
    if fractional:
        x = np.clip(x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32), 0, 255)
    x[1, :, :, 2] = 77.0
    return x.astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


V = np.array([0.14, 0.5, 0.86, 1.7], np.float32)  # blend factors

_PHOTOMETRIC = {
    # name: (jax per-image fn, port batch fn, per-image parameter or None, atol)
    "brightness": (JA.brightness, TA.brightness, V, 1e-4),
    "color": (JA.color, TA.color, V, 1e-4),
    "contrast": (JA.contrast, TA.contrast, V, 1e-4),
    "sharpness": (JA.sharpness, TA.sharpness, V, 1e-3),
    "posterize": (JA.posterize, TA.posterize, np.array([4, 5, 6, 7], np.int32), 0),
    "solarize": (JA.solarize, TA.solarize,
                 np.array([256.0, 231.0, 128.0, 26.0], np.float32), 0),
    "invert": (JA.invert, TA.invert, None, 0),
    "autocontrast": (JA.autocontrast, TA.autocontrast, None, 1e-4),
    "equalize": (JA.equalize, TA.equalize, None, 0),
    "solarize_add": (JA.solarize_add, TA.solarize_add,
                     np.array([-99.0, -11.0, 22.0, 110.0], np.float32), 1e-4),
}


@pytest.mark.parametrize("name", sorted(_PHOTOMETRIC))
def test_photometric_op_matches_jax(name):
    jfn, tfn, param, atol = _PHOTOMETRIC[name]
    x = _images(4, seed=len(name))
    if param is None:
        want = np.stack([np.asarray(jfn(jnp.asarray(x[b]))) for b in range(4)])
        got = tfn(_nchw(x))
    else:
        want = np.stack([np.asarray(jfn(jnp.asarray(x[b]), jnp.asarray(param[b])))
                         for b in range(4)])
        got = tfn(_nchw(x), torch.from_numpy(param))
    assert got.shape == (4, 3, S, S) and got.dtype == torch.float32
    if atol == 0:
        np.testing.assert_array_equal(_nhwc(got), want)
    else:
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=atol)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0


def test_cutout_abs_matches_jax_on_the_same_center_draws():
    """The box from the key's two uniform draws (augment.py:245-251),
    bitwise; one center sits at the border so the box is cut."""
    x = _images(4, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    cx, cy = [], []
    for k in keys:
        kx, ky = jax.random.split(k)
        cx.append(float(jax.random.uniform(kx, (), minval=0.0, maxval=S)))
        cy.append(float(jax.random.uniform(ky, (), minval=0.0, maxval=S)))
    want = np.stack([np.asarray(JA.cutout_abs(jnp.asarray(x[b]), keys[b], 16))
                     for b in range(4)])
    got = TA.cutout_abs(_nchw(x), torch.tensor(cx), torch.tensor(cy), 16)
    np.testing.assert_array_equal(_nhwc(got), want)
    assert (want == 127.0).any()
    edge = TA.cutout_abs(_nchw(x), torch.full((4,), S - 0.5), torch.full((4,), 0.2), 16)
    assert (edge[:, :, :8, S - 9:] == 127.0).all() and (edge[:, :, 8:] != 127.0).any()


def _sign_keys(n, seed):
    """n keys and the sign that ``_rand_sign(key, ·)`` draws from each (the
    SAME key signs the angle, the shear and both translations)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    neg = np.array([bool(jax.random.bernoulli(k, 0.5)) for k in keys])
    return keys, neg


@pytest.mark.parametrize("geo", ["shear", "gather"])
def test_pool_geometric_ops_match_jax_per_slot(geo):
    """Every slot (rotate, shear_x, shear_y, translate_x, translate_y,
    identity) at two magnitudes and both signs. 'shear': ``_geo_shear_warp``
    against the JAX one on its jnp reference; 'gather': the selected
    ``_geo_matrices`` through ``affine_warp``. The rotate slot gets 2e-3 (its
    shifts or matrix come from each library's trigonometry), the others
    1e-4; translate and identity are exact copies."""
    slots = np.repeat(np.arange(6), 2)
    v = np.tile(np.array([3.0, 9.0], np.float32), 6)
    B = len(slots)
    keys, neg = _sign_keys(B, 7)
    assert neg.any() and not neg.all()
    x = _images(B, seed=11)
    want = []
    for b in range(B):
        img = jnp.asarray(x[b])
        if geo == "shear":
            want.append(JA._geo_shear_warp(img, int(slots[b]), keys[b], jnp.float32(v[b]),
                                           0.3, use_pallas=False))
        else:
            mats = JA._geo_matrices(img.shape, keys[b], jnp.float32(v[b]), 0.3)
            want.append(JA.affine_warp(img, mats[int(slots[b])]))
    want = np.stack([np.asarray(w) for w in want])
    tx, gi = _nchw(x), torch.from_numpy(slots)
    tneg, tv = torch.from_numpy(neg), torch.from_numpy(v)
    if geo == "shear":
        got = TA._geo_shear_warp(tx, gi, tneg, tv, 0.3)
    else:
        got = TA.affine_warp(tx, TA._select_slot(TA._geo_matrices(S, S, tneg, tv, 0.3), gi))
    got = _nhwc(got)
    for b in range(B):
        atol = 2e-3 if slots[b] == 0 else 1e-4
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=atol, err_msg=f"image {b}")
    np.testing.assert_array_equal(got[slots == 5], x[slots == 5])
    # translate_x by −⌊9·0.3/10·32⌋ = −8 or +8 px: an exact copy, shifted
    b = int(np.where((slots == 3) & (v == 9.0))[0][0])
    if neg[b]:
        np.testing.assert_array_equal(got[b][:, 8:], x[b][:, :-8])
    else:
        np.testing.assert_array_equal(got[b][:, :-8], x[b][:, 8:])


def _jax_strong_draws(keys, n=2, m=10):
    """The draws ``strong_augment_batch`` makes from keys [B, 3, 2]
    (augment.py:112-122 random_affine, :125-127 flip, :384-394 the layers,
    :340-355 the op's sign, :241-251 the cutout center), as the port's
    ``strong_params`` dictionary."""
    B = keys.shape[0]
    out = {k: [] for k in ("ang", "tx", "ty", "flip", "cut_x", "cut_y")}
    layers = {k: [[] for _ in range(n)] for k in ("op_idx", "v_int", "do", "neg")}
    for b in range(B):
        k1, k2, k3 = jax.random.split(keys[b, 0], 3)
        out["ang"].append(jax.random.uniform(k1, (), minval=-10.0, maxval=10.0))
        out["tx"].append(jax.random.uniform(k2, (), minval=-0.02, maxval=0.02) * S)
        out["ty"].append(jax.random.uniform(k3, (), minval=-0.02, maxval=0.02) * S)
        out["flip"].append(jax.random.bernoulli(keys[b, 1], 0.5))
        lk = jax.random.split(keys[b, 2], n + 1)
        for i in range(n):
            kop, kv, kp, kapply = jax.random.split(lk[i], 4)
            layers["op_idx"][i].append(jax.random.randint(kop, (), 0, 14))
            layers["v_int"][i].append(jax.random.randint(kv, (), 1, m))
            layers["do"][i].append(jax.random.bernoulli(kp, 0.5))
            ks, _ = jax.random.split(kapply)
            layers["neg"][i].append(jax.random.bernoulli(ks, 0.5))
        kx, ky = jax.random.split(lk[n])
        out["cut_x"].append(jax.random.uniform(kx, (), minval=0.0, maxval=S))
        out["cut_y"].append(jax.random.uniform(ky, (), minval=0.0, maxval=S))
    params = {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}
    for k, v in layers.items():
        t = torch.from_numpy(np.array(jnp.stack([jnp.stack(r) for r in v])))
        params[k] = t.long() if k in ("op_idx", "v_int") else t
    return params


# ops that quantize or threshold their input: equalize, posterize, solarize
_QUANTIZING = (4, 6, 11)


@pytest.mark.parametrize("geo", ["shear", "gather"])
def test_strong_augment_batch_matches_jax_on_draws_rebuilt_from_its_keys(geo):
    """The whole strong view, normalized NCHW against JAX's NHWC. The same
    numbers drive both sides: the JAX side gets ``keys``, the port the draws
    rebuilt from them. Tolerance 1e-4 on the normalized scale (2e-3 / (255 ·
    0.22) for the trigonometry, 1e-3 / 57 for sharpness). An image whose
    layers include a quantizing op (equalize, posterize, solarize) after the
    prefix warp may differ by whole gray levels where a lerp lands within an
    ulp of a rounding boundary: there at most 0.5% of its pixels may exceed
    the tolerance."""
    B = 24
    imgs = np.random.RandomState(13).randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(17), 3 * B).reshape(B, 3, 2)
    params = _jax_strong_draws(keys)
    applied = params["op_idx"][params["do"]]
    assert len(set(applied.tolist())) >= 9  # the draws reach most of the pool
    assert int(params["v_int"].min()) >= 1 and int(params["v_int"].max()) <= 9
    want = np.asarray(jax.jit(lambda im, k: JA.strong_augment_batch(
        im, None, MEAN, STD, keys=k, geo=geo))(jnp.asarray(imgs), keys))
    got = TA.strong_augment_batch_from_params(torch.from_numpy(imgs), params, MEAN, STD,
                                              geo=geo)
    assert got.shape == (B, 3, S, S) and got.dtype == torch.float32
    err = np.abs(_nhwc(got) - want)
    n_loose = 0
    for b in range(B):
        quant = any(bool(params["do"][i, b]) and int(params["op_idx"][i, b]) in _QUANTIZING
                    for i in range(2))
        bad = float((err[b] > 1e-4).mean())
        if quant:
            n_loose += 1
            assert bad <= 0.005, (b, bad)
        else:
            assert bad == 0.0, (b, bad, float(err[b].max()))
    assert n_loose < B // 2


def test_strong_params_distributions_and_shapes():
    g = torch.Generator().manual_seed(0)
    n, B = 2, 6000
    p = TA.strong_params(B, 48, 64, g, "cpu", n=n, m=10)
    assert p["op_idx"].shape == p["v_int"].shape == p["do"].shape == p["neg"].shape == (n, B)
    assert sorted(p["op_idx"].unique().tolist()) == list(range(14))
    assert sorted(p["v_int"].unique().tolist()) == list(range(1, 10))  # m excluded
    for k in ("do", "neg", "flip"):
        assert abs(float(p[k].float().mean()) - 0.5) < 0.03, k  # ~4 sd of 6000 draws
    assert 0.0 <= float(p["cut_x"].min()) and float(p["cut_x"].max()) < 64.0
    assert 0.0 <= float(p["cut_y"].min()) and float(p["cut_y"].max()) < 48.0
    assert float(p["ang"].abs().max()) <= 10.0


@pytest.mark.parametrize("backend,launches", [("auto", "shear"), ("fused", "shear"),
                                              ("pallas", "shear"), ("paeth", "gather"),
                                              ("gather", "gather"), ("normonly", None)])
def test_pick_strong_backend(backend, launches, monkeypatch):
    """'pallas', 'fused' and 'auto' run every warp through ``hshift_rows``
    (9 passes a batch: 3 for the prefix, 3 for each of the 2 layers); 'paeth'
    and 'gather' use no shear pass; 'normonly' is the test transform."""
    from fedmlp_tpu_torch.ops import warp as W

    calls = []
    real = W.hshift_rows
    monkeypatch.setattr(TA, "hshift_rows", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(W, "hshift_rows", lambda *a, **k: calls.append(1) or real(*a, **k))
    imgs = torch.from_numpy(
        np.random.RandomState(1).randint(0, 256, (3, 16, 16, 3)).astype(np.uint8))
    strong = TA.pick_strong_backend(backend)
    out = strong(imgs, torch.Generator().manual_seed(3), MEAN, STD)
    assert out.shape == (3, 3, 16, 16) and torch.isfinite(out).all()
    assert len(calls) == {"shear": 9, "gather": 0, None: 0}[launches]
    if backend == "normonly":
        assert torch.equal(out, TA.eval_batch(imgs, MEAN, STD))
