"""Views made before the step, against the JAX package: RandAugmentPC and
``augment_pair`` on draws rebuilt from JAX keys, ``pre_augment_views``'s
chunk invariance, the hoist (``hoist_augment``) against ``pre_augment`` in
the ``Trainer``, the hoist's size rule, the engine on given views against
JAX's ``make_local_round``, FedMLP's one-forward stage-1 loss
(``loss_fn_viewcat``), and FedMLP with ``pre_augment`` and ``view_concat``
against the JAX ``Trainer``.

Float32 on the CPU at 16-32 px; ``smallcnn`` where a model trains, its JAX
initial weights copied into the port through fedmlp_tpu_torch/weights.py.
Tolerances are on the scale each test names (0..255 pixels, normalized
views, losses, variables) and stated per test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import fedmlp as jfedmlp
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.data import masking as JM
from fedmlp_tpu.models import build_model as jbuild
from fedmlp_tpu.ops import augment as JA
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.algos.base import apply_train
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData, FedMLPConfig as TFed
from fedmlp_tpu_torch.data.datasets import make_synthetic_dataset
from fedmlp_tpu_torch.models import build_model as tbuild
from fedmlp_tpu_torch.ops import augment as TA
from fedmlp_tpu_torch.parallel import fl_runtime as trt
from fedmlp_tpu_torch.parallel.mesh import Place
from fedmlp_tpu_torch.train import Trainer as TTrainer, UnportedConfigError
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from test_torch_strong import _QUANTIZING, _jax_strong_draws
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
C = 4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _images(B, H, W, seed):
    """[B, H, W, 3] f32 in 0..255 with fractional values; image 1 has a
    constant channel (equalize's step == 0, autocontrast's hi == lo)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    x = np.clip(x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32), 0, 255)
    x[1, :, :, 2] = 77.0
    return x.astype(np.float32)


# ----------------------------------------------------------------------
# RandAugmentPC
# ----------------------------------------------------------------------

def _pc_op_draws(key, H, W):
    """The draws ``_randaugment_pc_op`` makes from its key
    (fedmlp_tpu/ops/augment.py:407-433): the op's one sign (bernoulli of
    ks; it signs the geometric ops and SolarizeAdd) and the Cutout op's
    center (the two uniforms of split(ks))."""
    ks, _ = jax.random.split(key)
    kx, ky = jax.random.split(ks)
    return (bool(jax.random.bernoulli(ks, 0.5)),
            float(jax.random.uniform(kx, (), minval=0.0, maxval=W)),
            float(jax.random.uniform(ky, (), minval=0.0, maxval=H)))


# op → atol on the 0..255 scale: integer-exact ops and translations
# bitwise; blends 1e-4; sharpness 1e-3 (the filter sums in another order);
# shears 1e-3 (a source coordinate up to ~10 px, rounded apart by an ulp,
# 1e-6 px, times a gradient of up to 255 a pixel); rotate 2e-3 (each side's
# cos and sin)
_PC_ATOL = {0: 1e-4, 1: 1e-4, 2: 1e-4, 3: 1e-4, 4: 0, 5: 0, 6: 0, 7: 0, 8: 2e-3,
            9: 1e-3, 10: 1e-3, 11: 1e-3, 12: 0, 13: 0, 14: 0, 15: 0}


@functools.lru_cache(maxsize=None)
def _jax_pc_op():
    """JAX's op on a batch, the op index traced: one compile for all 16."""
    return jax.jit(jax.vmap(lambda im, op, k: JA._randaugment_pc_op(im, op, 10, k),
                            in_axes=(0, None, 0)))


@pytest.mark.parametrize("op", range(16))
def test_randaugment_pc_op_matches_jax(op):
    """Each of the 16 ops of my_augment_pool at m=10 on 6 images of 16x32
    px (H ≠ W catches a swapped axis), both signs among them, the draws
    taken from the JAX keys; the tolerance of ``_PC_ATOL``."""
    H, W, B = 16, 32, 6
    x = _images(B, H, W, seed=op)
    keys = jax.random.split(jax.random.PRNGKey(100 + op), B)
    draws = [_pc_op_draws(k, H, W) for k in keys]
    want = np.asarray(_jax_pc_op()(jnp.asarray(x), jnp.int32(op), keys))
    neg, cx, cy = (torch.tensor(v) for v in zip(*draws))
    got = TA.randaugment_pc_op(_nchw(x), torch.full((B,), op), neg, cx, cy, 10)
    assert got.shape == (B, 3, H, W) and got.dtype == torch.float32
    if _PC_ATOL[op] == 0:
        np.testing.assert_array_equal(_nhwc(got), want)
    else:
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=_PC_ATOL[op])
    if op in (8, 10, 11, 13, 14, 15):  # signed ops: both signs were drawn
        assert neg.any() and not neg.all()
    assert not np.array_equal(want, x)  # at m=10 every op changes the images


def _jax_pc_draws(keys, H, W, n=2):
    """The draws ``randaugment_pc`` makes from keys [B, 2]
    (fedmlp_tpu/ops/augment.py:439-452), as ``randaugment_pc_params``'
    dictionary."""
    out = {k: [[] for _ in range(n)] for k in ("op_idx", "do", "neg", "op_cut_x",
                                               "op_cut_y")}
    cut_x, cut_y = [], []
    for key in keys:
        lk = jax.random.split(key, n + 1)
        for i in range(n):
            kop, kprob, kp, kapply = jax.random.split(lk[i], 4)
            prob = jax.random.uniform(kprob, (), minval=0.2, maxval=0.8)
            out["op_idx"][i].append(int(jax.random.randint(kop, (), 0, 16)))
            out["do"][i].append(bool(jax.random.uniform(kp) + prob >= 1.0))
            neg, ocx, ocy = _pc_op_draws(kapply, H, W)
            out["neg"][i].append(neg)
            out["op_cut_x"][i].append(ocx)
            out["op_cut_y"][i].append(ocy)
        kx, ky = jax.random.split(lk[n])
        cut_x.append(float(jax.random.uniform(kx, (), minval=0.0, maxval=W)))
        cut_y.append(float(jax.random.uniform(ky, (), minval=0.0, maxval=H)))
    params = {k: torch.tensor(v) for k, v in out.items()}
    params["cut_x"], params["cut_y"] = torch.tensor(cut_x), torch.tensor(cut_y)
    return params


def test_randaugment_pc_matches_jax_on_draws_rebuilt_from_its_keys():
    """Two layers and the final cutout on 24 images of 16x32 px. The same
    numbers drive both sides. atol 2e-3 on the 0..255 scale (a rotation's
    cos and sin); an image that runs a quantizing op (equalize, posterize,
    solarize, solarize_add) after a rotation may differ by whole gray levels
    where the warp lands within an ulp of a rounding boundary: there at most
    0.5% of its pixels may exceed the tolerance."""
    H, W, B = 16, 32, 24
    x = _images(B, H, W, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(23), B)
    params = _jax_pc_draws(keys, H, W)
    applied = params["op_idx"][params["do"]]
    assert len(set(applied.tolist())) >= 10
    want = np.asarray(jax.jit(jax.vmap(JA.randaugment_pc))(jnp.asarray(x), keys))
    got = _nhwc(TA.randaugment_pc_from_params(_nchw(x), params))
    err = np.abs(got - want)
    for b in range(B):
        ops = [int(params["op_idx"][i, b]) for i in range(2) if params["do"][i, b]]
        loose = 8 in ops and any(o in (5, 7, 12, 13) for o in ops[ops.index(8) + 1:])
        bad = float((err[b] > 2e-3).mean())
        assert bad <= (0.005 if loose else 0.0), (b, ops, bad)
    g = torch.Generator().manual_seed(0)
    p = TA.randaugment_pc_params(6000, 16, 32, g, "cpu")
    assert p["op_idx"].min() == 0 and p["op_idx"].max() == 15
    # P(U + U(0.2, 0.8) >= 1) = 1/2
    assert abs(float(p["do"].float().mean()) - 0.5) < 0.02
    assert float(p["op_cut_x"].max()) < 32 and float(p["op_cut_y"].max()) < 16
    out = TA.randaugment_pc(_nchw(x), torch.Generator().manual_seed(1))
    assert out.shape == (B, 3, H, W) and float(out.min()) >= 0 and float(out.max()) <= 255


# ----------------------------------------------------------------------
# augment_pair
# ----------------------------------------------------------------------

def _jax_weak_draws(keys, H, W):
    """The draws ``weak_augment_batch`` makes from keys [B, 2, 2]
    (fedmlp_tpu/ops/augment.py:112-127), as ``weak_draws``' dictionary."""
    out = {k: [] for k in ("ang", "tx", "ty", "flip")}
    for ks in keys:
        k1, k2, k3 = jax.random.split(ks[0], 3)
        out["ang"].append(float(jax.random.uniform(k1, (), minval=-10.0, maxval=10.0)))
        out["tx"].append(float(jax.random.uniform(k2, (), minval=-0.02, maxval=0.02) * W))
        out["ty"].append(float(jax.random.uniform(k3, (), minval=-0.02, maxval=0.02) * H))
        out["flip"].append(bool(jax.random.bernoulli(ks[1], 0.5)))
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", ["dual_weak", "weak_strong"])
def test_augment_pair_matches_jax(mode):
    """Both views of 16 images at 32 px, normalized, on the draws of JAX's
    key. The weak views within 1e-4; the strong view (bilinear warps) within
    1e-4 except that an image with a quantizing op may differ by whole gray
    levels on at most 0.5% of its pixels (tests/test_torch_strong.py)."""
    B, S = 16, 32
    imgs = np.random.RandomState(5).randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(31)
    w1, w2 = JA.augment_pair(jnp.asarray(imgs), key, MEAN, STD, mode=mode)
    k1, k2 = jax.random.split(key)
    p1 = _jax_weak_draws(jax.random.split(k1, 2 * B).reshape(B, 2, 2), S, S)
    if mode == "dual_weak":
        p2 = _jax_weak_draws(jax.random.split(k2, 2 * B).reshape(B, 2, 2), S, S)
    else:
        p2 = _jax_strong_draws(jax.random.split(k2, 3 * B).reshape(B, 3, 2))
    g1, g2 = TA.augment_pair_from_params(torch.from_numpy(imgs), p1, p2, MEAN, STD, mode)
    assert g1.shape == g2.shape == (B, 3, S, S)
    np.testing.assert_allclose(_nhwc(g1), np.asarray(w1), rtol=0, atol=1e-4)
    err = np.abs(_nhwc(g2) - np.asarray(w2))
    for b in range(B):
        quant = mode == "weak_strong" and any(
            bool(p2["do"][i, b]) and int(p2["op_idx"][i, b]) in _QUANTIZING for i in range(2))
        assert float((err[b] > 1e-4).mean()) <= (0.005 if quant else 0.0), b
    # drawn: the first view's draws, then the second's; no kernel
    a1, a2 = TA.augment_pair(torch.from_numpy(imgs), torch.Generator().manual_seed(2),
                             MEAN, STD, mode)
    g = torch.Generator().manual_seed(2)
    q1 = TA.weak_draws(B, S, S, g, "cpu")
    q2 = (TA.weak_draws if mode == "dual_weak" else TA.strong_params)(B, S, S, g, "cpu")
    b1, b2 = TA.augment_pair_from_params(torch.from_numpy(imgs), q1, q2, MEAN, STD, mode)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    with pytest.raises(ValueError, match="unknown augment_pair mode"):
        TA.augment_pair_from_params(torch.from_numpy(imgs), p1, p1, MEAN, STD, "triple")


# ----------------------------------------------------------------------
# pre_augment_views
# ----------------------------------------------------------------------

@pytest.mark.parametrize("view_mode,backend", [("single", "auto"), ("dual", "auto"),
                                               ("weak_strong", "auto"),
                                               ("weak_strong", "gather")])
def test_pre_augment_views_is_chunk_invariant(view_mode, backend):
    """imgs [S=2, K=3, B=4] at 16 px: chunk=5 (a ragged last chunk) and
    chunk=N from one generator state give equal bits, and so does every
    chunk size; the generator ends in the same state. The weak view is the
    backend's own function on the first draws of the stream. A block of the
    round (a mesh rank's clients and rows, an empty one included) makes
    every draw of the whole round and gets the slice of its views."""
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 3, 4, 16, 16, 3), dtype=np.uint8))
    kw = dict(view_mode=view_mode, augment_backend=backend, mean=MEAN, std=STD)
    g = torch.Generator().manual_seed(7)
    full = trt.pre_augment_views(imgs, g, chunk=24, **kw)
    after = g.get_state()
    names = ["x"] if view_mode == "single" else ["x1", "x2"]
    assert sorted(full) == names
    for chunk in (5, 7, 1000):
        g.manual_seed(7)
        small = trt.pre_augment_views(imgs, g, chunk=chunk, **kw)
        assert torch.equal(g.get_state(), after)
        for n in names:
            assert small[n].shape == (2, 3, 4, 3, 16, 16) and small[n].dtype == torch.float32
            assert torch.equal(small[n], full[n]), (chunk, n)
    for clients, rows in ((range(0, 2), slice(0, 2)), (range(2, 3), slice(2, 4)),
                          (range(3, 3), slice(0, 4))):
        g.manual_seed(7)
        part = trt.pre_augment_views(imgs[:, clients.start:clients.stop, rows], g, chunk=5,
                                     place=Place(3, clients, 4, rows), **kw)
        assert torch.equal(g.get_state(), after)
        for n in names:
            want = full[n][:, clients.start:clients.stop, rows]
            assert part[n].shape == want.shape and torch.equal(part[n], want), (clients, n)
    weak = TA.pick_weak_backend(backend)(imgs.reshape(24, 16, 16, 3),
                                         torch.Generator().manual_seed(7), MEAN, STD)
    assert torch.equal(full[names[0]].reshape(24, 3, 16, 16), weak)
    if view_mode != "single":
        assert not torch.equal(full["x1"], full["x2"])


def _fixmatch_cfg(**kw):
    return TConfig(algorithm="fixmatch", model="smallcnn", batch_size=8, base_lr=1e-3,
                   n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=5,
                   p_pos=0.5, data=TData(name="synthetic", n_classes=C, image_size=32),
                   compute_dtype="float32", output_dir="", **kw)


def test_round_with_hoist_equals_pre_augment_bitwise():
    """Two FixMatch rounds (fused weak view, shear-pass strong view, 4
    clients, S·K·B = 128 view positions): ``hoist_augment=1`` and
    ``pre_augment=48`` (chunks of 48, 48, 32) give equal client losses and
    global variables, bit for bit, as the JAX package's contract
    (tests/test_pre_augment.py:82). Views made in the step draw in another
    order, so that run differs."""
    ds = make_synthetic_dataset(128, C, 32, seed=3)
    test = make_synthetic_dataset(16, C, 32, seed=4)
    t_hoist = TTrainer(_fixmatch_cfg(hoist_augment=1, pre_augment=0), train_ds=ds,
                       test_ds=test, device="cpu")
    t_pre = TTrainer(_fixmatch_cfg(pre_augment=48), train_ds=ds, test_ds=test, device="cpu")
    t_step = TTrainer(_fixmatch_cfg(), train_ds=ds, test_ds=test, device="cpu")
    assert (t_hoist._pre_augment_chunk, t_pre._pre_augment_chunk,
            t_step._pre_augment_chunk) == (0, 48, 0)
    for r in range(2):
        h, p, s = t_hoist.run_round(r), t_pre.run_round(r), t_step.run_round(r)
        assert h.client_losses == p.client_losses
        assert h.client_losses != s.client_losses
    for n, v in t_hoist.global_vars.items():
        assert torch.equal(v, t_pre.global_vars[n]), n


def _guard_round(monkeypatch, view_mode, S, hoist, premade=False):
    """One client, B=64, S real steps on 8 px images through
    ``make_local_round`` with a loss over every view; returns (calls of
    ``pre_augment_views``, images it was given, per-step view calls)."""
    B = 64
    calls = {"pre": 0, "pre_images": 0, "step": 0}
    real_pre = trt.pre_augment_views

    def counting_pre(imgs, *a, **kw):
        calls["pre"] += 1
        calls["pre_images"] += int(np.prod(imgs.shape[:3]))
        return real_pre(imgs, *a, **kw)

    def counting_pick(backend):
        view = TA._view_fn(*TA.view_backend(backend, "weak"))

        def weak(*a):
            calls["step"] += 1
            return view(*a)
        return weak

    monkeypatch.setattr(trt, "pre_augment_views", counting_pre)
    monkeypatch.setattr(TA, "pick_weak_backend", counting_pick)

    def loss(model, views, sample, svalid, ctx, generator, scalars):
        return sum(apply_train(model, views[n])[1].mean() for n in ("x", "x1", "x2")
                   if n in views)

    n = S * B
    images = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (n, 8, 8, 3),
                                                               dtype=np.uint8))
    idx = torch.arange(n)[None]
    pos = np.arange(n, dtype=np.int32).reshape(S, 1, B)
    plan = {"pos": pos, "pos_valid": np.ones_like(pos, bool), "sample": {}}
    if premade:
        plan["views"] = real_pre(trt.gather_round_images(images, idx, pos),
                                 torch.Generator().manual_seed(1), view_mode=view_mode,
                                 augment_backend="fused", mean=MEAN, std=STD)
    model = tbuild("smallcnn", C)
    rnd = trt.make_local_round(model, loss, lr=1e-3, batch_size=B, mean=MEAN, std=STD,
                               view_mode=view_mode, augment_backend="fused",
                               hoist_augment=hoist)
    rnd({k: v.detach().clone() for k, v in model.state_dict().items()},
        {"images": images, "idx": idx, "ctx": {}}, plan, {}, torch.Generator().manual_seed(0))
    return calls


@pytest.mark.parametrize("view_mode,S,hoisted", [("single", 64, True), ("single", 65, False),
                                                 ("dual", 32, True), ("dual", 33, False)])
def test_hoist_only_up_to_4096_view_images(monkeypatch, view_mode, S, hoisted):
    """JAX's rule (fedmlp_tpu/parallel/fl_runtime.py:712-730): a round is
    hoisted only when S·K·B·n_views ≤ 4096. At 4096 one call makes every
    view and no step makes one; one image more and each step makes its own
    (one weak-view call a view a step)."""
    n_views = 1 if view_mode == "single" else 2
    calls = _guard_round(monkeypatch, view_mode, S, hoist=True)
    if hoisted:
        assert calls == {"pre": 1, "pre_images": S * 64, "step": 0}
    else:
        assert calls == {"pre": 0, "pre_images": 0, "step": S * n_views}
    assert S * 64 * n_views == (4096 if hoisted else 4096 + 64 * n_views)
    # off, every round augments in the step; a plan that brings views is
    # never hoisted again, and its steps make none
    assert _guard_round(monkeypatch, view_mode, S, hoist=False)["pre"] == 0
    assert _guard_round(monkeypatch, view_mode, 4, hoist=True, premade=True) == {
        "pre": 0, "pre_images": 0, "step": 0}


# ----------------------------------------------------------------------
# The engine on given views, the viewcat loss, the Trainer
# ----------------------------------------------------------------------

IMG, B = 32, 4


@functools.lru_cache(maxsize=None)
def _smallcnn_vars(seed=0):
    """flax's smallcnn and its initial variables, jitted, once a process
    (the tests only read them)."""
    jm = jbuild("smallcnn", C, compute_dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, v)


def test_round_on_given_views_matches_jax():
    """FedMLP's stage-1 round (two views, the frozen global model's logits
    on each) on the same pre-made f32 views, as numpy: JAX's
    ``make_local_round`` takes them as its plan's images dict, the port's
    round as ``plan['views']``. Client 0 has 9 samples (a ragged last batch
    at B=4), client 1 has 3 (one real step, then two padding steps). Per-
    client losses within rtol 1e-4, every client's variables within atol
    1e-4."""
    users = {0: list(range(9)), 1: list(range(9, 12))}
    K = len(users)
    rng = np.random.RandomState(0)
    n = 12
    images = rng.randint(0, 256, (n, IMG, IMG, 3), np.uint8)
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    hidden = JM.build_hidden_mask(targets, 0.0, np.random.RandomState(0))
    active = [[k % C] for k in range(K)]
    jfd = jrt.build_federated_data(images, targets, users, hidden, active)
    tfd = trt.build_federated_data(images, targets, users, hidden, active, device="cpu")
    act = np.asarray(jfd.active, np.float32)
    pos, pos_valid, _ = jrt.make_batch_plan(np.random.RandomState(1),
                                            np.asarray(jfd.valid), B, 1)
    S = pos.shape[0]
    views = {n: rng.randn(S, K, B, IMG, IMG, 3).astype(np.float32) for n in ("x1", "x2")}
    jm, v = _smallcnn_vars()
    kw = dict(lr=1e-3, batch_size=B, mean=MEAN, std=STD, view_mode="dual",
              needs_global=True)
    jround = jrt.make_local_round(jm, jfedmlp.loss_fn, donate=False, **kw)
    _, sample = jrt.gather_round_data(jfd.images, jfd.idx, {"labels": jfd.obs_targets},
                                      jnp.asarray(pos))
    jplan = {"images": {n: jnp.asarray(x) for n, x in views.items()}, "sample": sample,
             "pos": jnp.asarray(pos), "pos_valid": jnp.asarray(pos_valid),
             "key": jax.random.PRNGKey(0), "iter0": jnp.float32(0)}
    jout, jloss, _ = jround({"vars": jrt.broadcast_to_clients(v, K)},
                            {"ctx": {"active": jnp.asarray(act),
                                     "negative": jnp.asarray(1.0 - act)},
                             "global_vars": v}, jplan, {"rnd": jnp.float32(0)})
    tround = trt.make_local_round(tbuild("smallcnn", C), tfedmlp.loss_fn, **kw,
                                  global_model=tbuild("smallcnn", C))
    tviews = {n: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 2, 5, 3, 4)))
              for n, x in views.items()}
    tout, tloss, _ = tround(from_jax_variables(v),
                            {"images": tfd.images, "idx": tfd.idx,
                             "ctx": {"active": torch.from_numpy(act),
                                     "negative": torch.from_numpy(1.0 - act)}},
                            {"pos": pos, "pos_valid": pos_valid, "views": tviews,
                             "sample": {"labels": tfd.obs_targets}},
                            {"rnd": 0.0}, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    for k in range(K):
        want = jax.tree_util.tree_map(lambda x, k=k: np.asarray(x[k]), jout["vars"])
        got = to_jax_variables(trt.client_vars(tout["vars"], k))
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{k} {path}")


def test_loss_fn_viewcat_matches_jax():
    """One 2B forward of both views (B=4, one padding row) from the same
    smallcnn weights: the loss within rtol 1e-5, every parameter's gradient
    within 1e-5 of the largest, and the batch-norm running statistics after
    the one update within atol 1e-6. Not the same as the two-forward loss:
    the batch norm sees the joint batch."""
    jm, v = _smallcnn_vars()
    rng = np.random.RandomState(2)
    x1, x2 = (rng.randn(B, IMG, IMG, 3).astype(np.float32) for _ in range(2))
    g1, g2 = (rng.randn(B, C).astype(np.float32) for _ in range(2))
    labels = (rng.rand(B, C) > 0.5).astype(np.float32)
    svalid = np.array([True, True, True, False])
    active = np.array([1, 0, 0, 1], np.float32)
    rest = {k: val for k, val in v.items() if k != "params"}

    def jloss(p, fn):
        return fn(p, rest, jm, {"x1": x1, "x2": x2, "g_logits1": g1, "g_logits2": g2},
                  {"labels": labels}, svalid, {"active": active, "negative": 1.0 - active},
                  None, jax.random.PRNGKey(0), {})

    (want, (rest1, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jfedmlp.loss_fn_viewcat), has_aux=True))(v["params"])
    model = tbuild("smallcnn", C)
    model.load_state_dict(from_jax_variables(v))
    views = {"x1": _nchw(x1), "x2": _nchw(x2), "g_logits1": torch.from_numpy(g1),
             "g_logits2": torch.from_numpy(g2)}
    args = ({"labels": torch.from_numpy(labels)}, torch.from_numpy(svalid),
            {"active": torch.from_numpy(active), "negative": torch.from_numpy(1.0 - active)},
            None, {})
    got = tfedmlp.loss_fn_viewcat(model, views, *args)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    wgrad = from_jax_variables({"params": jgrads, **rest})
    for name, p in model.named_parameters():
        scale = float(wgrad[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), wgrad[name].numpy(), rtol=0,
                                   atol=1e-5 * max(scale, 1e-3), err_msg=name)
    stats = from_jax_variables({"params": v["params"], **rest1})
    for name, t in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(t.numpy(), stats[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
    model.load_state_dict(from_jax_variables(v))
    two = tfedmlp.loss_fn(model, views, *args)
    assert abs(float(two.detach()) - float(got.detach())) > 1e-6


def test_fedmlp_pre_augment_and_view_concat_match_jax(monkeypatch):
    """Both Trainers (K=4, smallcnn, 32 px, normalized views) with
    ``pre_augment=40`` and ``view_concat='on'``: two stage-1 rounds through
    the one-forward loss on views made before each round, the second
    harvesting prototypes and τ, then a stage-2 round, which gets the
    algorithm's two views and trains on 'x1'. Per-round client losses within
    rtol 1e-3, τ and prototypes within atol 1e-3, the tags equal (the
    tolerances and seed 7 of tests/test_torch_fedmlp_slice.py)."""
    seen = {"viewcat": 0, "stage2": []}

    def spy(name, record):
        real = getattr(tfedmlp, name)

        def fn(model, views, *a, **k):
            record(views)
            return real(model, views, *a, **k)
        monkeypatch.setattr(tfedmlp, name, fn)

    spy("loss_fn_viewcat", lambda views: seen.__setitem__("viewcat", seen["viewcat"] + 1))
    spy("stage2_loss_fn", lambda views: seen["stage2"].append(
        sorted(n for n in views if n.startswith("x"))))
    kw = dict(algorithm="fedmlp", model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=3, eval_every=100, seed=7,
              p_pos=0.0, compute_dtype="float32", output_dir="", pre_augment=40,
              view_concat="on")
    fed = dict(rounds_stage1=2, clean_threshold=0.2, noise_threshold=0.2)
    data = dict(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=96,
                synthetic_test_size=32, augment_backend="normonly")
    jt = JTrainer(JConfig(**kw, fedmlp=JFed(**fed), data=JData(**data)), use_mesh=False)
    tt = TTrainer(TConfig(**kw, fedmlp=TFed(**fed), data=TData(**data)), device="cpu")
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    assert tt._pre_augment_chunk == 40
    for rnd in range(3):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        for key in ("tao", "proto"):
            np.testing.assert_allclose(tt.server_state[key], jt.server_state[key],
                                       rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tt.server_state["tags"], jt.server_state["tags"])
    steps = 2 * sum(-(-int(n) // 8) for n in tt.dict_len)  # two stage-1 rounds
    assert seen["viewcat"] == steps
    assert seen["stage2"] and all(s == ["x1", "x2"] for s in seen["stage2"])
    assert int((tt.server_state["tags"] > 0).sum()) > 0


def test_stage2_distill_with_pre_augment_is_refused():
    """Stage 2's distillation term needs the single view's frozen-global
    logits; pre-made views are FedMLP's two. The JAX package fails there
    (fl_runtime.py:547-549); the port refuses the pair, naming both
    fields. Each alone is accepted."""
    base = dict(algorithm="fedmlp", model="smallcnn", batch_size=8, n_clients=4,
                output_dir="", data=TData(name="synthetic", n_classes=C, image_size=IMG,
                                          synthetic_train_size=32, synthetic_test_size=8))
    with pytest.raises(UnportedConfigError,
                       match=r"fedmlp\.stage2_distill=True with pre_augment=16"):
        TTrainer(TConfig(**base, pre_augment=16, fedmlp=TFed(stage2_distill=True)),
                 device="cpu")
    TTrainer(TConfig(**base, pre_augment=16), device="cpu")
    TTrainer(TConfig(**base, fedmlp=TFed(stage2_distill=True)), device="cpu")
    cfg = dataclasses.replace(TConfig(**base, pre_augment=16,
                                      fedmlp=TFed(stage2_distill=True)), algorithm="fedavg")
    TTrainer(cfg, device="cpu")  # stage2_distill means nothing to FedAVG
