"""The port's pieces under the last four baselines against the JAX package:
the loss helpers, RoFL's centroid update, the ``rscfed``/``fedavg_rela``/
``fed_w`` aggregations, the engine's EMA teacher (scopes 'all' and 'params',
the iteration-corrected α across padding steps), ``centralized``, and that
every registered algorithm name constructs.

Float32 on the CPU, ``smallcnn`` at 32 px, the 'normonly' backend (the
views are the normalized images, a dual step's second one mirrored, so no
random stream has to match); the JAX
initial weights are copied into the port through fedmlp_tpu_torch/weights.py
and both sides draw the same batch plans from the same numpy stream.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import rscfed as JR
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.data import masking as JM
from fedmlp_tpu.fl import aggregate as JA
from fedmlp_tpu.models import build_model as jbuild
from fedmlp_tpu.ops import augment as JAug
from fedmlp_tpu.ops import losses as JL
from fedmlp_tpu.ops import similarity as JS
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import algos as talgos
from fedmlp_tpu_torch.algos import rscfed as TR
from fedmlp_tpu_torch.config import ALGORITHMS, Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.fl import aggregate as TA
from fedmlp_tpu_torch.models import build_model as tbuild
from fedmlp_tpu_torch.ops import augment as TAug
from fedmlp_tpu_torch.ops import losses as TL
from fedmlp_tpu_torch.ops import similarity as TS
from fedmlp_tpu_torch.parallel import fl_runtime as trt
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C, IMG, B = 4, 32, 4
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _probs(rs, shape, edge=True):
    """Probabilities in (0, 1), with exact 0 and 1 cells where ``edge``
    (the clips at 1e-12 must agree)."""
    p = rs.rand(*shape).astype(np.float32)
    if edge:
        p.flat[0], p.flat[-1] = 0.0, 1.0
    return p


@pytest.mark.parametrize("name", ["sigmoid_mse", "kd_symmetric_kl", "js_divergence",
                                  "anti_sigmoid", "binary_entropy_per_class"])
def test_loss_helpers_match_jax(name):
    """Each helper on the same f32 inputs, within atol 1e-6 (relative for
    the logit-valued ``anti_sigmoid``); torch 'batchmean' for the
    symmetric KL, the mean over all elements for JS."""
    rs = np.random.RandomState(0)
    if name == "sigmoid_mse":
        args = [(3 * rs.randn(6, 5)).astype(np.float32) for _ in range(2)]
    elif name in ("kd_symmetric_kl", "js_divergence"):
        args = [_probs(rs, (5, 5)), _probs(rs, (5, 5))]
    elif name == "anti_sigmoid":
        args = [_probs(rs, (6, 5), edge=False)]
    else:
        args = [_probs(rs, (6, 5))]
    want = np.asarray(getattr(JL, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(TL, name)(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6 if name == "anti_sigmoid" else 0,
                               atol=1e-6)


def test_rofl_centroid_update_matches_jax():
    """Rows of any similarity, an all-zero batch mean (similarity 0: the row
    stays) and an exactly parallel one (similarity 1: it is replaced)."""
    rs = np.random.RandomState(1)
    f_k = rs.randn(8, 16).astype(np.float32)
    hat = rs.randn(8, 16).astype(np.float32)
    hat[2] = 0.0
    hat[5] = 2.0 * f_k[5]
    want = np.asarray(JS.rofl_centroid_update(jnp.asarray(f_k), jnp.asarray(hat)))
    got = TS.rofl_centroid_update(torch.from_numpy(f_k), torch.from_numpy(hat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(got[2], f_k[2])


@functools.lru_cache(maxsize=None)
def _smallcnn_init(key: int) -> dict:
    """flax's ``smallcnn`` variables from PRNGKey(``key``), jitted, once a
    process (the tests only read them)."""
    jm = jbuild("smallcnn", C, compute_dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(key))
    return jax.tree_util.tree_map(np.asarray, v)


def _client_trees(n_clients, seed=0):
    """``smallcnn`` variables of ``n_clients`` clients: JAX's initial weights
    plus client-specific noise, stacked [K, ...] on both sides."""
    v = _smallcnn_init(0)
    rs = np.random.RandomState(seed)
    per = [jax.tree_util.tree_map(
        lambda a, s=0.01 * (1 + k): (a + s * rs.randn(*a.shape)).astype(np.float32), v)
        for k in range(n_clients)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
    tsd = [from_jax_variables(p) for p in per]
    return jstack, {n: torch.stack([sd[n] for sd in tsd]) for n in tsd[0]}


def _assert_trees_close(got_sd, want_tree, atol, what):
    want = jax.tree_util.tree_map(np.asarray, want_tree)
    got = to_jax_variables(got_sd)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("K_g,M", [(6, 2), (3, 4), (8, 1)])
def test_rscfed_aggregation_matches_jax(K_g, M):
    """Groups of K_g of 8 clients of unequal sizes, drawn as RSCFed draws
    them; the aggregate within atol 1e-6."""
    jstack, tstack = _client_trees(8)
    dict_len = np.array([30, 12, 25, 40, 18, 22, 9, 33])
    rs = np.random.RandomState(2)
    dma = np.stack([rs.choice(8, size=K_g, replace=False) for _ in range(M)])
    agg = jax.jit(functools.partial(JA.rscfed, K=K_g, M=M))  # as the JAX algorithm
    want = agg(jnp.asarray(dma), jstack, dict_len=jnp.asarray(dict_len, jnp.float32))
    _assert_trees_close(TA.rscfed(dma, tstack, K_g, dict_len, M), want, 1e-6,
                        f"rscfed {K_g}x{M}")


def test_fedavg_rela_and_fed_w_match_jax():
    """Relation rows over the annotating clients (a class no client
    annotates comes out 0, as in JAX); ``fed_w`` with arbitrary weights."""
    rs = np.random.RandomState(3)
    K = 5
    mats = rs.rand(K, C, C).astype(np.float32)
    weight = np.array([26, 30, 12, 7, 19])
    mask = np.zeros((C, K), np.float32)
    mask[0, [0, 4]] = mask[1, 1] = mask[2, [2, 3, 4]] = 1.0  # class 3: nobody
    want = np.asarray(JA.fedavg_rela(mats, weight, mask))
    got = TA.fedavg_rela(mats, weight, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(got[3], np.zeros(C, np.float32))
    jstack, tstack = _client_trees(K)
    w = rs.rand(K).astype(np.float32)
    _assert_trees_close(TA.fed_w(tstack, w), JA.fed_w(jstack, w), 1e-6, "fed_w")


def mirror_second_views(monkeypatch):
    """On both sides, every second weak view is the left-right mirror of the
    normalized image: both engines make view 1, then view 2, so a dual
    step's views differ (with equal views the mix weight would not matter)
    and still no random stream has to match."""
    def jpick(backend):
        calls = itertools.count()

        def weak(imgs, key, mean, std, keys=None):
            x = JAug.eval_batch(imgs, mean, std)  # NHWC
            return x[:, :, ::-1, :] if next(calls) % 2 else x
        return weak

    def tpick(backend):
        calls = itertools.count()

        def weak(imgs, generator, mean, std):
            x = TAug.eval_batch(imgs, mean, std)  # NCHW
            return torch.flip(x, dims=[3]) if next(calls) % 2 else x
        return weak

    monkeypatch.setattr(jrt, "_pick_weak_backend", jpick)
    monkeypatch.setattr(TAug, "pick_weak_backend", tpick)


def _federation(users, seed=0):
    rng = np.random.RandomState(seed)
    n = 1 + max(max(u) for u in users.values())
    images = rng.randint(0, 256, (n, IMG, IMG, 3), np.uint8)
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    hidden = JM.build_hidden_mask(targets, 0.0, np.random.RandomState(seed))
    active = [[k % C] for k in range(len(users))]
    jfd = jrt.build_federated_data(images, targets, users, hidden, active)
    tfd = trt.build_federated_data(images, targets, users, hidden, active, device="cpu")
    act = np.asarray(jfd.active, np.float32)
    lw = np.array(jfd.loss_w)
    jctx = {"active": jnp.asarray(act), "negative": jnp.asarray(1.0 - act),
            "loss_w": jnp.asarray(lw)}
    tctx = {"active": torch.from_numpy(act), "negative": torch.from_numpy(1.0 - act),
            "loss_w": torch.from_numpy(lw)}
    return jfd, tfd, jctx, tctx


@pytest.mark.parametrize("scope,decay,corrected", [("all", 0.7, False),
                                                   ("params", 0.9, True)])
def test_engine_teacher_matches_jax(monkeypatch, scope, decay, corrected):
    """One round of ``make_local_round`` with RSCFed's loss and an EMA
    teacher, two epochs, two clients: client 0 has 9 samples (a ragged last
    batch at B=4), client 1 has 3 (one real step, then two padding steps, in
    each epoch), so its second real step sits after two padding steps. The
    teacher reads view 2, the mirror of view 1, and starts from other
    weights than the student, so its logits matter. With the
    iteration-corrected α, α = min(1 − 1/(it + 1), decay) with it = iter0 +
    the step's index, padding steps counted. Per-client losses rtol 1e-4,
    the students' variables atol 1e-4 and the teachers' atol 1e-5; scope
    'params' leaves the teacher's batch-norm statistics as they came, scope
    'all' moves them; the two clients' teachers differ where they moved."""
    mirror_second_views(monkeypatch)
    users = {0: list(range(9)), 1: list(range(9, 12))}
    K = len(users)
    jfd, tfd, jctx, tctx = _federation(users)
    jm = jbuild("smallcnn", C, compute_dtype=jnp.float32)
    v, tv = _smallcnn_init(0), _smallcnn_init(1)
    tv = dict(tv, batch_stats=jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.RandomState(4).rand(*a.shape).astype(np.float32),
        tv["batch_stats"]))
    pos, pos_valid, _ = jrt.make_batch_plan(np.random.RandomState(1),
                                            np.asarray(jfd.valid), B, 2)
    assert not pos_valid[1:3, 1].any() and pos_valid[3, 1].any()
    iter0 = 2
    # lr 1e-4: Adam's first step moves a weight by about ±lr where its
    # gradient is within float noise of 0 (tests/test_torch_fednoro.py)
    kw = dict(lr=1e-4, batch_size=B, mean=MEAN, std=STD, view_mode="dual",
              teacher_decay=decay, teacher_iter_corrected=corrected, teacher_scope=scope,
              augment_backend="normonly")
    jround = jrt.make_local_round(jm, JR.loss_fn, donate=False, **kw)
    labels = {"labels": jfd.obs_targets}
    imgs, sample = jrt.gather_round_data(jfd.images, jfd.idx, labels, jnp.asarray(pos))
    plan = {"images": imgs, "sample": sample, "pos": jnp.asarray(pos),
            "pos_valid": jnp.asarray(pos_valid), "key": jax.random.PRNGKey(0),
            "iter0": jnp.float32(iter0)}
    jout, jloss, _ = jround({"vars": jrt.broadcast_to_clients(v, K),
                             "teacher": jrt.broadcast_to_clients(tv, K)},
                            {"ctx": jctx, "global_vars": v}, plan, {"rnd": jnp.float32(0)})

    tround = trt.make_local_round(tbuild("smallcnn", C), TR.loss_fn, **kw,
                                  teacher_model=tbuild("smallcnn", C))
    teacher_in = trt.broadcast_to_clients(from_jax_variables(tv), K)
    tout, tloss, _ = tround(from_jax_variables(v),
                            {"images": tfd.images, "idx": tfd.idx, "ctx": tctx},
                            {"pos": pos, "pos_valid": pos_valid,
                             "sample": {"labels": tfd.obs_targets}, "iter0": iter0},
                            {"rnd": 0.0}, torch.Generator().manual_seed(0),
                            {"teacher": teacher_in})
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    for k in range(K):
        for key, atol in (("vars", 1e-4), ("teacher", 1e-5)):
            _assert_trees_close(trt.client_vars(tout[key], k),
                                jax.tree_util.tree_map(lambda x, k=k: x[k], jout[key]),
                                atol, f"{key} client {k}")
    tv_sd = from_jax_variables(tv)
    for n, t in tout["teacher"].items():
        moved = not torch.equal(t[0], tv_sd[n])
        assert moved == (scope == "all" or not n.endswith(("running_mean", "running_var"))), n
        assert moved != torch.equal(t[0], t[1]), n  # a teacher of each client's own
    assert all(torch.equal(v, tv_sd[n].expand_as(v)) for n, v in teacher_in.items())


def _cfgs(algorithm, **kw):
    base = dict(algorithm=algorithm, model="smallcnn", batch_size=8, base_lr=1e-3,
                n_clients=4, local_ep=1, rounds_warmup=2, eval_every=1, seed=3,
                p_pos=0.3, compute_dtype="float32", output_dir="")
    base.update(kw)
    data = dict(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=96,
                synthetic_test_size=32, augment_backend="normonly")
    return JConfig(**base, data=JData(**data)), TConfig(**base, data=TData(**data))


def test_centralized_round_matches_jax():
    """``centralized``: one client holding the whole training set with every
    class active and no label hidden (p_pos=0.3 would hide some), one round
    against the JAX Trainer: loss rtol 1e-3, variables atol 1e-4, metrics
    atol 1e-3."""
    jcfg, tcfg = _cfgs("centralized", rounds_warmup=1)
    jt, tt = JTrainer(jcfg, use_mesh=False), TTrainer(tcfg, device="cpu")
    assert tt.active_lists == jt.active_lists == [list(range(C))]
    assert not tt.hidden.any() and not jt.hidden.any()
    assert tt.fd.active.all()
    assert torch.equal(tt.fd.obs_targets[0][tt.fd.valid[0]],
                       torch.from_numpy(tt.train_ds.targets))
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    a, b = jt.run_round(0), tt.run_round(0)
    np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
    _assert_trees_close(tt.global_vars, jt.global_vars, 1e-4, "centralized")
    for k in a.metrics:
        assert b.metrics[k] == pytest.approx(a.metrics[k], abs=1e-3), k


def test_every_jax_algorithm_name_constructs():
    """All ten names of the JAX registry are registered in the port, pass
    ``check_ported`` and build a ``Trainer`` on the CPU; without a device the
    same config asks for the card and raises where there is none."""
    import fedmlp_tpu.algos as jalgos

    assert sorted(jalgos._REGISTRY) == talgos.registered() == sorted(ALGORITHMS)
    for a in talgos.registered():
        _, tcfg = _cfgs(a)
        tr = TTrainer(tcfg, device="cpu")
        assert tr.algo is talgos.get_algorithm(a)
        assert (tr.teacher_model is not None) == (a in ("rscfed", "fedirm"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TTrainer(tcfg)
