"""The port's FedNoRo against the JAX package's: the rampups, ``model_dist``
and ``daagg``, the GMM clean/noisy split, the loss in its three branches,
three rounds of both ``Trainer``s through the first split, and a resume.

Float32 on the CPU, ``smallcnn`` at 32 px, 4 clients, the 'normonly'
backend (the view is the normalized image, so no random stream has to
match); the JAX initial weights are copied into the port through
fedmlp_tpu_torch/weights.py and both sides draw the same batch plans from
the same numpy stream.
"""

import functools
import json
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import detection as JD
from fedmlp_tpu.algos import fednoro as JN
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.config import FedNoRoConfig as JNoRo
from fedmlp_tpu.data.datasets import ArrayDataset as JArray
from fedmlp_tpu.fl import aggregate as JA
from fedmlp_tpu.models import build_model as jbuild
from fedmlp_tpu.ops import losses as JL
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.algos import detection as TD
from fedmlp_tpu_torch.algos import fednoro as TN
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.config import FedNoRoConfig as TNoRo
from fedmlp_tpu_torch.data.datasets import ArrayDataset as TArray
from fedmlp_tpu_torch.data.datasets import make_synthetic_dataset
from fedmlp_tpu_torch.fl import aggregate as TA
from fedmlp_tpu_torch.models import build_model as tbuild
from fedmlp_tpu_torch.ops import losses as TL
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C, IMG, K, PER_CLIENT = 4, 32, 4, 24


def test_rampups_match_jax():
    for begin, end in ((0, 2), (10, 499), (3, 3.5)):
        for cur in (-1, 0, 1, 2, 3, 10, 57.5, 499, 600):
            assert TL.sigmoid_rampup_bounded(cur, begin, end) == \
                JL.sigmoid_rampup_bounded(cur, begin, end)
    for length in (0, 1, 30.0):
        for cur in (-2, 0, 0.5, 1, 15, 30, 40):
            assert TL.sigmoid_rampup(cur, length) == JL.sigmoid_rampup(cur, length)


@functools.lru_cache(maxsize=None)
def _smallcnn(key: int):
    """flax's ``smallcnn`` and its initial variables from PRNGKey(``key``),
    jitted, once a process (the tests only read them)."""
    jm = jbuild("smallcnn", C, compute_dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(key))
    return jm, jax.tree_util.tree_map(np.asarray, v)


def _client_trees(n_clients, seed=0):
    """``smallcnn`` variables of ``n_clients`` clients: JAX's initial
    weights plus client-specific noise, stacked [K, ...] on both sides."""
    _, v = _smallcnn(0)
    rs = np.random.RandomState(seed)
    per = [jax.tree_util.tree_map(
        lambda a, s=0.01 * (1 + k): (a + s * rs.randn(*a.shape)).astype(np.float32), v)
        for k in range(n_clients)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
    tsd = [from_jax_variables(p) for p in per]
    tstack = {n: torch.stack([sd[n] for sd in tsd]) for n in tsd[0]}
    return jstack, tstack, per, tsd


def test_model_dist_and_daagg_match_jax():
    """The distance within 1e-6 relative (f32 norms summed in another
    entry order); DaAgg's aggregate within 1e-6 (a weighted sum of K
    entries with weights from those distances)."""
    jstack, tstack, per, tsd = _client_trees(6)
    got = float(TA.model_dist(tsd[0], tsd[3]))
    want = float(JA.model_dist(per[0], per[3]))
    assert got == pytest.approx(want, rel=1e-6)
    dict_len = np.array([30, 12, 25, 40, 18, 22], np.float32)
    for clean, noisy in (([0, 2, 5], [1, 3, 4]), ([4], [0, 1, 2, 3, 5]),
                         ([0, 1, 2, 3, 4, 5], [])):
        want = jax.tree_util.tree_map(
            np.asarray, JA.daagg(jstack, dict_len, clean, noisy))
        out = TA.daagg(tstack, dict_len, clean, noisy)
        got = to_jax_variables(out)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f"{clean} {noisy} {path}")
        cw = TA.daagg_weights(tstack, dict_len, clean, noisy).numpy()
        assert np.isfinite(cw).all() and cw.sum() == pytest.approx(1.0, abs=1e-6)
        if noisy:  # the noisy clients are down-weighted
            share = dict_len / dict_len.sum()
            assert (cw[noisy] / share[noisy] < cw[clean].min() / share[clean].min()).all()


def _split_cases():
    cases = []
    for seed in range(6):  # bimodal 20-client losses, 3..10 noisy clients
        rs = np.random.RandomState(seed)
        n_noisy = 3 + seed
        x = np.concatenate([0.2 + 0.05 * rs.rand(20 - n_noisy),
                            0.5 + 0.2 * rs.rand(n_noisy)])
        cases.append(rs.permutation(x))
    for seed in range(4):  # no second mode: the k-means draw decides
        cases.append(np.random.RandomState(100 + seed).rand(20))
    cases += [np.array([0.4]), np.array([0.7, 0.3]),
              np.r_[np.full(19, 0.3), 2.5], np.full(20, 0.35), np.zeros(5)]
    return cases


@pytest.mark.parametrize("case", range(len(_split_cases())))
@pytest.mark.parametrize("seed", [0, 1037])
def test_gmm_split_matches_jax(case, seed):
    """The port's numpy GMM (scikit-learn's k-means++ start, Lloyd's
    iterations and EM, written out) gives the JAX package's lists."""
    x = _split_cases()[case]
    with warnings.catch_warnings():  # scikit-learn warns on repeated values
        warnings.simplefilter("ignore")
        want = JD.split_clean_noisy_gmm(x, seed)
    assert TD.split_clean_noisy_gmm(x, seed) == want
    assert sorted(want[0] + want[1]) == list(range(len(x)))


@pytest.mark.parametrize("branch", ["warm-up", "clean", "noisy"])
def test_loss_value_and_gradient_match_jax(branch):
    """One batch of 6 (the last row padding) through both loss functions:
    the value within rtol 1e-5, every parameter's gradient within 1e-5 of
    the largest gradient entry."""
    rs = np.random.RandomState(3)
    B = 6
    jm, v = _smallcnn(1)
    x = rs.randn(B, IMG, IMG, 3).astype(np.float32)
    g_logits = (2.0 * rs.randn(B, C)).astype(np.float32)
    labels = (rs.rand(B, C) > 0.5).astype(np.float32)
    svalid = np.array([True] * (B - 1) + [False])
    active = np.array([1, 0, 0, 1], np.float32)
    flag = np.float32(branch == "noisy")
    scalars = {"weight_kd": 0.37, "post_warmup": 0.0 if branch == "warm-up" else 1.0}

    jctx = {"active": jnp.asarray(active), "negative": jnp.asarray(1 - active),
            "noisy_flag": jnp.asarray(flag)}
    jviews = {"x": jnp.asarray(x), "g_logits": jnp.asarray(g_logits)}
    jscal = {k: jnp.float32(s) for k, s in scalars.items()}

    def jloss(params):
        return JN.loss_fn(params, {"batch_stats": v["batch_stats"]}, jm, jviews,
                          {"labels": jnp.asarray(labels)}, jnp.asarray(svalid), jctx,
                          None, None, jscal)[0]

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(v["params"])

    model = tbuild("smallcnn", C)
    model.load_state_dict(from_jax_variables(v))
    tctx = {"active": torch.from_numpy(active), "negative": torch.from_numpy(1 - active),
            "noisy_flag": torch.tensor(flag)}
    tviews = {"x": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
              "g_logits": torch.from_numpy(g_logits)}
    loss = TN.loss_fn(model, tviews, {"labels": torch.from_numpy(labels)},
                      torch.from_numpy(svalid), tctx, None, scalars)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    tgrad = to_jax_variables({n: p.grad for n, p in model.named_parameters()})["params"]
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jgrad))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jgrad)[0],
                            jax.tree_util.tree_leaves(tgrad)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{branch} {path}")


def _data():
    """4 clients × 24 images, client k annotating class k. Clients 0 and 1
    keep their labels; clients 2 and 3 get theirs redrawn at random, so
    their losses sit well above the clean clients' and the split is clear."""
    ds = make_synthetic_dataset(K * PER_CLIENT + 32, C, IMG, seed=5)
    targets = ds.targets.copy()
    rs = np.random.RandomState(7)
    for k in (2, 3):
        rows = slice(k * PER_CLIENT, (k + 1) * PER_CLIENT)
        targets[rows, k] = (rs.rand(PER_CLIENT) < 0.5).astype(np.float32)
    n = K * PER_CLIENT
    users = {k: list(range(k * PER_CLIENT, (k + 1) * PER_CLIENT)) for k in range(K)}
    split = {"train": (ds.images[:n], targets[:n]), "test": (ds.images[n:], targets[n:])}
    return split, users


def _trainers(device="cpu"):
    split, users = _data()
    # lr 1e-4: a client's first Adam step moves a weight by about ±lr where
    # its decayed gradient is within float noise of 0 (see
    # tests/test_torch_fedmlp_slice.py); at 1e-3 over 12 client-rounds that
    # alone can exceed the 1e-4 tolerance, at 1e-4 the largest difference
    # is 5e-6 to 1.8e-5 with 1 to 8 torch threads.
    kw = dict(algorithm="fednoro", model="smallcnn", batch_size=8, base_lr=1e-4,
              n_clients=K, local_ep=1, rounds_warmup=3, eval_every=3, seed=3,
              p_pos=0.0, compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=C, image_size=IMG, augment_backend="normonly")
    names = tuple(f"c{i}" for i in range(C))
    jt = JTrainer(JConfig(**kw, data=JData(**data),
                          fednoro=JNoRo(rounds_warmup=1, begin=0, end=2)),
                  train_ds=JArray(*split["train"], names), test_ds=JArray(*split["test"], names),
                  dict_users=users, use_mesh=False)
    tt = TTrainer(TConfig(**kw, data=TData(**data),
                          fednoro=TNoRo(rounds_warmup=1, begin=0, end=2)),
                  train_ds=TArray(*split["train"], names), test_ds=TArray(*split["test"], names),
                  dict_users=users, device=device)
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    return jt, tt


def _split_margin(losses, clean, noisy):
    """Distance between the clean and the noisy clients' losses (positive:
    every noisy client's loss is above every clean client's)."""
    losses = np.asarray(losses)
    return float(losses[noisy].min() - losses[clean].max())


def test_trainer_three_rounds_match_jax():
    """Round 0 warms up (FedAvg), round 1 splits on round 0's losses and
    aggregates with DaAgg while every client still trains LA_KD, round 2
    trains the clean clients on plain BCE and splits again. Client losses
    rtol 1e-3, the same clean/noisy lists, every global variable within
    1e-4, metrics within 1e-3. The split's margin (the gap between the
    clean and the noisy clients' losses) is asserted to be over 100 times
    the largest loss difference between the frameworks."""
    jt, tt = _trainers()
    for rnd in range(3):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        assert tt.server_state == jt.server_state, rnd
        if rnd >= 1:
            prev = jt.history[-2].client_losses
            diff = np.abs(np.asarray(tt.history[-2].client_losses) - prev).max()
            st = jt.server_state
            assert st["noisy"] == [2, 3] and st["clean"] == [0, 1]
            assert _split_margin(prev, st["clean"], st["noisy"]) > 100 * diff
            w = tt.daagg_weights
            assert np.isfinite(w).all() and w.sum() == pytest.approx(1.0, abs=1e-6)
        want = jax.tree_util.tree_map(np.asarray, jt.global_vars)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(to_jax_variables(tt.global_vars))):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{rnd} {path}")
    mj, mt = jt.history[-1].metrics, tt.history[-1].metrics
    assert mj and set(mj) == set(mt)
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], abs=1e-3), k


def test_resume_across_the_first_split_repeats_losses(tmp_path):
    """A checkpoint after round 0 (before any split), restored into a fresh
    trainer: rounds 1 and 2 (the split, DaAgg, the clean/noisy dispatch)
    give the first run's losses, server state and variables bit for bit."""
    _, tt = _trainers()
    tt.run_round(0)
    path = save_checkpoint(os.fspath(tmp_path), tt, 0)
    first = [tt.run_round(r) for r in (1, 2)]
    _, fresh = _trainers()
    assert load_checkpoint(path, fresh) == 1
    again = [fresh.run_round(r) for r in (1, 2)]
    for a, b in zip(first, again):
        assert a.client_losses == b.client_losses
    assert fresh.server_state == tt.server_state
    for n, v in tt.global_vars.items():
        assert torch.equal(fresh.global_vars[n], v), n


def test_cli_fednoro_resumes_across_the_first_split(tmp_path):
    """``python -m fedmlp_tpu_torch.cli --exp FedNoRo`` with the FedNoRo
    flags, 3 rounds with a checkpoint after each; ``--resume`` from round
    0's checkpoint runs rounds 1 and 2 again (the first split, DaAgg, the
    clean/noisy dispatch) with the same losses, and round 2's checkpoint
    holds the split as lists."""
    argv = ["--exp", "FedNoRo", "--rounds_FedNoRo_warmup", "1", "--begin", "0",
            "--end", "2", "--a", "0.8", "--dataset", "synthetic", "--model", "smallcnn",
            "--device", "cpu", "--rounds", "3", "--batch_size", "8", "--base_lr", "1e-3",
            "--image_size", "32", "--n_clients", "4", "--synthetic_train_size", "64",
            "--synthetic_test_size", "16", "--eval_every", "3", "--checkpoint_every", "1",
            "--compute_dtype", "float32", "--output_dir", str(tmp_path)]

    def losses():
        path = os.path.join(tmp_path, "FedNoRo_synthetic", "logs", "metrics.jsonl")
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        return [(r["step"], r["tag"], r["value"]) for r in recs
                if "/warm-up-loss/client" in r["tag"]]

    TCli.main(argv)
    first = losses()
    assert len(first) == 3 * 4
    models = os.path.join(tmp_path, "FedNoRo_synthetic", "models")
    with open(os.path.join(models, "ckpt_2.pkl"), "rb") as fh:
        st = pickle.load(fh)["server_state"]
    assert isinstance(st["clean"], list) and isinstance(st["noisy"], list)
    assert sorted(st["clean"] + st["noisy"]) == [0, 1, 2, 3]
    with open(os.path.join(models, "ckpt_0.pkl"), "rb") as fh:
        assert pickle.load(fh)["server_state"] == {"clean": None, "noisy": None}
    TCli.main(argv + ["--resume", os.path.join(models, "ckpt_0.pkl")])
    again = losses()[len(first):]
    assert again == [r for r in first if r[0] >= 1]
