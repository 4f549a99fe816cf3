"""The port's FedMLP slice against the JAX package: one local round of the
engine, one stage-2 step, the two-stage Trainer, and the port's import
hygiene.

Both sides run float32 on the CPU with the 'normonly' weak backend (views
are the normalized images, no random warp, so no random stream has to
match) and dropout-free models; the JAX initial weights are copied into the
port with fedmlp_tpu_torch/weights.py, and both sides draw the same batch
plans from the same numpy stream.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import fedmlp as jfedmlp
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.data import masking as JM
from fedmlp_tpu.models import efficientnet as JE
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import resolve_device
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData, FedMLPConfig as TFed
from fedmlp_tpu_torch.models import efficientnet as TE
from fedmlp_tpu_torch.parallel import fl_runtime as trt
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3))
C, B, IMG = 4, 4, 32


def _models():
    jm = JE.EfficientNet(0.5, 1.0, C, dtype=jnp.float32, blocks=BLOCKS,
                         dropout_p=0.0, drop_connect_rate=0.0)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((2, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, v)

    def port():
        return TE.EfficientNet(0.5, 1.0, C, blocks=BLOCKS, dropout_p=0.0,
                               drop_connect_rate=0.0)

    return jm, v, port


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
    jctx = {"active": jnp.asarray(act), "negative": jnp.asarray(1.0 - act)}
    tctx = {"active": torch.from_numpy(act), "negative": torch.from_numpy(1.0 - act)}
    return jfd, tfd, jctx, tctx


def _run_both(loss_pair, view_mode, needs_global, users, sample_fn, lr=1e-3):
    jm, v, port = _models()
    jfd, tfd, jctx, tctx = _federation(users)
    K = len(users)
    pos, pos_valid, _ = jrt.make_batch_plan(np.random.RandomState(1),
                                            np.asarray(jfd.valid), B, 1)
    jsample, tsample = sample_fn(jfd, tfd)

    jround = jrt.make_local_round(jm, loss_pair[0], lr=lr, batch_size=B, mean=MEAN,
                                  std=STD, view_mode=view_mode,
                                  needs_global=needs_global, donate=False,
                                  augment_backend="normonly")
    imgs, sample = jrt.gather_round_data(jfd.images, jfd.idx, jsample, jnp.asarray(pos))
    plan = {"images": imgs, "sample": sample, "pos": jnp.asarray(pos),
            "pos_valid": jnp.asarray(pos_valid), "key": jax.random.PRNGKey(0),
            "iter0": jnp.float32(0)}
    jout, jloss, _ = jround({"vars": jrt.broadcast_to_clients(v, K)},
                            {"ctx": jctx, "global_vars": v}, plan,
                            {"rnd": jnp.float32(0)})

    tround = trt.make_local_round(port(), loss_pair[1], lr=lr, batch_size=B,
                                  mean=MEAN, std=STD, view_mode=view_mode,
                                  needs_global=needs_global,
                                  augment_backend="normonly",
                                  global_model=port() if needs_global else None)
    tout, tloss = tround(from_jax_variables(v),
                         {"images": tfd.images, "idx": tfd.idx, "ctx": tctx},
                         {"pos": pos, "pos_valid": pos_valid, "sample": tsample},
                         {"rnd": 0.0}, torch.Generator().manual_seed(0))
    return jout, jloss, tout, tloss, K, v


def _null_grad(path) -> bool:
    """A batch-norm bias that feeds only 1×1 convs followed by train-mode
    batch norm (every ``project_bn.bias`` here) has a gradient of exactly
    zero: the next batch norm subtracts the per-channel constant again.
    Adam divides each framework's float noise there by its own magnitude,
    so these move by up to lr per step in a direction neither side
    determines."""
    return "project_bn" in jax.tree_util.keystr(path) and path[-1].key == "bias"


def _assert_clients_match(jout, tout, K, v, n_steps, lr=1e-3):
    """params and BN running stats of every client within atol 1e-4 (a few
    Adam steps of lr 1e-3 from the same weights; the frameworks' sums differ
    by float32 rounding). The null-gradient biases are held to Adam's step
    bound instead: |Δ| ≤ lr per real step, on both sides."""
    init = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    for k in range(K):
        want = jax.tree_util.tree_map(lambda x: np.asarray(x[k]), jout["vars"])
        got = dict(jax.tree_util.tree_flatten_with_path(
            to_jax_variables(trt.client_vars(tout["vars"], k)))[0])
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            if _null_grad(path):
                bound = lr * n_steps[k] * (1 + 1e-3)
                assert np.abs(w - init[path]).max() <= bound
                assert np.abs(got[path] - init[path]).max() <= bound
                continue
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4,
                                       err_msg=f"client {k} {path}")


def test_stage1_local_round_matches_jax():
    """One FedMLP stage-1 round of the narrow EfficientNet, two clients:
    client 0 has 9 samples (a ragged last batch at B=4), client 1 has 3
    (one real step, then two all-padding steps that must be no-ops). Per-
    client mean losses within rtol 1e-4."""
    users = {0: list(range(9)), 1: list(range(9, 12))}

    def samples(jfd, tfd):
        return {"labels": jfd.obs_targets}, {"labels": tfd.obs_targets}

    jout, jloss, tout, tloss, K, v = _run_both(
        (jfedmlp.loss_fn, tfedmlp.loss_fn), "dual", True, users, samples)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    _assert_clients_match(jout, tout, K, v, n_steps=(3, 1))


def test_stage2_step_matches_jax():
    """One stage-2 step (single view, BCE masked to the confident cells)
    for one client, on random pseudo labels and supervision masks."""
    users = {0: list(range(B))}

    def samples(jfd, tfd):
        rng = np.random.RandomState(5)
        labels = (rng.rand(1, B, C) > 0.5).astype(np.float32)
        supmask = (rng.rand(1, B, C) > 0.4).astype(np.float32)
        return ({"labels": jnp.asarray(labels), "supmask": jnp.asarray(supmask)},
                {"labels": torch.from_numpy(labels), "supmask": torch.from_numpy(supmask)})

    jout, jloss, tout, tloss, K, v = _run_both(
        (jfedmlp.stage2_loss_fn, tfedmlp.stage2_loss_fn), "single", False, users,
        samples)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    _assert_clients_match(jout, tout, K, v, n_steps=(1,))


def _trainers():
    kw = dict(algorithm="fedmlp", model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=3, eval_every=100, seed=3,
              p_pos=0.0, compute_dtype="float32", output_dir="")
    # thresholds raised so that tagging selects cells at this size
    fed = dict(rounds_stage1=2, clean_threshold=0.2, noise_threshold=0.2)
    data = dict(name="synthetic", n_classes=C, image_size=IMG,
                synthetic_train_size=96, synthetic_test_size=32,
                augment_backend="normonly")
    jt = JTrainer(JConfig(**kw, fedmlp=JFed(**fed), data=JData(**data)), use_mesh=False)
    tt = TTrainer(TConfig(**kw, fedmlp=TFed(**fed), data=TData(**data)), device="cpu")
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                               jt.global_vars))
    return jt, tt


def test_trainer_two_stage_slice_matches_jax():
    """Two stage-1 rounds (the second harvests prototypes and τ) and one
    stage-2 round of both Trainers (K=4, smallcnn, 32 px): per-round client
    losses within rtol 1e-3, τ and prototypes within atol 1e-3, the int8
    tags equal, and global_test metrics within atol 1e-3."""
    jt, tt = _trainers()
    n_tagged = 0
    for rnd in range(3):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        np.testing.assert_allclose(tt.server_state["tao"], jt.server_state["tao"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(tt.server_state["proto"], jt.server_state["proto"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tt.server_state["tags"], jt.server_state["tags"])
        n_tagged = int((tt.server_state["tags"] > 0).sum())
    assert n_tagged > 0, "tagging selected nothing: the stage-2 path went untested"
    assert np.abs(tt.server_state["proto"]).sum() > 0
    mj, mt = jt.evaluate(), tt.evaluate()
    assert set(mj) == set(mt)
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], abs=1e-3), k


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """No silent CPU fallback: without a card the default device raises."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()


_IMPORT_ALL = """
import importlib, pkgutil, sys
import fedmlp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fedmlp_tpu_torch.__path__, "fedmlp_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fedmlp_tpu", "tools"))
assert len(names) >= 20, names
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_nor_the_jax_package():
    """Every module of fedmlp_tpu_torch imports in a fresh interpreter
    without pulling in jax, flax, optax, fedmlp_tpu or tools."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
