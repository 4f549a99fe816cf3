"""The port's FedAVG path against the JAX package: ``bce_with_logits``, one
FedAVG round of both ``Trainer``s, and ``class_test`` / ``val_loss``.

Float32 on the CPU, ``smallcnn`` at 32 px, the 'normonly' weak backend (no
random warp, so no random stream has to match); the JAX initial weights are
copied into the port through fedmlp_tpu_torch/weights.py and both sides draw
the same batch plans from the same numpy stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.eval import evaluate as JEval
from fedmlp_tpu.ops import losses as JL
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.eval import evaluate as TEval
from fedmlp_tpu_torch.ops import losses as TL
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_bce_with_logits_value_and_gradient_match_jax():
    """Element-wise values and d/dlogits against the JAX function, with a
    per-class ``pos_weight`` ≠ 1 and logits at ±30 (where σ saturates in
    float32 and a naive log σ would overflow): rtol 1e-6, atol 1e-6."""
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 5).astype(np.float32) * 3.0
    logits[0, :] = [30.0, -30.0, 30.0, -30.0, 0.0]
    targets = (rs.rand(6, 5) > 0.5).astype(np.float32)
    targets[0, :] = [1.0, 1.0, 0.0, 0.0, 1.0]
    pos_w = np.array([1.0, 7.5, 0.25, 3.0, 1.0], np.float32)

    for pw in (None, pos_w):
        jpw = None if pw is None else jnp.asarray(pw)
        want = JL.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets), jpw)
        want_g = jax.grad(lambda x: JL.bce_with_logits(
            x, jnp.asarray(targets), jpw).sum())(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = TL.bce_with_logits(x, torch.from_numpy(targets),
                                 None if pw is None else torch.from_numpy(pw))
        assert got.shape == (6, 5)  # unreduced
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-6)
        assert np.isfinite(got.detach().numpy()).all()


def _trainers(n_train=104):
    """4 clients at batch 8 over 104 images: 26 a client, so every client's
    last batch is ragged (2 valid rows of 8)."""
    kw = dict(algorithm="fedavg", model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=3,
              p_pos=0.3, compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=4, image_size=32,
                synthetic_train_size=n_train, synthetic_test_size=40,
                augment_backend="normonly")
    jt = JTrainer(JConfig(**kw, data=JData(**data)), use_mesh=False)
    tt = TTrainer(TConfig(**kw, data=TData(**data)), device="cpu")
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                               jt.global_vars))
    return jt, tt


def test_client_ctx_matches_jax():
    jt, tt = _trainers()
    jctx, tctx = jt.client_ctx(), tt.client_ctx()
    assert set(jctx) == set(tctx)
    for name in jctx:
        np.testing.assert_allclose(tctx[name].numpy(), np.asarray(jctx[name]),
                                   rtol=1e-6, err_msg=name)


def test_fedavg_round_matches_jax():
    """Two FedAVG rounds of both Trainers from the same weights and batch
    plans: per-client mean losses within rtol 1e-4 and every aggregated
    variable within atol 1e-4 (a few Adam steps of lr 1e-3; the frameworks'
    sums differ by float32 rounding). ``smallcnn`` has no batch-norm bias
    with an exactly-zero gradient, so no variable is exempt."""
    jt, tt = _trainers()
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-4)
        want = jax.tree_util.tree_map(np.asarray, jt.global_vars)
        got = to_jax_variables(tt.global_vars)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                       err_msg=f"round {rnd} {path}")
    assert tt.iter_num == jt.iter_num == 8  # 4 steps a round, kept across rounds


def test_class_test_and_val_loss_match_jax():
    """``class_test`` and ``val_loss`` of both packages on the same
    probabilities (the port's, handed to both through a stub
    ``eval_probs``): metrics equal, the loss within rtol 1e-5."""
    jt, tt = _trainers()
    tt.run_round(0)
    np.testing.assert_array_equal(jt.test_ds.images, tt.test_ds.images)
    jt.eval_probs = lambda _vars, images: tt.eval_probs(tt.global_vars, images)
    for classid in range(4):
        want, got = JEval.class_test(jt, classid), TEval.class_test(tt, classid)
        assert set(want) == set(got) == {"BACC", "R", "F1", "P"}
        for k in want:
            np.testing.assert_equal(got[k], want[k])
    assert TEval.val_loss(tt, frac=0.5, seed=1) == pytest.approx(
        JEval.val_loss(jt, frac=0.5, seed=1), rel=1e-5)
    assert TEval.global_test(tt) == JEval.global_test(jt)
