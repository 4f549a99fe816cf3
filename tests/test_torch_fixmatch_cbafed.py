"""The port's FixMatch and CBAFed against the JAX package's ``Trainer``.

Float32 on the CPU, ``smallcnn`` at 32 px, the 'normonly' backend (both views
are the normalized images, so no random stream has to match); the JAX initial
weights are copied into the port through fedmlp_tpu_torch/weights.py and both
sides draw the same batch plans from the same numpy stream. Tolerances as
tests/test_torch_fedavg.py: per-client mean losses rtol 1e-4, every
aggregated variable atol 1e-4 (a few Adam steps of lr 1e-3; the frameworks'
sums differ by float32 rounding); ``smallcnn`` has no batch-norm bias with an
exactly-zero gradient, so no variable is exempt.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import CBAFedConfig as JCba, Config as JConfig, DataConfig as JData
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.config import CBAFedConfig as TCba, Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _configs(algorithm, warmup=1, n_train=104):
    """4 clients at batch 8 over 104 images: 26 a client, so every client's
    last batch is ragged (2 valid rows of 8)."""
    kw = dict(algorithm=algorithm, model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=4, eval_every=100, seed=3,
              p_pos=0.3, compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=4, image_size=32,
                synthetic_train_size=n_train, synthetic_test_size=40,
                augment_backend="normonly")
    return (JConfig(**kw, data=JData(**data), cbafed=JCba(rounds_warmup=warmup)),
            TConfig(**kw, data=TData(**data), cbafed=TCba(rounds_warmup=warmup)))


def _trainers(algorithm, warmup=1):
    jcfg, tcfg = _configs(algorithm, warmup)
    jt = JTrainer(jcfg, use_mesh=False)
    tt = TTrainer(tcfg, device="cpu")
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                               jt.global_vars))
    return jt, tt


def _assert_same_globals(jt, tt, what):
    want = jax.tree_util.tree_map(np.asarray, jt.global_vars)
    got = to_jax_variables(tt.global_vars)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{what} {path}")


def test_fixmatch_round_matches_jax():
    """Two FixMatch rounds: the weak and the strong forward in turn (the
    batch-norm statistics move twice a step), the confidence mask, the hard
    pseudo-labels and the ``use_unsup`` selection."""
    jt, tt = _trainers("fixmatch")
    assert tt.algo.VIEW_MODE == jt.algo.VIEW_MODE == "weak_strong"
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-4)
        _assert_same_globals(jt, tt, f"round {rnd}")
    assert tt.iter_num == jt.iter_num == 8


def test_fixmatch_unsupervised_term_is_live_and_selected_without_a_host_read():
    """With a model confident on every missing class the loss carries the
    strong view's term; with no confident sample it is the supervised term
    alone. Both from one ``torch.where``: the gradient stays finite."""
    from fedmlp_tpu_torch.algos import fixmatch

    class Fixed(torch.nn.Module):
        def __init__(self, scale):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(float(scale)))

        def forward(self, x, generator=None):
            logits = self.w * x.mean(dim=(2, 3))  # [B, 3]
            return logits, logits

    x = torch.tensor([[5.0, -5.0, 5.0], [-5.0, 5.0, 5.0]])[:, :, None, None].expand(2, 3, 2, 2)
    views = {"x1": x, "x2": x}
    sample = {"labels": torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])}
    ctx = {"active": torch.tensor([1.0, 0.0, 0.0]), "negative": torch.tensor([0.0, 1.0, 1.0]),
           "loss_w": torch.ones(3), "loss_w_unknown": torch.ones(3)}
    svalid = torch.tensor([True, True])
    losses = {}
    for scale in (1.0, 0.01):  # confident (|logit| = 5) and not (|logit| = 0.05)
        m = Fixed(scale)
        loss = fixmatch.loss_fn(m, views, sample, svalid, ctx, None, {})
        loss.backward()
        assert torch.isfinite(loss) and torch.isfinite(m.w.grad)
        losses[scale] = float(loss.detach())
    sup_only = float(torch.nn.functional.binary_cross_entropy_with_logits(
        torch.tensor([0.05, -0.05]), torch.tensor([1.0, 0.0]), reduction="sum")) / 2
    assert losses[0.01] == pytest.approx(sup_only, rel=1e-6)
    sup_conf = float(torch.nn.functional.binary_cross_entropy_with_logits(
        torch.tensor([5.0, -5.0]), torch.tensor([1.0, 0.0]), reduction="sum")) / 2
    # strong logits equal the weak ones, so the hard labels agree with them
    unsup = float(torch.nn.functional.binary_cross_entropy_with_logits(
        torch.tensor([-5.0, 5.0, 5.0, 5.0]), torch.tensor([0.0, 1.0, 1.0, 1.0]),
        reduction="sum")) / (2 * 2)
    assert losses[1.0] == pytest.approx(sup_conf + unsup, rel=1e-5)


def test_cbafed_warmup_to_pseudo_label_rounds_match_jax(tmp_path):
    """Warm-up 1: round 0 warms up and sets τ at the boundary; round 1 runs
    the pseudo-label loss with τ as a scalar, aggregates by the reported
    data_nums and refreshes τ. Losses, variables and τ (atol 1e-6: a ratio of
    counts) follow the JAX Trainer; the residual is the phase's first
    aggregate. A checkpoint after round 0 restores ``server_state`` (τ as
    numpy, the residual as a dict of tensors) and round 1, which needs both,
    repeats bit for bit."""
    jt, tt = _trainers("cbafed", warmup=1)
    assert tt.server_state["residual"] is None
    np.testing.assert_array_equal(tt.server_state["tao"], np.full(4, 0.95, np.float32))
    ckpt = None
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-4,
                                   err_msg=f"round {rnd}")
        _assert_same_globals(jt, tt, f"round {rnd}")
        np.testing.assert_allclose(tt.server_state["tao"], jt.server_state["tao"],
                                   rtol=0, atol=1e-6, err_msg=f"round {rnd}")
        tao = tt.server_state["tao"]
        assert tao.dtype == np.float32 and (tao >= 0.55).all() and (tao <= 0.95).all()
        if rnd == 0:
            assert (tao < 0.95).any()  # set at the warm-up boundary
            ckpt = save_checkpoint(str(tmp_path), tt, rnd)
    res = tt.server_state["residual"]
    assert isinstance(res, dict) and set(res) == set(tt.global_vars)
    assert hasattr(tt, "_cbafed_pseudo_fn")  # the second round function ran

    t2 = TTrainer(tt.cfg, device="cpu")
    assert load_checkpoint(ckpt, t2) == 1
    assert isinstance(t2.server_state["tao"], np.ndarray)
    assert all(isinstance(v, torch.Tensor) for v in t2.server_state["residual"].values())
    t2.run_round(1)
    assert t2.history[-1].client_losses == tt.history[-1].client_losses
    np.testing.assert_array_equal(t2.server_state["tao"], tt.server_state["tao"])
    for n, v in tt.global_vars.items():
        assert torch.equal(v, t2.global_vars[n]), n


@pytest.mark.parametrize("phase", ["warmup", "pseudo"])
def test_cbafed_aux_sums_match_jax(phase):
    """``local_pass`` returns (state, losses, aux) as the JAX one does: the
    counters summed over each client's steps, stacked [K, ...]. Warm-up:
    data_num = the client's sample count. Pseudo-label phase (τ = 0.55, so
    that some samples pass): class_num [K, C] and data_num [K], equal to
    JAX's (atol 1e-3: counts, exact unless a probability sits within an ulp
    of τ)."""
    from fedmlp_tpu.algos import cbafed as jcba
    from fedmlp_tpu_torch.algos import cbafed as tcba
    import jax.numpy as jnp

    jt, tt = _trainers("cbafed")
    tao = np.full(4, 0.55, np.float32)
    if phase == "warmup":
        jfn, tfn, js, ts = jt.round_fn, tt.round_fn, {}, {}
    else:
        jfn, tfn = jcba._get_pseudo_fn(jt), tcba._get_pseudo_fn(tt)
        js, ts = {"tao": jnp.asarray(tao)}, {"tao": torch.from_numpy(tao)}
    _, jl, jaux = jt.local_pass(jfn, {"labels": jt.fd.obs_targets},
                                {**jt.round_scalars(0), **js})
    _, tl, taux = tt.local_pass(tfn, {"labels": tt.fd.obs_targets},
                                {**tt.round_scalars(0), **ts})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert set(taux) == set(jaux) == ({"data_num"} if phase == "warmup"
                                      else {"class_num", "data_num"})
    for name in jaux:
        assert taux[name].shape == tuple(jaux[name].shape)
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]),
                                   rtol=0, atol=1e-3, err_msg=name)
    if phase == "warmup":
        np.testing.assert_array_equal(taux["data_num"].numpy(), tt.dict_len)
    else:
        assert float(taux["class_num"].sum()) > float(tt.dict_len.sum())  # pseudo-labels


@pytest.mark.parametrize("phase_rnd,mix", [(5, 0.2), (5, 0.5), (10, 0.5), (0, 0.2),
                                           (3, 0.5)])
def test_cbafed_server_mix_matches_jax_residual_rule(phase_rnd, mix):
    """The server's residual rule past a phase's first round, which the
    two-round parity run never reaches: on a 5th round of a phase the global
    model is mix·aggregate + (1 − mix)·residual (0.2 in warm-up, 0.5 after
    it), as ``fedmlp_tpu.algos.cbafed._residual_mix`` computes it on the same
    trees (atol 1e-7: one multiply-add a value), and becomes the new
    residual; a phase's first round stores the bare aggregate; any other
    round leaves the residual alone."""
    import types

    from fedmlp_tpu.algos import cbafed as jcba
    from fedmlp_tpu_torch.algos import cbafed as tcba

    rng = np.random.default_rng(11)
    new = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in (("conv.weight", (4, 3, 3, 3)), ("fc.bias", (5,)))}
    res = {n: rng.standard_normal(v.shape).astype(np.float32) for n, v in new.items()}
    w_new = {n: torch.from_numpy(v) for n, v in new.items()}
    residual = {n: torch.from_numpy(v) for n, v in res.items()}
    trainer = types.SimpleNamespace(global_vars=None)
    st = {"residual": residual}
    tcba._server_mix(trainer, st, w_new, phase_rnd, mix)

    if phase_rnd == 0:
        want, want_res = new, new
    elif phase_rnd % 5:
        want, want_res = new, res
    else:
        want = jax.tree_util.tree_map(np.asarray, jcba._residual_mix(new, res, mix))
        want_res = want
    for n in new:
        np.testing.assert_allclose(trainer.global_vars[n].numpy(), want[n],
                                   rtol=0, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(st["residual"][n].numpy(), want_res[n],
                                   rtol=0, atol=1e-7, err_msg=n)
    if phase_rnd and phase_rnd % 5 == 0:
        assert not np.allclose(trainer.global_vars["fc.bias"].numpy(), new["fc.bias"])

    # with no residual yet (a run resumed without one) the aggregate passes through
    st = {"residual": None}
    tcba._server_mix(trainer, st, w_new, phase_rnd, mix)
    assert all(torch.equal(trainer.global_vars[n], w_new[n]) for n in w_new)
    assert (st["residual"] is None) == bool(phase_rnd % 5)


def test_fedavg_and_fedmlp_losses_return_no_aux():
    """The engine's third result is empty for losses that return a bare
    loss, and the two-tuple algorithms keep working through it."""
    tt = TTrainer(_configs("fedavg")[1], device="cpu")
    _, _, aux = tt.local_pass(tt.round_fn, {"labels": tt.fd.obs_targets},
                              tt.round_scalars(0))
    assert aux == {}


_SMALL = ["--dataset", "synthetic", "--model", "smallcnn", "--device", "cpu",
          "--batch_size", "8", "--image_size", "32", "--base_lr", "1e-3",
          "--synthetic_train_size", "32", "--synthetic_test_size", "16",
          "--n_clients", "2", "--compute_dtype", "float32", "--eval_every", "2"]


@pytest.mark.parametrize("exp,extra", [
    ("FedAVG+FixMatch", []),
    ("FedAVG+FixMatch", ["--augment_backend", "gather"]),
    ("CBAFed", ["--rounds_CBAFed_warmup", "1", "--augment_backend", "pallas"]),
])
def test_cli_runs_fixmatch_and_cbafed(tmp_path, exp, extra):
    """``cli.main`` on the CPU, the random views on (default 'auto': the
    fused weak view and the shear-pass strong view through the kernels' plain
    versions): 2 rounds of 2 clients (CBAFed: a warm-up and a pseudo-label
    round), finite losses for every client and round, metrics after the
    last."""
    import json

    out = str(tmp_path)
    TCli.main(_SMALL + ["--exp", exp, "--rounds", "2", "--output_dir", out] + extra)
    with open(os.path.join(out, f"{exp}_synthetic", "logs", "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r["value"] for r in recs if "/warm-up-loss/client" in r["tag"]]
    assert len(losses) == 2 * 2 and np.isfinite(losses).all()
    assert {r["tag"] for r in recs if r["step"] == 1} >= {"test_run0/mAP", "test_run0/auc"}
