"""The port's FedLSR and RoFL against the JAX package's ``Trainer``, RoFL's
per-client state through the engine's ``post_step``, and the CLI of the
four baselines and ``centralized``.

Float32 on the CPU, ``smallcnn`` at 32 px, 4 clients, the 'normonly' backend
(the views are the normalized images, FedLSR's second one mirrored, so no
random stream has to match);
the JAX initial weights are copied into the port through
fedmlp_tpu_torch/weights.py and both sides draw the same batch plans from
the same numpy stream. Losses rtol 1e-3, global variables atol 1e-4, as for
FedNoRo; lr 1e-4 for the reason given in tests/test_torch_fednoro.py.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from fedmlp_tpu.algos import fedlsr as JF
from fedmlp_tpu.algos import rofl as JRo
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.config import FedLSRConfig as JLsr, RoFLConfig as JRoCfg
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.algos import fedlsr as TF
from fedmlp_tpu_torch.algos import rofl as TRo
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.config import FedLSRConfig as TLsr, RoFLConfig as TRoCfg
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from test_torch_baseline_ops import mirror_second_views
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C = 4
ROFL = dict(forget_rate=0.2, num_gradual=10, T_pl=2, lambda_cen=1.0, lambda_e=0.8)


def _trainers(algorithm, n_train, jax_too=True):
    """4 clients at batch 8; FedLSR's β ramps over t_w=2 rounds; RoFL's
    pseudo-label refresh and λ_cen ramp run over T_pl=2 rounds."""
    kw = dict(algorithm=algorithm, model="smallcnn", batch_size=8, base_lr=1e-4,
              n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=3,
              p_pos=0.3, compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=C, image_size=32, synthetic_train_size=n_train,
                synthetic_test_size=32, augment_backend="normonly")
    tt = TTrainer(TConfig(**kw, data=TData(**data), fedlsr=TLsr(t_w=2),
                          rofl=TRoCfg(**ROFL)), device="cpu")
    if not jax_too:
        return None, tt
    jt = JTrainer(JConfig(**kw, data=JData(**data), fedlsr=JLsr(t_w=2),
                          rofl=JRoCfg(**ROFL)), use_mesh=False)
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    return jt, tt


def _assert_globals(jt, tt, what):
    want = jax.tree_util.tree_map(np.asarray, jt.global_vars)
    got = to_jax_variables(tt.global_vars)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{what} {path}")


def test_fedlsr_two_rounds_with_the_mix_pinned_match_jax(monkeypatch):
    """Two FedLSR rounds (104 images: every client's last batch ragged) with
    the mix weight pinned to 0.3 on both sides: the port's ``draw_mix``, and
    the ``jax.random.uniform`` that the JAX module's name ``jax`` reaches;
    view 2 mirrors view 1. Round 1 carries the JS term at β = 0.2."""
    mirror_second_views(monkeypatch)
    pinned = jax.random.uniform

    def uniform(key, *a, **k):
        return jnp.float32(0.3)

    monkeypatch.setattr(JF, "jax", types.SimpleNamespace(
        random=types.SimpleNamespace(uniform=uniform, fold_in=jax.random.fold_in),
        nn=jax.nn))
    monkeypatch.setattr(TF, "draw_mix", lambda generator, device: torch.tensor(0.3))
    assert jax.random.uniform is pinned  # only the module's name is patched
    jt, tt = _trainers("fedlsr", 104)
    for rnd in range(2):
        assert tt.round_scalars(rnd)["beta"] == pytest.approx(0.2 * rnd)
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        _assert_globals(jt, tt, f"round {rnd}")


def test_fedlsr_mix_draws_are_uniform(monkeypatch):
    """Unpinned, the port draws one mix weight a step from the trainer's
    generator, each new; 20000 draws of ``draw_mix`` pass a
    Kolmogorov-Smirnov test against U(0, 1)."""
    drawn = []

    def record(generator, device):
        m = draw(generator, device)
        drawn.append(float(m))
        return m

    draw = TF.draw_mix
    monkeypatch.setattr(TF, "draw_mix", record)
    _, tt = _trainers("fedlsr", 104, jax_too=False)
    tt.run_round(0)
    assert len(drawn) == tt.iter_num * 4 == 16  # 4 steps of 4 clients
    assert len(set(drawn)) == len(drawn) and all(0.0 <= m < 1.0 for m in drawn)
    g = torch.Generator().manual_seed(11)
    sample = [float(draw(g, "cpu")) for _ in range(20000)]
    assert scipy.stats.kstest(sample, "uniform").pvalue > 1e-3


def test_rofl_two_rounds_match_jax():
    """Two RoFL rounds: the harvest's pseudo-labels and round 0's centroids,
    the small-loss selection, centroid agreement, the three loss terms, the
    per-step centroid EMA and pseudo refresh (``post_step``), then f_G
    from the clients' centroids. 128 images: 32 a client, a multiple of the
    batch, so no batch has padding rows (the JAX package's scatter of
    padding rows, shown in the next test, does not enter). f_G and the
    pseudo table after each round, and the global variables."""
    jt, tt = _trainers("rofl", 128)
    assert (tt.dict_len % 8 == 0).all()
    np.testing.assert_array_equal(tt.server_state["f_G"], jt.server_state["f_G"])
    np.testing.assert_array_equal(tt.server_state["forget_schedule"],
                                  jt.server_state["forget_schedule"])
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        _assert_globals(jt, tt, f"round {rnd}")
        np.testing.assert_array_equal(tt.server_state["pseudo"], jt.server_state["pseudo"])
        np.testing.assert_allclose(tt.server_state["f_G"], jt.server_state["f_G"],
                                   rtol=0, atol=1e-4)


def _post_step_case():
    """One client's table of 6 positions and a ragged batch of 4: real rows
    at positions 3, 0, 5, padding rows (pointing at position 0, as the batch
    plan pads) after them. Position 0 is selected, with observed labels that
    differ from its pseudo-labels."""
    rs = np.random.RandomState(5)
    D = 6
    pseudo = np.zeros((6, C), np.float32)
    labels = np.array([[1, 0, 1, 0], [1, 1, 0, 1], [0, 0, 1, 1], [0, 0, 0, 0]], np.float32)
    pos = np.array([3, 0, 5, 0])
    svalid = np.array([True, True, True, False])
    sel = np.array([1, 1, 0, 0], np.float32)
    cstate = {"f_k": rs.randn(2 * C, D).astype(np.float32), "pseudo": pseudo}
    aux = {"feature": rs.randn(4, D).astype(np.float32), "sel": sel, "sel_pl": sel,
           "labels": labels}
    return cstate, aux, pos, svalid


def _jax_post_step(cstate, aux, pos, svalid):
    out = JRo.post_step({n: jnp.asarray(v) for n, v in cstate.items()},
                        {n: jnp.asarray(v) for n, v in aux.items()},
                        {"_pos": jnp.asarray(pos)}, jnp.asarray(svalid), {})
    return {n: np.asarray(v) for n, v in out.items()}


def _torch_post_step(cstate, aux, pos, svalid):
    out = TRo.post_step({n: torch.from_numpy(v) for n, v in cstate.items()},
                        {n: torch.from_numpy(v) for n, v in aux.items()},
                        {"_pos": torch.from_numpy(pos)}, torch.from_numpy(svalid), {})
    return {n: v.numpy() for n, v in out.items()}


def test_rofl_padding_rows_do_not_overwrite_a_refresh():
    """A known difference, kept: the port writes the pseudo refresh of the
    valid rows only, so position 0 (a real row here) takes its observed
    labels; the JAX package's ``pseudo.at[pos].set(upd)`` also scatters the
    padding row, which points at position 0 and carries its old value, and
    on the CPU the last write wins, so the refresh is lost. Every other
    position and the centroids agree."""
    cstate, aux, pos, svalid = _post_step_case()
    got = _torch_post_step(cstate, aux, pos, svalid)
    want = _jax_post_step(cstate, aux, pos, svalid)
    np.testing.assert_array_equal(got["pseudo"][0], aux["labels"][1])  # kept
    np.testing.assert_array_equal(want["pseudo"][0], cstate["pseudo"][0])  # dropped
    assert not np.array_equal(aux["labels"][1], cstate["pseudo"][0])
    np.testing.assert_array_equal(got["pseudo"][1:], want["pseudo"][1:])
    np.testing.assert_array_equal(got["pseudo"][3], aux["labels"][0])
    np.testing.assert_allclose(got["f_k"], want["f_k"], rtol=0, atol=1e-6)


def test_rofl_post_step_on_a_padding_step_is_a_no_op_in_jax():
    """The JAX engine runs ``post_step`` on padding steps with zeroed aux;
    that leaves RoFL's centroids and pseudo table exactly as they were, so
    the port, which skips padding steps, loses nothing."""
    cstate, aux, pos, _ = _post_step_case()
    cstate["pseudo"] = np.random.RandomState(6).rand(6, C).astype(np.float32)
    zero = {n: np.zeros_like(v) for n, v in aux.items()}
    out = _jax_post_step(cstate, zero, np.zeros_like(pos), np.zeros(4, bool))
    for n in cstate:
        np.testing.assert_array_equal(out[n], cstate[n], err_msg=n)


def test_rofl_resume_repeats_round_one(tmp_path):
    """A checkpoint after round 0 (numpy f_G, pseudo table and forget
    schedule in ``server_state``), restored into a fresh trainer: round 1
    gives the first run's losses, variables and server state bit for bit."""
    _, tt = _trainers("rofl", 128, jax_too=False)
    tt.run_round(0)
    path = save_checkpoint(os.fspath(tmp_path), tt, 0)
    first = tt.run_round(1)
    _, fresh = _trainers("rofl", 128, jax_too=False)
    assert load_checkpoint(path, fresh) == 1
    assert isinstance(fresh.server_state["f_G"], np.ndarray)
    again = fresh.run_round(1)
    assert again.client_losses == first.client_losses
    for n, v in tt.global_vars.items():
        assert torch.equal(fresh.global_vars[n], v), n
    for key in ("f_G", "pseudo", "forget_schedule"):
        assert np.array_equal(fresh.server_state[key], tt.server_state[key]), key


@pytest.mark.parametrize("exp,flags", [
    ("FedLSR", ["--t_w", "1"]),
    ("RSCFed", []),
    ("FedIRM", ["--rounds_FedIRM_sup", "1"]),
    ("RoFL", ["--T_pl", "2"]),
    ("centralized", []),
])
def test_cli_runs_and_resumes(tmp_path, exp, flags):
    """``python -m fedmlp_tpu_torch.cli --exp <name>``, 2 rounds with a
    checkpoint after each, then ``--resume`` from round 0's: round 1's
    losses repeat."""
    argv = ["--exp", exp, "--dataset", "synthetic", "--model", "smallcnn", "--device",
            "cpu", "--rounds", "2", "--batch_size", "8", "--base_lr", "1e-3",
            "--image_size", "32", "--n_clients", "4", "--synthetic_train_size", "64",
            "--synthetic_test_size", "16", "--eval_every", "2", "--checkpoint_every", "1",
            "--compute_dtype", "float32", "--output_dir", str(tmp_path)] + flags

    def losses():
        path = os.path.join(tmp_path, f"{exp}_synthetic", "logs", "metrics.jsonl")
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        return [(r["step"], r["tag"], r["value"]) for r in recs
                if "/warm-up-loss/client" in r["tag"]]

    TCli.main(argv)
    first = losses()
    assert len(first) == 2 * (1 if exp == "centralized" else 4)
    assert all(np.isfinite(v) for _, _, v in first)
    models = os.path.join(tmp_path, f"{exp}_synthetic", "models")
    TCli.main(argv + ["--resume", os.path.join(models, "ckpt_0.pkl")])
    assert losses()[len(first):] == [r for r in first if r[0] == 1]
