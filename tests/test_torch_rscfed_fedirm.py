"""The port's RSCFed and FedIRM against the JAX package's ``Trainer``: the
persistent per-client EMA teacher, RSCFed's sub-consensus groups, FedIRM's
relation matrices across the supervised → relation boundary, and a resume
of each.

Float32 on the CPU, ``smallcnn`` at 32 px, 4 clients, the 'normonly' backend
(view 1 the normalized image, view 2 its mirror, so no random stream has to
match and the teacher's view is not the student's);
the JAX initial weights are copied into the port through
fedmlp_tpu_torch/weights.py and both sides draw the same batch plans (and
RSCFed's groups) from the same numpy stream. Losses rtol 1e-3, global
variables atol 1e-4, as for FedNoRo; lr 1e-4 for the reason given in
tests/test_torch_fednoro.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.config import FedIRMConfig as JIrm
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.config import FedIRMConfig as TIrm
from fedmlp_tpu_torch.parallel import fl_runtime as trt
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from test_torch_baseline_ops import mirror_second_views
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C = 4
IRM = dict(rounds_sup=1, consistency=1.0, consistency_rampup=2.0, ema_decay=0.99)


def _configs(algorithm, rounds, n_clients=4):
    """4 clients at batch 8 over 104 images: 26 a client, so every client's
    last batch is ragged (2 valid rows of 8). FedIRM's consistency ramps up
    over 2 rounds, so its relation terms weigh in at once."""
    kw = dict(algorithm=algorithm, model="smallcnn", batch_size=8, base_lr=1e-4,
              n_clients=n_clients, local_ep=1, rounds_warmup=rounds, eval_every=100, seed=3,
              p_pos=0.3, compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=C, image_size=32, synthetic_train_size=104,
                synthetic_test_size=32, augment_backend="normonly")
    return (JConfig(**kw, data=JData(**data), fedirm=JIrm(**IRM)),
            TConfig(**kw, data=TData(**data), fedirm=TIrm(**IRM)))


def _trainers(algorithm, rounds, jax_too=True, n_clients=4):
    jcfg, tcfg = _configs(algorithm, rounds, n_clients)
    jt = JTrainer(jcfg, use_mesh=False) if jax_too else None
    tt = TTrainer(tcfg, device="cpu")
    if jt is not None:
        tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                                   jt.global_vars))
    return jt, tt


def _assert_close(got_sd, want_tree, atol, what):
    want = jax.tree_util.tree_map(np.asarray, want_tree)
    got = to_jax_variables(got_sd)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {path}")


def _assert_teachers(tt_teacher, jt_teacher, atol, what, params_only=False):
    """Every client's teacher against JAX's. Each is memory of its own, and
    clients 0 and 1 (other data) have other teachers, but for the batch-norm
    statistics of a params-only teacher."""
    K = next(iter(tt_teacher.values())).shape[0]
    for k in range(K):
        _assert_close(trt.client_vars(tt_teacher, k),
                      jax.tree_util.tree_map(lambda x, k=k: x[k], jt_teacher), atol,
                      f"{what} teacher of client {k}")
    for n, t in tt_teacher.items():
        assert t.stride(0) != 0, n  # not an expanded view of one tensor
        stats = n.endswith(("running_mean", "running_var"))
        assert torch.equal(t[0], t[1]) == (params_only and stats), n


def test_rscfed_two_rounds_match_jax(monkeypatch):
    """Two RSCFed rounds: the teacher starts as the initial global model,
    forwards view 2 at every step and moves toward the student (decay 0.999
    over the whole state dict); the server draws 10 groups of 6 of the 8
    clients (13 images each) after the batch plans and aggregates by
    sub-consensus. The host streams stay equal (the same plans and groups),
    every client's teacher of its own within atol 1e-5."""
    mirror_second_views(monkeypatch)
    jt, tt = _trainers("rscfed", 2, n_clients=8)
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        assert str(jt.rng.get_state()) == str(tt.rng.get_state())
        _assert_close(tt.global_vars, jt.global_vars, 1e-4, f"round {rnd}")
        _assert_teachers(tt._rscfed_teacher, jt._rscfed_teacher, 1e-5, f"round {rnd}")


def test_fedirm_supervised_then_two_relation_rounds_match_jax(monkeypatch):
    """FedIRM with rounds_sup=1: round 0 supervised (it reports the relation
    matrices), rounds 1 and 2 relation rounds with the params-only teacher
    (initialized from the arriving global model, α = min(1 − 1/(it + 1),
    0.99) with it counted from the lifetime step count 4). The relation
    matrix within atol 1e-5 after every round, every client's teacher
    within atol 1e-4 (it follows the students closely at α ≈ 0.8), its
    batch-norm statistics still the global model's of round 1."""
    mirror_second_views(monkeypatch)
    jt, tt = _trainers("fedirm", 3)
    for rnd in range(3):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        _assert_close(tt.global_vars, jt.global_vars, 1e-4, f"round {rnd}")
        rel = tt.server_state["relation"]
        np.testing.assert_allclose(rel, jt.server_state["relation"], rtol=0, atol=1e-5)
        assert tt.server_state["ema_init"] == jt.server_state["ema_init"] == (rnd >= 1)
        if rnd == 0:
            assert not hasattr(tt, "_fedirm_teacher")
            assert np.isfinite(rel).all() and not np.allclose(rel, 0.5)
            arriving = {n: v.clone() for n, v in tt.global_vars.items()}
        else:
            _assert_teachers(tt._fedirm_teacher, jt._fedirm_teacher, 1e-4, f"round {rnd}",
                             params_only=True)
    for n, t in tt._fedirm_teacher.items():
        if n.endswith(("running_mean", "running_var")):
            assert torch.equal(t, arriving[n].expand_as(t)), n


@pytest.mark.parametrize("algorithm,ckpts", [("rscfed", (0,)), ("fedirm", (0, 1))])
def test_resume_repeats_the_round(tmp_path, algorithm, ckpts):
    """A checkpoint after round r, restored into a fresh trainer, runs round
    r + 1 with the first run's losses, global variables, teacher and server
    state, bit for bit. FedIRM (rounds_sup=1) resumes across the boundary
    from round 0 (no teacher yet) and from round 1 (the teacher and
    ``ema_init`` restored)."""
    _, tt = _trainers(algorithm, 3, jax_too=False)
    paths, recs = {}, {}
    last = max(ckpts) + 1
    for rnd in range(last + 1):
        recs[rnd] = tt.run_round(rnd)
        if rnd in ckpts:
            paths[rnd] = save_checkpoint(os.fspath(tmp_path / str(rnd)), tt, rnd)
    for r in ckpts:
        _, fresh = _trainers(algorithm, 3, jax_too=False)
        assert load_checkpoint(paths[r], fresh) == r + 1
        again = fresh.run_round(r + 1)
        assert again.client_losses == recs[r + 1].client_losses
        if r + 1 == last:
            for n, v in tt.global_vars.items():
                assert torch.equal(fresh.global_vars[n], v), n
            teacher = f"_{algorithm}_teacher"
            for n, v in getattr(tt, teacher).items():
                assert torch.equal(getattr(fresh, teacher)[n], v), n
            st, st0 = fresh.server_state, tt.server_state
            assert set(st) == set(st0)
            for key in st:
                assert np.array_equal(st[key], st0[key]), key
