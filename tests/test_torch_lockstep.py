"""The lockstep engine (``batched_global='on'``,
``fl_runtime.make_lockstep_local_round``) against the port's per-client
loop and against the JAX package's lockstep ``Trainer``; the program-shape
knobs (``view_precat``, ``client_unroll``, ``small_pack``, ``scan_unroll``)
bit for bit against the default on every engine; the engine choice and its
refusals.

smallcnn at 32 px, 4 classes, K=4, B=8, float32 on the CPU, the 'normonly' weak
backend (views are the normalized images: no random stream has to match).
The tolerances of the JAX package's tests/test_lockstep_round.py: client
losses rtol 1e-4 (atol 1e-5), global variables rtol 2e-3 (atol 5e-4), tags
equal; against JAX, those of tests/test_torch_fedmlp_slice.py.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.config import (Config, DataConfig, FedMLPConfig, FedNoRoConfig)
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.train import Trainer, UnportedConfigError, check_ported
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C, IMG = 4, 32
_FED = dict(rounds_stage1=2, clean_threshold=0.2, noise_threshold=0.2)
_DATA = dict(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=96,
             synthetic_test_size=16, augment_backend="normonly")
_KW = dict(algorithm="fedmlp", model="smallcnn", batch_size=8, base_lr=1e-3, n_clients=4,
           local_ep=1, rounds_warmup=4, eval_every=10_000, seed=7, p_pos=0.0,
           compute_dtype="float32", output_dir="")


def _cfg(fed=None, data=None, **kw):
    return Config(**{**_KW, **kw}, fedmlp=FedMLPConfig(**{**_FED, **(fed or {})}),
                  data=DataConfig(**{**_DATA, **(data or {})}))


def _run(cfg, rounds=3):
    t = Trainer(cfg, device="cpu")
    return t, [t.run_round(r).client_losses for r in range(rounds)]


def _assert_vars_close(a: dict, b: dict, rtol=2e-3, atol=5e-4):
    assert list(a) == list(b)
    for n in a:
        np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), rtol=rtol, atol=atol,
                                   err_msg=n)


def _assert_same_run(a, b):
    (ta, la), (tb, lb) = a, b
    assert la == lb
    for n, v in ta.global_vars.items():
        assert torch.equal(v, tb.global_vars[n]), n


@pytest.mark.parametrize("fed", [{}, {"stage2_distill": True}],
                         ids=["fedmlp", "stage2_distill"])
def test_lockstep_fedmlp_matches_the_per_client_loop(fed):
    """Two stage-1 rounds (two views, the frozen global model at K·B) and
    one stage-2 round (tagging, one view; with ``stage2_distill`` the
    frozen global model again, on the single view): losses, tags and
    global variables as the per-client loop's."""
    t_map, l_map = _run(_cfg(fed))
    t_lock, l_lock = _run(_cfg(fed, batched_global="on"))
    assert (t_map.engine, t_lock.engine) == ("mapped", "lockstep")
    np.testing.assert_allclose(l_lock, l_map, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t_lock.server_state["tags"], t_map.server_state["tags"])
    assert (t_lock.server_state["tags"] > 0).any()
    _assert_vars_close(t_map.global_vars, t_lock.global_vars)


def test_lockstep_fednoro_matches_the_per_client_loop():
    """FedNoRo (single view, 'g_logits'), a warm-up round and a round that
    splits the clients on round 0's losses and aggregates with DaAgg."""
    kw = dict(algorithm="fednoro", base_lr=1e-4, rounds_warmup=2,
              fednoro=FedNoRoConfig(rounds_warmup=1, begin=0, end=2))
    t_map, l_map = _run(_cfg(**kw), 2)
    t_lock, l_lock = _run(_cfg(batched_global="on", **kw), 2)
    np.testing.assert_allclose(l_lock, l_map, rtol=1e-4, atol=1e-5)
    assert t_lock.server_state == t_map.server_state
    assert t_lock.server_state["clean"] is not None
    _assert_vars_close(t_map.global_vars, t_lock.global_vars)


def _round_inputs(K=3, B=4, seed=0):
    """A tiny federation of K clients (9, 5 and 2 images: ragged last
    batches, and client 2 pads from its second step on) and one plan."""
    rng = np.random.RandomState(seed)
    sizes = [9, 5, 2][:K]
    n = sum(sizes)
    images = torch.from_numpy(rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8))
    starts = np.cumsum([0] + sizes)
    users = {k: list(range(starts[k], starts[k + 1])) for k in range(K)}
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    fd = rt.build_federated_data(images.numpy(), targets, users,
                                 np.zeros_like(targets, bool), [[k] for k in range(K)],
                                 device="cpu")
    pos, pos_valid, _ = rt.make_batch_plan(np.random.RandomState(seed), fd.valid.numpy(),
                                           B, 1)
    supmask = torch.from_numpy((rng.rand(K, fd.max_local, C) > 0.3).astype(np.float32))
    data = {"images": fd.images, "idx": fd.idx, "ctx": {}}
    plan = {"pos": pos, "pos_valid": pos_valid,
            "sample": {"labels": fd.obs_targets, "supmask": supmask}}
    return data, plan


def test_stage2_round_without_global_forward_equals_the_loop_bitwise():
    """One stage-2 ``round_fn`` call with no frozen-global forward: the same
    per-client gradients, and one ``adam_update`` call over the stepping
    clients runs ``torch.optim.Adam``'s arithmetic, so both engines give the
    same bits. Client 2 pads from its second step on."""
    from fedmlp_tpu_torch.models import build_model, init_model

    data, plan = _round_inputs()
    assert not plan["pos_valid"][1:, 2].any() and plan["pos_valid"][0, 2].any()
    gv = dict(init_model(build_model("smallcnn", C), 3).state_dict())
    kw = dict(lr=1e-3, batch_size=4, mean=(0.5,) * 3, std=(0.25,) * 3,
              view_mode="single", needs_global=False, augment_backend="normonly")
    outs = []
    for make in (rt.make_local_round, rt.make_lockstep_local_round):
        fn = make(build_model("smallcnn", C), tfedmlp.stage2_loss_fn, **kw)
        outs.append(fn(gv, data, plan, {}, torch.Generator().manual_seed(0)))
    (a, la, _), (b, lb, aux) = outs
    assert aux == {} and torch.equal(la, lb)
    for n, v in a["vars"].items():
        assert torch.equal(v, b["vars"][n]), n
    with pytest.raises(ValueError, match="makes its views in the step"):
        fn(gv, data, plan, {}, torch.Generator(), {"cstate": {}})


def test_lockstep_matches_jax_lockstep_trainer():
    """FedMLP, 3 rounds, both packages' lockstep ``Trainer``s from the same
    initial weights: client losses within rtol 1e-3, τ and prototypes within
    atol 1e-3, the tags equal."""
    kw = {**_KW, "batched_global": "on", "rounds_warmup": 3}
    jt = JTrainer(JConfig(**kw, fedmlp=JFed(**_FED), data=JData(**_DATA)), use_mesh=False)
    tt = Trainer(Config(**kw, fedmlp=FedMLPConfig(**_FED), data=DataConfig(**_DATA)),
                 device="cpu")
    assert jt._use_lockstep() and tt.engine == "lockstep"
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    for rnd in range(3):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        for key in ("tao", "proto"):
            np.testing.assert_allclose(tt.server_state[key], jt.server_state[key],
                                       rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tt.server_state["tags"], jt.server_state["tags"])
    assert int((tt.server_state["tags"] > 0).sum()) > 0


def test_view_precat_is_bitwise_and_reaches_the_viewcat_loss(monkeypatch):
    """With ``view_concat='on'`` the lockstep engine concatenates the two
    views once a step ('x12'), which ``loss_fn_viewcat`` reads: the same
    bits as concatenating per client."""
    seen = []
    real = tfedmlp.loss_fn_viewcat

    def spy(model, views, *a):
        seen.append("x12" in views)
        return real(model, views, *a)

    monkeypatch.setattr(tfedmlp, "loss_fn_viewcat", spy)
    runs = {p: _run(_cfg(batched_global="on", view_concat="on", view_precat=p), 2)
            for p in ("on", "off")}
    _assert_same_run(runs["on"], runs["off"])
    steps = 2 * sum(-(-int(n) // 8) for n in runs["on"][0].dict_len)
    assert seen == [True] * steps + [False] * steps


_DEFAULT_RUNS = {}


@pytest.mark.parametrize("engine", ["mapped", "lockstep", "stacked"])
@pytest.mark.parametrize("knob", [{"client_unroll": 1}, {"small_pack": 4096},
                                  {"scan_unroll": 2}], ids=lambda d: next(iter(d)))
def test_program_shape_knobs_are_the_identity(engine, knob):
    """``client_unroll``, ``small_pack`` and ``scan_unroll`` only shape the
    JAX package's XLA program (``fedmlp_tpu/config.py:202-240``): each run
    under one equals the default run bit for bit, through both stages."""
    mode = {"mapped": {}, "lockstep": {"batched_global": "on"},
            "stacked": {"client_stacking": "on"}}[engine]
    if engine not in _DEFAULT_RUNS:
        _DEFAULT_RUNS[engine] = _run(_cfg(**mode))
    run = _run(_cfg(**mode, **knob))
    assert run[0].engine == engine
    _assert_same_run(_DEFAULT_RUNS[engine], run)


def test_auto_resolves_to_the_loop_and_the_engine_is_logged(caplog):
    with caplog.at_level(logging.INFO, logger="fedmlp_tpu_torch"):
        assert Trainer(_cfg(), device="cpu").engine == "mapped"
        t = Trainer(_cfg(batched_global="on", hoist_augment=1), device="cpu")
    text = caplog.text
    assert "engine: per-client loop" in text and "engine: lockstep clients" in text
    assert "hoist_augment=1 does not reach the lockstep engine" in text
    assert t.engine == "lockstep"
    for name in ("batched_global", "client_stacking", "view_precat", "scan_unroll",
                 "client_unroll", "small_pack"):
        check_ported(_cfg(**{name: {"batched_global": "on", "client_stacking": "off",
                                    "view_precat": "on"}.get(name, 3)}))


@pytest.mark.parametrize("kw,fields", [
    (dict(algorithm="fedavg", batched_global="on"), ["batched_global"]),
    (dict(algorithm="fixmatch", batched_global="on"), ["batched_global"]),
    (dict(algorithm="fixmatch", client_stacking="on"), ["client_stacking"]),
    (dict(algorithm="fednoro", client_stacking="on"), ["client_stacking"]),
    (dict(model="resnet18", client_stacking="on"), ["client_stacking"]),
    (dict(client_stacking="on", data={"host_stream": True}),
     ["client_stacking", "data.host_stream"]),
    (dict(batched_global="on", pre_augment=16), ["pre_augment", "batched_global"]),
    (dict(client_stacking="on", pre_augment=16), ["pre_augment", "client_stacking"]),
    (dict(client_stacking="on", view_concat="on"), ["view_concat", "client_stacking"]),
    (dict(client_stacking="on", batched_global="on"),
     ["client_stacking", "batched_global"]),
    (dict(batched_global="yes"), ["batched_global"]),
    (dict(view_precat="sometimes"), ["view_precat"]),
], ids=lambda v: "-".join(v) if isinstance(v, list) else None)
def test_engine_refusals_name_their_fields(kw, fields):
    """Each combination the engines cannot run raises before anything is
    built, naming every field involved; none falls back to another engine."""
    cfg = _cfg(**kw)
    with pytest.raises(UnportedConfigError) as e:
        Trainer(cfg, device="cpu")
    msg = str(e.value)
    for f in fields:
        assert f"{f}=" in msg, (f, msg)
    with pytest.raises(UnportedConfigError):
        check_ported(cfg)


def test_padding_clients_hold_in_the_lockstep_round():
    """A client that is all padding in a step takes no step: the round over
    a plan whose last steps pad client 2 leaves client 2 exactly where a
    plan of its real step alone leaves it."""
    from fedmlp_tpu_torch.models import build_model, init_model

    data, plan = _round_inputs()
    gv = dict(init_model(build_model("smallcnn", C), 3).state_dict())
    fn = rt.make_lockstep_local_round(
        build_model("smallcnn", C), tfedmlp.stage2_loss_fn, lr=1e-3, batch_size=4,
        mean=(0.5,) * 3, std=(0.25,) * 3, view_mode="single", needs_global=False,
        augment_backend="normonly")
    full, lf, _ = fn(gv, data, plan, {}, torch.Generator())
    short = dict(plan, pos=plan["pos"][:1], pos_valid=plan["pos_valid"][:1])
    one, lo, _ = fn(gv, data, short, {}, torch.Generator())
    assert lf[2] == lo[2]
    for n, v in full["vars"].items():
        assert torch.equal(v[2], one["vars"][n][2]), n
        assert v[2].data_ptr() != gv[n].data_ptr()

