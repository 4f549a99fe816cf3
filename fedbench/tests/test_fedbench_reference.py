"""The plain reference against the program on the CPU, and the check that
decides ``correct``: a sound run passes, a run with the timed path broken
underneath fails, and so does the control."""

import math

import pytest
import torch

from fedbench import cell as C
from fedbench import compare, harness
from fedbench.reference import views as V
from fedbench.tests.helpers import SEED, run_tiny, tiny_cell

CELLS = ("effb0-fedmlp-s1", "r18-fedmlp-s1")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("name", ["efficient_b0", "resnet18"])
@pytest.mark.parametrize("train", [False, True])
def test_reference_forward_is_the_programs(name, train):
    from fedmlp_tpu_torch.models import build_model

    torch.manual_seed(0)
    ref = __import__(f"fedbench.reference.models.{name}", fromlist=["forward"])
    w = ref.init_weights(8, torch.Generator().manual_seed(3), "cpu")
    model = build_model(name, 8, image_size=64)
    model.load_state_dict(w)  # strict: the same names and shapes
    model.train(train)
    x = torch.randn(8, 3, 64, 64)
    upd = {}
    f1, l1 = model(x, generator=torch.Generator().manual_seed(5))
    f2, l2 = ref.forward(w, x, train, torch.Generator().manual_seed(5), upd)
    scale = l2.abs().max().item() or 1.0
    assert (l1 - l2).abs().max().item() <= 1e-4 * scale
    state = model.state_dict()
    assert all(torch.allclose(state[n], t, rtol=1e-5, atol=1e-6) for n, t in upd.items())
    assert bool(upd) == train


def test_reference_view_is_the_programs():
    from fedmlp_tpu_torch.ops import augment

    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    a = augment.pick_weak_backend("auto")(imgs, torch.Generator().manual_seed(9), MEAN, STD)
    b = V.weak_view(imgs, torch.Generator().manual_seed(9), MEAN, STD)
    assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}


def _unchanged(trainer):
    """Every client's round returns the state it was given."""
    from fedmlp_tpu_torch.parallel.fl_runtime import broadcast_to_clients

    inner = trainer.round_fn

    def round_fn(global_vars, data, plan, scalars, generator, extra_state=None):
        out, losses, aux = inner(global_vars, data, plan, scalars, generator, extra_state)
        out["vars"] = {n: v.clone() for n, v in
                       broadcast_to_clients(global_vars, losses.shape[0]).items()}
        return out, losses, aux

    trainer.round_fn = round_fn


def _half_batch(trainer):
    """Each step's loss over the first half of the batch, the mean over it."""
    from fedmlp_tpu_torch.algos import fedmlp

    def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
        h = svalid.shape[0] // 2
        views = {n: v[:h] for n, v in views.items()}
        sample = {n: v[:h] for n, v in sample.items()}
        return fedmlp.loss_fn(model, views, sample, svalid[:h], ctx, generator, scalars)

    trainer.round_fn = trainer.make_round(loss_fn, view_mode="dual", needs_global=True)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault):
    out = run_tiny(name, patch=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference with fp8 operands in the program's place, at a size a
    test holds, fails the cell's limits."""
    cell = tiny_cell(name)
    gen = torch.Generator().manual_seed(SEED % 2**32)
    data = C.make_data(cell, gen, "cpu")
    inputs = {"data": data, "weights": C.reference_model(cell).init_weights(8, gen, "cpu")}
    ref = harness.reference_rounds(cell, SEED, inputs)
    ctl = harness.reference_rounds(cell, SEED, inputs, quant=True)
    ok, checks = compare.judge(compare.readings(ctl, ref, inputs["weights"]), cell.limits)
    assert not ok, checks


def test_readings_of_identical_runs_are_zero():
    g = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    run = {"losses": [[0.5, 0.7]], "first_grad": g, "weights": {"a": torch.zeros(3) + 1e-3,
                                                                 "b": torch.zeros(2) - 1e-3}}
    init = {"a": torch.zeros(3), "b": torch.zeros(2)}
    read = compare.readings(run, run, init)
    assert all(v == 0.0 for v in read.values())
    ok, checks = compare.judge(read, {"loss_gap": 0.0})
    assert ok and list(checks) == ["loss_gap"]
    bad = dict(run, losses=[[math.nan, 0.7]])
    assert not compare.judge(compare.readings(bad, run, init), {"loss_gap": 1.0})[0]
    assert not compare.judge(read, None)[0]


def test_the_reference_refuses_rounds_that_reach_the_harvest():
    """The reference follows stage 1 only: a mix whose set-up rounds reach
    the last stage-1 round's harvest is refused, not compared."""
    cell = tiny_cell("r18-fedmlp-s1")
    cell.traffic = dict(cell.traffic, fedmlp=dict(cell.traffic["fedmlp"], rounds_stage1=2))
    gen = torch.Generator().manual_seed(SEED % 2**32)
    inputs = {"data": C.make_data(cell, gen, "cpu"),
              "weights": C.reference_model(cell).init_weights(8, gen, "cpu")}
    with pytest.raises(NotImplementedError, match="stage 1 only"):
        harness.reference_rounds(cell, SEED, inputs)


def _fails_in_window(trainer):
    """Every round after the set-up rounds raises."""
    inner = trainer.run_round

    def run_round(rnd):
        if rnd >= 2:
            raise RuntimeError("planted")
        return inner(rnd)

    trainer.run_round = run_round


@pytest.mark.parametrize("traced", [False, True])
def test_a_round_that_raises_is_failed_and_not_correct(traced):
    out = run_tiny("r18-fedmlp-s1", patch=_fails_in_window, traced=traced)
    assert (out["attempted"], out["failed"], out["correct"]) == (1, 1, False)
    assert not traced or out["metrics"] == {}
