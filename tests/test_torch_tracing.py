"""The port's tracing (utils/profiling.py): spans nest and keep their calls,
host and self time; a Trainer round leaves its record of spans and
counters, and a joint step of the lockstep and stacked engines counts its
clients' steps as the per-client loop does; under a profiler the spans land
in the Chrome trace as host events, no user annotations, without changing
the round; without one no profiler event is opened; device spans resolve
their CUDA events without waiting.

The round is the FedMLP slice's CPU Trainer (tests/test_torch_fedmlp_slice.py:
smallcnn, K=4, batch 8, 32 px, the 'normonly' view), one stage-1 round that
harvests and evaluates."""

import json
import math

import pytest
import torch

from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig
from fedmlp_tpu_torch.train import Trainer
from fedmlp_tpu_torch.utils import profiling as P
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B, K = 8, 4
# every span a stage-1 round that harvests and evaluates reaches
ROUND_SPANS = (P.ROUND, P.LOCAL_PASS, P.CLIENT_SETUP, P.CLIENT_WRITEBACK, P.STEP,
               P.VIEWS, P.GLOBAL_FORWARD, P.LOSS_FORWARD, P.BACKWARD, P.OPTIMIZER,
               P.HARVEST, P.TAGGING, P.AGGREGATE, P.EVALUATE)


@pytest.fixture(autouse=True)
def fresh_records():
    P.reset()
    yield
    P.reset()


def _trainer(**engine) -> Trainer:
    cfg = Config(**engine, algorithm="fedmlp", model="smallcnn", batch_size=B, base_lr=1e-3,
                 n_clients=K, local_ep=1, rounds_warmup=1, eval_every=1, seed=7,
                 p_pos=0.0, compute_dtype="float32", output_dir="",
                 fedmlp=FedMLPConfig(rounds_stage1=1),
                 data=DataConfig(name="synthetic", n_classes=4, image_size=32,
                                 synthetic_train_size=96, synthetic_test_size=32,
                                 augment_backend="normonly"))
    return Trainer(cfg, device="cpu")


def test_nested_spans_keep_calls_self_time_and_parent():
    for _ in range(3):
        with P.span("outer"):
            for _ in range(2):
                with P.span("inner"):
                    sum(range(1000))
            P.count("things", 2)
    spans = P.SETUP["spans"]
    assert spans["outer"]["calls"] == 3 and spans["inner"]["calls"] == 6
    assert spans["outer"]["parent"] is None and spans["inner"]["parent"] == "outer"
    for s in spans.values():
        assert 0 <= s["self_ns"] <= s["host_ns"]
    assert spans["inner"]["self_ns"] == spans["inner"]["host_ns"]  # no children
    assert spans["outer"]["self_ns"] == spans["outer"]["host_ns"] - spans["inner"]["host_ns"]
    assert P.SETUP["counters"] == {"things": 6}
    with pytest.raises(KeyError), P.span("failing"):
        raise KeyError("a span that raises still counts")
    assert spans["failing"]["calls"] == 1 and not P.HISTORY


@pytest.fixture(scope="module")
def first_round():
    """(trainer, the set-up record, the round's RoundRecord, the history
    after it) of a fresh process's first Trainer and round, which pay the
    process's first calls once for the file."""
    P.reset()
    tr = _trainer()
    rec = tr.run_round(0)
    return tr, P.SETUP, rec, list(P.HISTORY)


def test_a_trainer_round_leaves_its_record(first_round):
    tr, setup, rec, history = first_round
    init = setup["spans"]
    assert init[P.TRAINER_INIT]["calls"] == 1 and init[P.TRAINER_INIT]["parent"] is None
    (spans,) = history
    assert rec.spans is spans
    assert (spans["round"], spans["seq"], spans["profiled"]) == (0, 0, False)
    live = sum(math.ceil(n / B) for n in tr.fd.n_local.tolist())
    assert spans["counters"] == {P.STEPS: live, P.CLIENTS: K}
    assert set(ROUND_SPANS) <= set(spans["spans"])
    s = spans["spans"]
    assert s[P.STEP]["calls"] == live and s[P.CLIENT_SETUP]["calls"] == K
    assert s[P.STEP]["parent"] == P.LOCAL_PASS and s[P.BACKWARD]["parent"] == P.STEP
    assert s[P.EVALUATE]["parent"] is None  # after the round span, in its record
    assert rec.seconds == s[P.ROUND]["host_ns"] / 1e9
    assert "device_ns" not in s[P.LOCAL_PASS]  # on the CPU: no events
    assert P.round_summary(spans).endswith(f"{live} steps, {K} clients")
    assert P.TRAINER_INIT not in s and P.STEP not in init


@pytest.mark.parametrize("engine", [{"batched_global": "on"}, {"client_stacking": "on"}],
                         ids=["lockstep", "stacked"])
def test_joint_step_engines_count_client_steps(first_round, engine):
    """A joint step of n live clients counts n steps, as n steps of the
    per-client loop do: the ``steps`` counter is the same on every engine,
    while the ``fedmlp.step`` span opens once a joint step."""
    tr = _trainer(**engine)
    rec = tr.run_round(0)
    live = sum(math.ceil(n / B) for n in tr.fd.n_local.tolist())
    joint = max(math.ceil(n / B) for n in tr.fd.n_local.tolist())
    assert rec.spans["counters"] == first_round[2].spans["counters"] == {
        P.STEPS: live, P.CLIENTS: K}
    assert rec.spans["spans"][P.STEP]["calls"] == joint < live


def test_a_profiled_round_lands_in_the_trace_and_computes_the_same(first_round, tmp_path):
    plain = first_round[2]
    tr = _trainer()
    with P.trace_round(str(tmp_path)):
        traced = tr.run_round(0)
    assert traced.spans["profiled"] and not plain.spans["profiled"]
    assert traced.client_losses == plain.client_losses
    (path,) = tmp_path.glob("trace_*.json")
    cats = {e.get("name"): e.get("cat") for e in json.loads(path.read_text())["traceEvents"]}
    for name in (P.STEP, P.CLIENT_SETUP, P.ROUND, P.LOCAL_PASS):
        assert cats.get(name) == "cpu_op", name  # a user annotation would steal kernels


def test_no_host_event_without_a_profiler(first_round, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler event opened with no profiler recording")

    monkeypatch.setattr(P, "_host_event", refuse)
    rec = _trainer().run_round(0)
    assert rec.spans["spans"][P.STEP]["calls"] > 0


class _Event:
    """A CUDA event's interface on the CPU: done once ``done`` is set, each
    ``at`` ms after the start of time."""

    clock = 0.0
    waits = 0

    def __init__(self, enable_timing=False):
        self.done, self.at = False, None

    def record(self):
        _Event.clock += 2.0
        self.at = _Event.clock

    def query(self):
        return self.done

    def synchronize(self):
        _Event.waits += 1

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.at - self.at


def test_device_spans_resolve_their_events_without_waiting(monkeypatch):
    made = []

    def event(**kw):
        made.append(_Event(**kw))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized"))
    cuda = torch.device("cuda")
    with P.round_record(0) as rec:
        with P.span("a", cuda):
            pass
        with P.span("b", cuda):
            pass
        made[0].done = made[1].done = True  # the device passed a, not b
    a, b = rec["spans"]["a"], rec["spans"]["b"]
    assert (a["device_ns"], a["device_calls"]) == (2_000_000, 1)
    assert (b["device_ns"], b["device_calls"]) == (0, 0)
    made[3].done = made[2].done = True
    P.resolve()
    assert (b["device_ns"], b["device_calls"]) == (2_000_000, 1)
    assert _Event.waits == 0
