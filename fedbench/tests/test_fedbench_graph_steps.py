"""The reader of ``graph_step_pct`` on a synthetic history of round
records, and on a program without the graph counter, as a parent commit
before the per-client loop's CUDA graph."""

import collections
import types

import pytest

import fedmlp_tpu_torch.utils
from fedbench import cell as C
from fedmlp_tpu_torch.utils import profiling

READ = C.load_file_module(C.ROOT / "fedbench" / "metrics" / "graph_step_pct.py").read


def _round(seq: int, profiled: bool, graph_steps: int) -> dict:
    counters = {"fedmlp.steps": 8, "fedmlp.clients": 2}
    if graph_steps:
        counters["fedmlp.graph_steps"] = graph_steps
    return {"round": seq, "seq": seq, "profiled": profiled, "spans": {},
            "counters": counters}


@pytest.fixture
def history(monkeypatch):
    """Round 0 (the process's first) replays 5 of its 8 steps, round 2 is
    profiled and replays none; rounds 1, 3 and 4 replay 8, 8 and 4."""
    rounds = [_round(0, False, 5), _round(1, False, 8), _round(2, True, 0),
              _round(3, False, 8), _round(4, False, 4)]
    monkeypatch.setattr(profiling, "HISTORY", collections.deque(rounds))


def test_the_share_of_the_unprofiled_rounds_after_the_first(history):
    assert READ({}) == pytest.approx(100.0 * 20 / 24)


def test_rounds_without_a_replay_read_zero(monkeypatch):
    monkeypatch.setattr(profiling, "HISTORY", collections.deque(
        [_round(0, False, 0), _round(1, False, 0)]))
    assert READ({}) == 0.0


def test_a_program_without_the_graph_counter_reads_nothing(history, monkeypatch):
    bare = types.ModuleType("fedmlp_tpu_torch.utils.profiling")
    bare.HISTORY = profiling.HISTORY
    monkeypatch.setattr(fedmlp_tpu_torch.utils, "profiling", bare)
    assert READ({}) is None


def test_an_empty_history_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "HISTORY", collections.deque())
    assert READ({}) is None
