"""The readers of the program's spans (``program_span`` metrics) on a
synthetic history, and on a program that keeps none, as a parent commit
without the recorder."""

import collections
import types

import pytest

import fedmlp_tpu_torch.utils
from fedbench import cell as C
from fedmlp_tpu_torch.utils import profiling

NAMES = ("host_ms_per_step", "client_setup_ms")
READ = {n: C.load_file_module(C.ROOT / "fedbench" / "metrics" / f"{n}.py").read
        for n in NAMES}
MS = 1_000_000  # ns


def _round(seq: int, profiled: bool, step_ms: float, setup_ms: float) -> dict:
    """A round of 8 steps and 2 clients: ``step_ms`` host ms a step,
    ``setup_ms`` ms of client set-up and write-back a client."""
    host = {"fedmlp.round": 1000 * MS, "fedmlp.step": int(8 * step_ms * MS),
            "fedmlp.client_setup": int(1.5 * setup_ms * MS),
            "fedmlp.client_writeback": int(0.5 * setup_ms * MS)}
    return {"round": seq, "seq": seq, "profiled": profiled,
            "spans": {n: {"calls": 1, "host_ns": ns, "self_ns": ns, "parent": None}
                      for n, ns in host.items()},
            "counters": {"fedmlp.steps": 8, "fedmlp.clients": 2}}


@pytest.fixture
def history(monkeypatch):
    """Rounds 0-5: round 0 (the process's first, 1 s) at 90 ms a step, round
    3 profiled at 50; the others at 20, 30, 40 and 10 ms a step."""
    rounds = [_round(0, False, 90, 9), _round(1, False, 20, 2), _round(2, False, 30, 3),
              _round(3, True, 50, 5), _round(4, False, 40, 4), _round(5, False, 10, 1)]
    monkeypatch.setattr(profiling, "HISTORY", collections.deque(rounds))


def test_readers_read_the_unprofiled_rounds_after_the_first(history):
    assert READ["host_ms_per_step"]({}) == pytest.approx(25.0)  # median of 10, 20, 30, 40
    assert READ["client_setup_ms"]({}) == pytest.approx(2.5)


def test_a_history_that_lost_its_first_round_reads_the_same(history):
    profiling.HISTORY.popleft()
    assert READ["host_ms_per_step"]({}) == pytest.approx(25.0)
    assert READ["client_setup_ms"]({}) == pytest.approx(2.5)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(fedmlp_tpu_torch.utils, "profiling",
                        types.ModuleType("fedmlp_tpu_torch.utils.profiling"))
    assert READ[name]({}) is None


@pytest.mark.parametrize("name", NAMES)
def test_an_empty_history_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(profiling, "HISTORY", collections.deque())
    assert READ[name]({}) is None
