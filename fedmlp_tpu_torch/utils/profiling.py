"""The port's tracing: spans and counters at the program's layer boundaries,
and ``trace_round``, a Chrome trace of a round (the JAX package's
``fedmlp_tpu/utils/profiling.py`` has only the trace).

``span(name)`` times the enclosed work on the host's clock
(``time.perf_counter_ns``); spans nest, and each name keeps, in the record
open at the time, its calls, host nanoseconds, self nanoseconds (its time
less what its child spans cover) and its parent's name. ``count(name, n)``
adds to a counter of the same record. ``Trainer.run_round`` opens a round
record (``round_record``) around its ``ROUND`` span and the evaluation
after it; everything outside a round lands in the one ``SETUP`` record. A
closed round record goes onto ``RoundRecord.spans`` and into ``HISTORY``
(the last ``HISTORY_ROUNDS`` rounds of the process), which the benchmark's
readers take.

A span given a CUDA device also records a CUDA event pair on the current
stream; the pair is resolved into ``device_ns`` (with ``device_calls``, the
pairs resolved) when the round closes, after the read of the losses that
the round makes anyway, by ``Event.query``: nothing here synchronizes.

While a torch profiler records, each span also opens a host event of its
name (``_RecordFunctionFast``, an operator-scope record function), so it
lands in the kineto trace on the profiler's clock and names what the host
did in each idle gap of the device. It opens no device-side annotation: a
user annotation (``torch.profiler.record_function``) inside another takes
the kernels launched in it from the outer one's device annotation, which
the benchmark places a traced round's kernels by (``fedbench/trace.py``;
with user annotations here, a traced ResNet-18 round on an H100 placed none
of its 119716 kernels).
Without a profiler a span costs a flag check, two clock reads and a few
dict updates: the records are always on, as an operator's counters are.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast as _host_event
from torch.autograd import profiler as _autograd_profiler

# set-up: Trainer.__post_init__
TRAINER_INIT = "fedmlp.trainer_init"
# a round: Trainer.run_round up to its read of the losses, and its parts
ROUND = "fedmlp.round"
LOCAL_PASS = "fedmlp.local_pass"
CLIENT_SETUP = "fedmlp.client_setup"
CLIENT_WRITEBACK = "fedmlp.client_writeback"
STEP = "fedmlp.step"
VIEWS = "fedmlp.views"
GLOBAL_FORWARD = "fedmlp.global_forward"
LOSS_FORWARD = "fedmlp.loss_forward"
BACKWARD = "fedmlp.backward"
OPTIMIZER = "fedmlp.optimizer"
HARVEST = "fedmlp.harvest"
TAGGING = "fedmlp.tagging"
AGGREGATE = "fedmlp.aggregate"
EVALUATE = "fedmlp.evaluate"
LOADER_WAIT = "fedmlp.loader_wait"
LOADER_GATHER = "fedmlp.loader_gather"
# counters: live client-steps run (a joint step of n clients counts n),
# clients trained; of the per-client loop's steps, those run by a replay of
# the step's CUDA graph, and the graphs captured
STEPS = "fedmlp.steps"
CLIENTS = "fedmlp.clients"
GRAPH_STEPS = "fedmlp.graph_steps"
GRAPH_CAPTURES = "fedmlp.graph_captures"
# counters of the models' attention (``models/swin.py``): fused attention
# calls, and their rows (batch × windows × heads), of the calls autograd
# records (the trained forwards) and of those it does not (the frozen global
# forward under ``no_grad``, evaluation)
ATTN_CALLS_GRAD = "fedmlp.attn_calls_grad"
ATTN_CALLS_NOGRAD = "fedmlp.attn_calls_nograd"
ATTN_ROWS_GRAD = "fedmlp.attn_rows_grad"
ATTN_ROWS_NOGRAD = "fedmlp.attn_rows_nograd"
# counter of the ResNets' forwards (``models/resnet.py``), each of which runs
# its activations channels-last from the stem on
NHWC_FORWARDS = "fedmlp.nhwc_forwards"

HISTORY_ROUNDS = 1024
# event pairs waiting past this many are resolved at the next device span
_PENDING_MAX = 256

_now_ns = time.perf_counter_ns


def _new_record(**fields) -> dict:
    return {**fields, "spans": {}, "counters": {}}


SETUP = _new_record()
HISTORY: collections.deque = collections.deque(maxlen=HISTORY_ROUNDS)
_open = []  # the open spans, innermost last
_round = None  # the open round record
_rounds_opened = 0
_pending = []  # (span stats, start event, end event) not yet resolved


def reset() -> None:
    """Empty every record (a fresh process's state)."""
    global SETUP, _round, _rounds_opened
    SETUP = _new_record()
    HISTORY.clear()
    _open.clear()
    _pending.clear()
    _round, _rounds_opened = None, 0


def _record() -> dict:
    return SETUP if _round is None else _round


class _Span:
    """One call of a span; ``ns`` holds its host nanoseconds once closed."""

    __slots__ = ("name", "device", "t0", "child_ns", "ns", "_rf", "_start")

    def __init__(self, name: str, device):
        self.name, self.device, self.ns = name, device, 0

    def __enter__(self):
        self._rf = self._start = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _host_event(self.name)
            self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            if len(_pending) > _PENDING_MAX:
                resolve()
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self.child_ns = 0
        _open.append(self)
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        ns = self.ns = _now_ns() - self.t0
        _open.pop()
        parent = _open[-1] if _open else None
        if parent is not None:
            parent.child_ns += ns
        spans = _record()["spans"]
        stats = spans.get(self.name)
        if stats is None:
            stats = spans[self.name] = {"calls": 0, "host_ns": 0, "self_ns": 0,
                                        "parent": parent.name if parent else None}
        stats["calls"] += 1
        stats["host_ns"] += ns
        stats["self_ns"] += ns - self.child_ns
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stats.setdefault("device_ns", 0)
            stats.setdefault("device_calls", 0)
            _pending.append((stats, self._start, end))
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, device=None) -> _Span:
    """A context manager timing the enclosed work as ``name``; with a CUDA
    ``device`` (a ``torch.device``) also on the device's current stream."""
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open record."""
    now = counters()
    now[name] = now.get(name, 0) + n


def counters() -> dict:
    """The open record's counters {name: n} (the dict itself)."""
    return _record()["counters"]


def resolve() -> None:
    """Add to each device span the device time of every event pair the
    device has passed (``Event.query``, which does not wait); the others
    stay pending."""
    left = []
    for stats, start, end in _pending:
        if end.query():
            stats["device_ns"] += round(start.elapsed_time(end) * 1e6)
            stats["device_calls"] += 1
        else:
            left.append((stats, start, end))
    _pending[:] = left


@contextlib.contextmanager
def round_record(rnd: int):
    """Open the record of round ``rnd`` around the enclosed work, and yield
    it: {'round', 'seq' (rounds opened before it in the process),
    'profiled' (a torch profiler was recording when it began), 'spans'
    {name: {'calls', 'host_ns', 'self_ns', 'parent'[, 'device_ns',
    'device_calls']}}, 'counters' {name: n}}. On closing it joins
    ``HISTORY`` and its event pairs are resolved."""
    global _round, _rounds_opened
    rec = _round = _new_record(round=int(rnd), seq=_rounds_opened,
                               profiled=bool(_autograd_profiler._is_profiler_enabled))
    _rounds_opened += 1
    try:
        yield rec
    finally:
        _round = None
        HISTORY.append(rec)
        resolve()


def round_summary(rec: dict) -> str:
    """One log line's split of a round record: host ms a step, client
    set-up ms (set-up and write-back) a client, the local passes' and the
    aggregation's device ms, steps and clients."""
    spans, counters = rec["spans"], rec["counters"]
    steps, clients = counters.get(STEPS, 0), counters.get(CLIENTS, 0)

    def host_ms(*names):
        return sum(spans[n]["host_ns"] for n in names if n in spans) / 1e6

    def device_ms(name):
        s = spans.get(name)
        if s is None or "device_ns" not in s or s["device_calls"] < s["calls"]:
            return "-"
        return f"{s['device_ns'] / 1e6:.1f}"

    step = f"{host_ms(STEP) / steps:.2f}" if steps else "-"
    setup = (f"{host_ms(CLIENT_SETUP, CLIENT_WRITEBACK) / clients:.2f}" if clients
             else "-")
    return (f"host {step} ms a step, client set-up {setup} ms, local pass "
            f"{device_ms(LOCAL_PASS)} device ms, aggregate {device_ms(AGGREGATE)} "
            f"device ms, {steps} steps, {clients} clients")


@contextlib.contextmanager
def trace_round(log_dir: str | None):
    """A ``torch.profiler`` trace of the enclosed round, CPU activity and,
    with a card, CUDA activity, written to ``<log_dir>/trace_<pid>_<ns>.json``
    (Chrome trace format; chrome://tracing or Perfetto read it). The spans
    above appear in it by name. Yields the profiler, or None and records
    nothing when ``log_dir`` is falsy."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if len(activities) > 1:  # the queued kernels land inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
