"""Profiling hooks (port of ``fedmlp_tpu/utils/profiling.py``).

The reference's profiling is commented-out time.time() deltas
(utils/local_training.py:1022-1060 etc., SURVEY.md §5). Here:
  * ``PhaseTimer`` — wall-clock seconds accumulated per named phase;
  * ``trace_round`` — a ``torch.profiler`` trace of the enclosed work (CPU
    and, where there is a card, CUDA activity) written under a directory as
    a Chrome trace.
Neither is wired into the ``Trainer``, as in the JAX package: a caller
wraps what it wants to see.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase across calls. With a
    CUDA ``device`` each phase synchronizes the device when it starts and
    when it ends, so its seconds hold the device work it queued (what the
    JAX package's callers get from ``block_until_ready``)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name],
                   "mean_s": self.totals[name] / max(1, self.counts[name])}
            for name in sorted(self.totals)
        }


@contextlib.contextmanager
def trace_round(log_dir: str | None):
    """A ``torch.profiler`` trace of the enclosed round, CPU activity and,
    with a card, CUDA activity, written to ``<log_dir>/trace_<pid>_<ns>.json``
    (Chrome trace format; chrome://tracing or Perfetto read it). Yields the
    profiler, or None and records nothing when ``log_dir`` is falsy."""
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
