"""What the program's own tracing (``fedmlp_tpu_torch/utils/profiling.py``)
left in this process, for the readers of ``program_span`` metrics: the
round records, or None where the program keeps none (a program without the
recorder: its readers then read nothing)."""

from __future__ import annotations


def _profiling():
    try:
        from fedmlp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def window_rounds():
    """The round records a host-time metric reads, of the last
    ``HISTORY_ROUNDS`` of the process: not profiled (the profiler doubles a
    round's host time) and after the process's first (which pays first
    calls); or None."""
    history = getattr(_profiling(), "HISTORY", None)
    if history is None:
        return None
    return [r for r in history if not r["profiled"] and r["seq"] > 0]


def host_ns(rec: dict, *names: str) -> int:
    """Host nanoseconds of the spans ``names`` in record ``rec``."""
    return sum(rec["spans"][n]["host_ns"] for n in names if n in rec["spans"])
