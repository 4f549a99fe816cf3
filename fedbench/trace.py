"""What a traced round leaves: the profiler's events reduced to a record the
metric readers take (``fedbench/metrics/<name>.py``), the device's busy and
window seconds, and the breakdown of device time and idle gaps.

The harness marks its own spans around the program's calls:
``fedbench.round`` (the traced round, ended by a synchronize),
``fedbench.local_pass`` (``Trainer.local_pass``) and ``fedbench.aggregate``
(``Trainer.aggregate``). A device operation belongs to a local pass when the
host launched it inside that span: its launch is found by the profiler's
correlation id, or, where the trace gives none, the operation's own time falls
inside the span's device-side annotation.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

ROUND, LOCAL, AGGREGATE = "fedbench.round", "fedbench.local_pass", "fedbench.aggregate"
NAME_CHARS = 160


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clipped_total(merged, lo, hi) -> float:
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def events_of(prof):
    """(device ops [(name, start_ns, end_ns, correlation)], device-side
    annotations [(name, start, end)], host events [(name, start, end,
    correlation)]) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, dev_notes, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            (dev_notes if e.is_user_annotation() else device).append(
                item + ((e.correlation_id(),) if not e.is_user_annotation() else ()))
        else:
            host.append(item + (e.correlation_id(),))
    return device, dev_notes, host


def record(device, dev_notes, host, *, steps: int) -> dict:
    """The readers' record of one traced round: its span, the local-pass spans
    and the local steps they hold, and every device op with whether it
    belongs to a local pass (``how``: by launch, by annotation, or None when
    neither places it)."""
    spans = defaultdict(list)
    for name, s, e, _c in host:
        if name in (ROUND, LOCAL):
            spans[name].append((s, e))
    if len(spans[ROUND]) != 1:
        raise ValueError(f"a traced round needs one {ROUND} span, found {len(spans[ROUND])}")
    lo, hi = spans[ROUND][0]
    local = sorted(spans[LOCAL])
    launch = {c: s for name, s, _e, c in host if c and "aunch" in name}
    ops = [op for op in device if lo <= op[1] <= hi or lo <= op[2] <= hi]
    matched = sum(1 for op in ops if op[3] in launch)
    notes = sorted((s, e) for name, s, e in dev_notes if name == LOCAL)

    def inside(t, sp):
        i = bisect.bisect_right(sp, (t, float("inf"))) - 1
        return i >= 0 and sp[i][0] <= t <= sp[i][1]

    if ops and matched >= 0.95 * len(ops):
        how = "launch"
        in_local = [op[3] in launch and inside(launch[op[3]], local) for op in ops]
    elif notes:
        how = "annotation"
        in_local = [inside(op[1], notes) for op in ops]
    else:
        how, in_local = None, [False] * len(ops)
    return {"round_ns": (lo, hi), "local_ns": local, "steps": steps, "how": how,
            "ops": [(n, s, e, loc) for (n, s, e, _c), loc in zip(ops, in_local)]}


def busy_window_s(rec: dict) -> tuple[float, float]:
    lo, hi = rec["round_ns"]
    merged = union((s, e) for _n, s, e, _l in rec["ops"])
    return clipped_total(merged, lo, hi) / 1e9, (hi - lo) / 1e9


def breakdown(rec: dict, host, top: int = 10) -> dict:
    """{'device_ops': the ``top`` device ops by total seconds, 'idle_gaps':
    the seconds the device sat idle in the round, by what the host was doing
    at the middle of each gap (the innermost host event open then)}."""
    by_name = defaultdict(float)
    for n, s, e, _l in rec["ops"]:
        by_name[n] += (e - s) / 1e9
    lo, hi = rec["round_ns"]
    merged = union((max(s, lo), min(e, hi)) for _n, s, e, _l in rec["ops"] if e > lo and s < hi)
    edges = [lo] + [t for iv in merged for t in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    events = sorted((s, e, n) for n, s, e, _c in host if n != ROUND and s <= hi and e >= lo)
    by_host, heap, i = defaultdict(float), [], 0
    for a, b in gaps:  # gaps come in time order
        mid = (a + b) / 2
        while i < len(events) and events[i][0] <= mid:
            s, e, n = events[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        by_host[heap[0][2] if heap else "(no host event)"] += (b - a) / 1e9

    def top_of(d):  # kernel names shortened: templates run to kilobytes
        return [[n[:NAME_CHARS], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_name), "idle_gaps": top_of(by_host)}
