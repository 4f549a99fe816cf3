"""attn_roofline (%): the window attention's fused kernels (PyTorch's
memory-efficient attention, the backend ``models/swin.py`` pins on the card:
``fmha_cutlassF`` forward, ``fmha_cutlassB`` backward) as a share of their
roofline in the traced round. The least time is the larger of the calls'
FLOPs over the card's dense peak in the configuration's compute type and
their bytes over its HBM bandwidth, forward and backward (``call_flops``,
``call_bytes``), reckoned from the profiled round's attention counters
(``profiling.HISTORY``: calls and rows, a row being one window of one head
of one image) and the configuration's window and head width; divided by the
device time of those kernels in the trace. No such kernel in the trace, or
another count of forward launches than of calls, reads nothing. Moves the
cell's step time (``peak_mem_gib`` where the rate is per layer)."""

from __future__ import annotations

import json
from pathlib import Path

FORWARD, BACKWARD = "fmha_cutlassF", "fmha_cutlassB"
KERNELS = (FORWARD, BACKWARD)
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def call_flops(rows: int, tokens: int, head_dim: int, backward: bool) -> int:
    """Multiply-add FLOPs of ``rows`` attention rows of ``tokens`` × ``tokens``
    scores at ``head_dim``: forward q·kᵀ and p·v, 2·N²·d each; the backward's
    dv, dp, dq and dk, 2·N²·d each (its recomputation of q·kᵀ not counted)."""
    return rows * 2 * tokens * tokens * head_dim * (2 + (4 if backward else 0))


def call_bytes(rows: int, tokens: int, head_dim: int, element: int, backward: bool) -> int:
    """Bytes each row needs at the least, each input read once and each output
    written once: forward q, k, v in and o out, plus the row's log-sum-exp
    (float32) where autograd records the call; backward q, k, v, o and dO in
    with the log-sum-exp, dq, dk and dv out. The bias and the shift mask are
    shared by every image of the batch ([windows, heads, N, N] at most) and
    their reads and the bias gradient's writes are left out."""
    block = tokens * head_dim * element
    fwd = 4 * block + (4 * tokens if backward else 0)
    return rows * (fwd + (5 * block + 4 * tokens + 3 * block if backward else 0))


def geometry(root: Path | None = None):
    """(tokens a window, head width, element bytes) of the cells this metric
    lists in ``BENCHMARK.json``, from their configuration files, or None
    where they do not agree on one. The harness does not hand a reader the
    running cell's configuration, so a second attention cell of another
    window or head width would read nothing in both cells until the
    harness's ``rec`` carries the cell's configuration (an edit to
    ``harness.py``, which a benchmark change makes)."""
    from fedbench.cell import ROOT

    root = root or ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    stem = Path(__file__).stem
    cells = {c for m in bench["per_layer"] if m["name"].split(".")[0] == stem
             for c in m.get("workloads", ())}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    found = set()
    for w in bench["workloads"]:
        if w["name"] in cells:
            cfg = json.loads((root / files[w["config"]]).read_text())
            found.add((cfg["window_size"] ** 2, cfg["head_dim"],
                       ELEMENT_BYTES[cfg["compute_dtype"]]))
    return found.pop() if len(found) == 1 else None


def profiled_counters():
    """The attention counters of the profiled round, or None."""
    try:
        from fedmlp_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "ATTN_CALLS_GRAD"):
        return None
    rounds = [r for r in profiling.HISTORY if r["profiled"]]
    if not rounds:
        return None
    c = rounds[-1]["counters"]
    return {"calls": c.get(profiling.ATTN_CALLS_GRAD, 0) + c.get(profiling.ATTN_CALLS_NOGRAD, 0),
            "rows_grad": c.get(profiling.ATTN_ROWS_GRAD, 0),
            "rows_nograd": c.get(profiling.ATTN_ROWS_NOGRAD, 0)}


def least_seconds(counts: dict, geo, peak_flops: float, peak_bytes_per_s: float) -> float:
    tokens, d, element = geo
    flops = (call_flops(counts["rows_grad"], tokens, d, True)
             + call_flops(counts["rows_nograd"], tokens, d, False))
    moved = (call_bytes(counts["rows_grad"], tokens, d, element, True)
             + call_bytes(counts["rows_nograd"], tokens, d, element, False))
    return max(flops / peak_flops, moved / peak_bytes_per_s)


def read(rec: dict):
    counts, geo = profiled_counters(), geometry()
    ops = [(n, s, e) for n, s, e, _l in rec["ops"] if any(k in n for k in KERNELS)]
    if not counts or not geo or not ops or counts["calls"] == 0:
        return None
    if sum(1 for n, _s, _e in ops if FORWARD in n) != counts["calls"]:
        return None
    seconds = sum(e - s for _n, s, e in ops) / 1e9
    return 100.0 * least_seconds(counts, geo, rec["peak_flops"],
                                 rec["peak_bytes_per_s"]) / seconds
