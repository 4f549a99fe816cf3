"""attn_share_pct (%): the device time of the window attention's fused
kernels (``attn_roofline.KERNELS``) launched inside the traced round's local
passes, over those passes' device-busy time (the union of their operations'
intervals, as ``device_ms_per_step`` counts it): how much of the step the
attention takes. No such kernel reads nothing. Moves the cell's step time
(``peak_mem_gib`` where the rate is per layer)."""

from pathlib import Path

from fedbench.cell import load_file_module
from fedbench.trace import union

KERNELS = load_file_module(Path(__file__).with_name("attn_roofline.py")).KERNELS


def read(rec: dict):
    if rec["how"] is None:
        return None
    local = [(n, s, e) for n, s, e, loc in rec["ops"] if loc]
    attn = sum(e - s for n, s, e in local if any(k in n for k in KERNELS))
    busy = sum(e - s for s, e in union((s, e) for _n, s, e in local))
    return 100.0 * attn / busy if attn and busy else None
