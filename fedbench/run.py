"""The benchmark of ``fedmlp_tpu_torch``: one run of one cell.

    python3 -m fedbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

prints, as its last line, one JSON object: ``correct``, ``attempted`` and
``failed`` (the window's rounds, and those that raised or gave a non-finite
loss), ``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``;
last, ``checks``, each number of the correctness check beside its limit
(also the last lines on standard error). Without a CUDA card, or with fewer
than the cell asks for, it exits 2 and prints no result; with JAX or the JAX
package loaded once the window has closed, 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from fedbench.cell import ROOT, load_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedmlp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """[(name, unit)] of the ``kind`` ('end_to_end' or 'per_layer') metrics
    that ``workload`` reports."""
    return [(m["name"], m["unit"]) for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"unread ({err})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".fedbench_cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process, few threads: the host's share of a step is Python's dispatch
    os.environ["OMP_NUM_THREADS"] = "1"

    import torch

    torch.set_num_threads(1)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fedbench: {a.workload} needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)

    from fedbench.harness import run_cell

    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START,
                   metrics=cell_metrics(bench, a.workload, "per_layer"))
    found = forbidden_modules()
    if found:
        print(f"fedbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    want = cell_metrics(bench, a.workload, "end_to_end" if not a.trace else "per_layer")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if a.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {n: out["metrics"][n] for n, _u in want if n in out["metrics"]},
            "device": device}
    if a.trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {n: {k: v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)
                          for k, v in c.items()} for n, c in out["checks"].items()}
    print(f"fedbench: card {power_limit()}", flush=True)
    print(f"fedbench readings {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"fedbench check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
