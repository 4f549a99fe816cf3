"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m fedbench.calibrate --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out <file.jsonl>]

For each seed of ``--seeds``: the program's set-up rounds against the plain
reference (the lower reading is the largest over them). For each of
``--control-seeds``: the control, the reference computed with fp8 operands
in the program's place (the configuration states bfloat16), against the
float32 reference. For each of ``--fault-seeds``: each planted fault of
``fedbench.reference.fedmlp.FAULTS`` in the reference put in the program's
place. (A state left unchanged reads 1 by construction and needs no run.)
Every reading is one JSON line, on standard output and in ``--out``. The
cells run on the card only: without one it exits 2 and reads nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from fedbench import compare, harness
from fedbench.cell import load_cell
from fedbench.reference import fedmlp as ref_fedmlp


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fedbench.calibrate: {a.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    from fedmlp_tpu_torch.ops import _build

    _build.build_all()
    device = torch.device("cuda")
    sink = open(a.out, "a") if a.out else None

    def emit(kind: str, seed: int, read: dict, **extra) -> None:
        line = json.dumps({"workload": a.workload, "kind": kind, "seed": seed, **read, **extra})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    jobs = ([("program", s) for s in _seeds(a.seeds)]
            + [("control", s) for s in _seeds(a.control_seeds)]
            + [("fault", s) for s in _seeds(a.fault_seeds)])
    try:
        for kind, seed in jobs:
            t0 = time.perf_counter()
            trainer, inputs, prog = harness.program_setup(cell, seed, device)
            t_prog = time.perf_counter() - t0
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ref = harness.reference_rounds(cell, seed, inputs)
            t_ref = time.perf_counter() - t0
            emit("program", seed, compare.readings(prog, ref, inputs["weights"]),
                 program_s=t_prog, reference_s=t_ref)
            if kind == "control":
                t0 = time.perf_counter()
                ctl = harness.reference_rounds(cell, seed, inputs, quant=True)
                emit("control_fp8", seed, compare.readings(ctl, ref, inputs["weights"]),
                     seconds=time.perf_counter() - t0)
            if kind == "fault":
                for fault in ref_fedmlp.FAULTS:
                    bad = harness.reference_rounds(cell, seed, inputs, fault=fault)
                    emit("fault_" + fault, seed, compare.readings(bad, ref, inputs["weights"]))
            del inputs, prog, ref
            gc.collect()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
