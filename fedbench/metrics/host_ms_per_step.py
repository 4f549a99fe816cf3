"""host_ms_per_step (ms): the host's milliseconds a local step, from the
program's spans: over each unprofiled round after the process's first, the
``fedmlp.step`` spans' host time over the ``fedmlp.steps`` counter (live
steps run); the median over those rounds. Beside ``device_ms_per_step`` it
says whether the host or the card sets the step's pace. Moves
``train_img_per_s``."""

import statistics

from fedbench.program_spans import host_ns, window_rounds


def read(rec: dict):
    rounds = window_rounds()
    per_step = [host_ns(r, "fedmlp.step") / 1e6 / r["counters"]["fedmlp.steps"]
                for r in rounds or () if r["counters"].get("fedmlp.steps")]
    return statistics.median(per_step) if per_step else None
