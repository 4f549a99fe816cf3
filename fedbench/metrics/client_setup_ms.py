"""client_setup_ms (ms): the host's milliseconds a client spends outside its
steps in the per-client loop, from the program's spans: over each
unprofiled round after the process's first, the ``fedmlp.client_setup``
(loading the global state, building Adam) and ``fedmlp.client_writeback``
(copying the trained state out) spans' host time over the ``fedmlp.clients``
counter; the median over those rounds. Moves ``train_img_per_s``."""

import statistics

from fedbench.program_spans import host_ns, window_rounds


def read(rec: dict):
    rounds = window_rounds()
    per_client = [host_ns(r, "fedmlp.client_setup", "fedmlp.client_writeback") / 1e6
                  / r["counters"]["fedmlp.clients"]
                  for r in rounds or () if r["counters"].get("fedmlp.clients")]
    return statistics.median(per_client) if per_client else None
