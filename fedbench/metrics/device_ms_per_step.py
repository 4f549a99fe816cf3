"""device_ms_per_step (ms): device-busy milliseconds (the union of the
operations' intervals) of the operations launched inside the traced round's
local passes, over the local steps they hold: the model's forward, backward
and optimizer work on the card. Moves ``train_img_per_s``."""

from fedbench.trace import union


def read(rec: dict):
    if rec["how"] is None or not rec["steps"]:
        return None
    busy = sum(e - s for s, e in union((s, e) for _n, s, e, loc in rec["ops"] if loc))
    return busy / 1e6 / rec["steps"] if busy else None
