"""device_idle_pct (%): the share of a round's wall clock in which no device
operation runs: one minus the traced round's device-busy seconds (the union
of its operations' intervals, not their sum) over the median wall clock of
the same run's untraced rounds, since the profiler's own host work lengthens
the traced round's wall (the traced wall stays in the breakdown). Moves
``train_img_per_s``."""

from fedbench.trace import busy_window_s


def read(rec: dict):
    busy, _traced_wall = busy_window_s(rec)
    wall = (rec.get("untraced") or {}).get("median_round_s", 0.0)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
