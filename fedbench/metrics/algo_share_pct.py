"""algo_share_pct (%): the share of the untraced rounds' wall clock spent
outside their local passes (``Trainer.local_pass``, timed by events on the
device's stream): the algorithm's own work (FedMLP's harvests and host
tagging, ``algos/fedmlp.py``) and the aggregation (``fl/aggregate.py``).
Untraced, because the profiler's host work lengthens a traced round's local
passes far more than the rest. Moves ``train_img_per_s``."""


def read(rec: dict):
    u = rec.get("untraced")
    if not u or u["seconds"] <= 0 or u["local_s"] <= 0:
        return None
    return 100.0 * (1.0 - u["local_s"] / u["seconds"])
