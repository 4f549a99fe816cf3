"""device_ops_per_step (ops): device operations launched inside the traced
round's local passes (``Trainer.local_pass``: the engine's per-client loop),
over the local steps those passes hold. Moves ``train_img_per_s``."""


def read(rec: dict):
    if rec["how"] is None or not rec["steps"]:
        return None
    n = sum(1 for op in rec["ops"] if op[3])
    return n / rec["steps"] if n else None
