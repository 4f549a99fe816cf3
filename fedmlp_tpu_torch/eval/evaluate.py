"""Global / per-class evaluation and validation loss (port of
``fedmlp_tpu/eval/evaluate.py``).

  * ``global_test`` (reference: utils/evaluations.py:15-73) — the 7-metric
    suite; batched inference on the device, metrics on the host.
  * ``class_test``  (reference: utils/evaluations.py:89-133) — one class's
    BACC/R/F1/P.
  * ``val_loss``    (reference: utils/valloss_cal.py:15-43) — weighted BCE
    on a random 10% of the test set.
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.eval import metrics as M
from fedmlp_tpu_torch.ops import losses as L


def global_test(trainer, threshold: float = 0.5) -> dict:
    probs = trainer.eval_probs(trainer.global_vars, trainer.test_ds.images)
    return M.multilabel_report(trainer.test_ds.targets, probs, threshold)


def class_test(trainer, classid: int, threshold: float = 0.5) -> dict:
    probs = trainer.eval_probs(trainer.global_vars, trainer.test_ds.images)
    y = trainer.test_ds.targets
    preds = probs > threshold
    return {
        "BACC": M.bacc(y, preds, classid),
        "R": M.recall(y, preds, classid),
        "F1": M.f1_measure(y, preds, classid),
        "P": M.precision(y, preds, classid),
    }


def val_loss(trainer, frac: float = 0.1, seed: int = 0) -> float:
    """Weighted BCE on a random fraction of the test set (weight = N /
    class count of the test set), from the probabilities' logits clipped
    at 1e-7."""
    rng = np.random.RandomState(seed)
    n = len(trainer.test_ds)
    sel = rng.choice(n, max(1, int(frac * n)), replace=False)
    images = np.ascontiguousarray(trainer.test_ds.images[sel])
    targets = trainer.test_ds.targets[sel]
    counts = np.maximum(trainer.test_ds.targets.sum(0), 1e-12)
    loss_w = (n / counts).astype(np.float32)
    probs = trainer.eval_probs(trainer.global_vars, images)
    logits = np.log(np.clip(probs, 1e-7, 1 - 1e-7)) - np.log(
        np.clip(1 - probs, 1e-7, 1 - 1e-7)
    )
    elem = L.bce_with_logits(torch.from_numpy(logits.astype(np.float32)),
                             torch.from_numpy(targets.astype(np.float32)),
                             torch.from_numpy(loss_w))
    return float(elem.mean())
