"""FedAVG baseline (port of ``fedmlp_tpu/algos/fedavg.py``).

Local step (reference ``LocalUpdate.train``, utils/local_training.py:628-703):
weighted BCEWithLogits(pos_weight=loss_w) over ALL classes — missing labels
are treated as true negatives — normalized by (batch_size · n_classes).
Server: dataset-size FedAvg (reference: main.py:317-319), the trainer's
default aggregation.
"""

from __future__ import annotations

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.ops import losses as L

VIEW_MODE = "single"
NEEDS_GLOBAL = False


def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits = apply_train(model, views["x"], generator)
    elem = L.bce_with_logits(logits.float(), labels, ctx["loss_w"])
    elem = masked_rows(elem, svalid)
    B, C = logits.shape  # the padded batch: loss.sum()/(batch*n_classes)
    return elem.sum() / (B * C)
