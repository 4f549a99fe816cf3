"""FedAVG baseline (port of ``fedmlp_tpu/algos/fedavg.py``).

Local step (reference ``LocalUpdate.train``, utils/local_training.py:628-703):
weighted BCEWithLogits(pos_weight=loss_w) over ALL classes — missing labels
are treated as true negatives — normalized by (batch_size · n_classes).
Server: dataset-size FedAvg (reference: main.py:317-319), the trainer's
default aggregation.
"""

from __future__ import annotations

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.models.stacked import stacked_apply
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


def stacked_loss_fn(model, svars, views, sample, svalid, ctx, generator, scalars):
    """``loss_fn`` for all K clients in one stacked forward
    (``models/stacked.py``); returns (summed loss, per-client losses [K], new
    running statistics)."""
    (_, logits), new_stats = stacked_apply(model, svars, views["x"], True, generator)
    elem = L.bce_with_logits(logits.float(), sample["labels"], ctx["loss_w"][:, None, :])
    elem = masked_rows(elem, svalid)
    K, B, C = logits.shape
    loss_k = elem.sum((1, 2)) / (B * C)
    return loss_k.sum(), loss_k, new_stats
