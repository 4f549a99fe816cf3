"""FedAVG+FixMatch (port of ``fedmlp_tpu/algos/fixmatch.py``).

Local step (reference: utils/local_training.py:771-825): the weak view
supervises active classes; samples whose weak sigmoid is confident
(>0.8 or <0.2) on EVERY missing class get hard pseudo-labels (threshold
0.5) that supervise the strong (RandAugmentMC) view on missing classes:
    loss_sup   = BCE_w(logits_weak, y)[:, active].sum()/(B·|active|)
    loss_unsup = BCE_w_unknown(logits_strong, hard(σ(weak)))
                    [conf, missing].sum()/(n_conf·|missing|)
    loss = loss_sup (+ loss_unsup when n_conf>0 and missing classes exist)

Both sums are ``bce_with_logits_masked_sum`` (``ops/pallas_ops.py``): the
class and sample masks go in as its mask, so no [B, C] loss tensor is made.
The two train-mode forwards run in turn, so the batch-norm running
statistics are updated on the weak view and then on the strong one.

Server: FedAvg.
"""

from __future__ import annotations

import torch

from fedmlp_tpu_torch.algos.base import apply_train
from fedmlp_tpu_torch.ops.pallas_ops import bce_with_logits_masked_sum

VIEW_MODE = "weak_strong"
NEEDS_GLOBAL = False


def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits_weak = apply_train(model, views["x1"], generator)
    _, logits_strong = apply_train(model, views["x2"], generator)
    logits_weak, logits_strong = logits_weak.float(), logits_strong.float()
    B = logits_weak.shape[0]
    active, negative = ctx["active"], ctx["negative"]
    sv = svalid.to(torch.float32)

    p_weak = torch.sigmoid(logits_weak.detach())
    conf_per_class = (p_weak > 0.8) | (p_weak < 0.2)
    # confident on ALL missing classes (set intersection, reference :800-803)
    conf = (conf_per_class | (active[None, :] > 0)).all(dim=1).to(torch.float32) * sv
    hard = (p_weak > 0.5).to(torch.float32)

    sup = bce_with_logits_masked_sum(logits_weak, labels, ctx["loss_w"],
                                     sv[:, None] * active[None, :])
    loss_sup = sup / (B * torch.clamp(active.sum(), min=1.0))

    unsup = bce_with_logits_masked_sum(logits_strong, hard, ctx["loss_w_unknown"],
                                       conf[:, None] * negative[None, :])
    n_conf = conf.sum()
    n_neg = negative.sum()
    loss_unsup = unsup / torch.clamp(n_conf * n_neg, min=1.0)
    use_unsup = (n_conf > 0) & (n_neg > 0)
    return torch.where(use_unsup, loss_sup + loss_unsup, loss_sup)
