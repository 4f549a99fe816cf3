"""Losses of the ported slice, and the rampups that weight them."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, pos_weight=None):
    """Elementwise, unreduced BCE with logits, ``BCEWithLogitsLoss(
    reduction='none', pos_weight=...)`` semantics:
    loss = −(pos_w·y·log σ(x) + (1 − y)·log(1 − σ(x)))."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    return -(pw * targets * log_p + (1.0 - targets) * log_not_p)


def bce_on_probs(probs: torch.Tensor, targets: torch.Tensor, weight=None):
    """Elementwise BCE on probabilities (reference: utils/FedNoRo.py:22).

    ``F.binary_cross_entropy`` is exactly what the JAX package imitates in
    ``fedmlp_tpu/ops/losses.py::bce_on_probs``: each log term is clamped at
    −100, and its backward is (p − y) / max(p·(1 − p), 1e-12), finite at
    p ∈ {0, 1} where autodiff through the clamp would give 0·∞ (the JAX
    package's ``_bce_core_bwd`` copies that formula). Runs in float32 outside
    autocast, which refuses this function."""
    with torch.autocast(probs.device.type, enabled=False):
        loss = F.binary_cross_entropy(probs.float(), targets.float(),
                                      reduction="none")
    if weight is not None:
        loss = loss * weight
    return loss


# ----------------------------------------------------------------------
# Rampups (host-side floats, computed with numpy)
# ----------------------------------------------------------------------

def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(−5(1 − t)²) rampup (reference: utils/local_training.py:83-90)."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def sigmoid_rampup_bounded(current: float, begin: float, end: float) -> float:
    """FedNoRo's rampup, clipped to [begin, end] (reference:
    utils/FedNoRo.py:72-81)."""
    current = float(np.clip(current, begin, end))
    phase = 1.0 - (current - begin) / (end - begin)
    return float(np.exp(-5.0 * phase * phase))
