"""Losses of the ported slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
