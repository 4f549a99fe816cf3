"""Shared helpers for algorithm loss functions."""

from __future__ import annotations

import torch


def apply_train(model, x, generator=None):
    """Train-mode forward → (feature, logits); updates the batch-norm
    running statistics in place. ``generator`` drives dropout and
    stochastic depth; without one they are off (as flax without a
    'dropout' rng)."""
    model.train()
    return model(x, generator=generator)


def masked_rows(loss_elem: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Zero out padding samples of a ragged batch; loss_elem [B, C]."""
    return loss_elem * svalid.to(loss_elem.dtype)[:, None]
