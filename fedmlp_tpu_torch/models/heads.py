"""Classification heads. Every backbone forward returns ``(feature, logits)``."""

from __future__ import annotations

import torch
from torch import nn


class LinearHead(nn.Module):
    """Plain linear classifier, named ``fc`` as in the JAX package. It runs
    in float32 even under autocast, as the JAX head does (its Dense keeps
    dtype float32 whatever the backbone's compute type)."""

    def __init__(self, in_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return self.fc(x.float())


class FCNormHead(nn.Module):
    """Cosine-normalized classifier with scale ``s`` = 30 (the JAX package's
    ``FCNormHead``): s · (x/|x|) · (w/|w|), columns of w normalized.

    ``weight`` is [in_features, num_classes], flax's own layout, and holds
    what flax's parameter holds: a U(0, 2) draw that the forward shifts by
    −1, so the effective weight is U(−1, 1) and the flax variable maps onto
    it unchanged. Float32 under autocast, as ``LinearHead``."""

    def __init__(self, in_features: int, num_classes: int, s: float = 30.0):
        super().__init__()
        self.s = s
        self.weight = nn.Parameter(torch.empty(in_features, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            w = self.weight - 1.0
            xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                                 min=1e-12)
            wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True),
                                 min=1e-12)
            return self.s * (xn @ wn)


def make_head(in_features: int, num_classes: int, normed: bool = False) -> nn.Module:
    """The task head every backbone names ``head``."""
    return (FCNormHead if normed else LinearHead)(in_features, num_classes)
