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
