"""SmallCNN — the compact test backbone of the JAX package, in NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import LinearHead
from fedmlp_tpu_torch.models.layers import BatchNorm

FEATURE_DIM = 128


class SmallCNN(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        chans = (3, 32, 64, FEATURE_DIM)
        for i in range(3):
            self.add_module(f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 3, 2, 1,
                                                  bias=False))
            # flax momentum 0.9, epsilon 1e-5
            self.add_module(f"bn{i}", BatchNorm(chans[i + 1], 0.1, 1e-5))
        self.head = LinearHead(FEATURE_DIM, num_classes)

    def forward(self, x: torch.Tensor, generator=None):
        for i in range(3):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x))
        feature = x.mean(dim=(2, 3)).float()
        return feature, self.head(feature)


def smallcnn(num_classes, **kw):
    return SmallCNN(num_classes, **kw)
