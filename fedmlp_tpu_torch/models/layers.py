"""Layers with the JAX package's (flax's) semantics where PyTorch's differ."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch norm as ``flax.linen.BatchNorm``: train mode normalizes with the
    biased batch variance AND updates the running variance with it
    (``nn.BatchNorm2d`` would update with the unbiased one). ``momentum``
    is PyTorch's: the weight of the new batch statistic (flax 0.99 → 0.01).

    The batch statistics come from PyTorch's fused batch-norm kernel, run
    with scratch running buffers at momentum 1 so that they receive exactly
    the batch mean and unbiased variance; the biased variance is that times
    (n − 1)/n. No ``num_batches_tracked`` buffer, as flax keeps none."""

    def __init__(self, num_features: int, momentum: float, eps: float):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        batch_mean = torch.zeros_like(self.running_mean)
        batch_var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, batch_mean, batch_var, self.weight, self.bias,
                         True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(batch_mean * m)
            self.running_var.mul_(1.0 - m).add_(batch_var * ((n - 1) / n * m))
        return y


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-"SAME" zero padding for a k×k stride-s conv on NCHW ``x``: the
    extra pixel goes right/bottom (``_same_pads`` of the JAX EfficientNet,
    lukemelas' Conv2dStaticSamePadding)."""

    def pads(n):
        out = -(-n // s)
        total = max(0, (out - 1) * s + k - n)
        return total // 2, total - total // 2

    top, bottom = pads(x.shape[2])
    left, right = pads(x.shape[3])
    return F.pad(x, (left, right, top, bottom))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """``flax.linen.Dropout`` in train mode, drawing from ``generator``."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def drop_connect(h: torch.Tensor, rate: float, generator: torch.Generator):
    """Per-sample stochastic depth (efficientnet-pytorch ``drop_connect``)."""
    keep = 1.0 - rate
    u = torch.rand((h.shape[0], 1, 1, 1), generator=generator, device=h.device)
    return h / keep * torch.floor(keep + u).to(h.dtype)
