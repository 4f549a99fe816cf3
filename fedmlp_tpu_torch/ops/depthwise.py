"""Depthwise-convolution backends of the EfficientNet blocks (port of
``fedmlp_tpu/ops/depthwise.py``; only ``DepthwisePallas`` so far)."""

from __future__ import annotations

import torch
from torch import nn

from fedmlp_tpu_torch.ops.dw_pallas import dw_conv_pallas


class DepthwisePallas(nn.Module):
    """Drop-in for the grouped ``nn.Conv2d(C, C, k, stride, groups=C,
    bias=False)`` applied to a TF-SAME padded input: the parameter has the
    same name and shape (``weight`` [C, 1, k, k], float32), so a
    ``state_dict`` is the same whichever backend built the model. The
    forward is the framework's grouped convolution; the backward runs the
    hand-written kernels of ``ops/dw_pallas.py``.

    ``pads`` is ((top, bottom), (left, right)), computed by the caller from
    the size of the input it hands over. x and the weight are cast to the compute
    type before the op (the autocast type when autocast is on for x's
    device, else x's own type), so in bfloat16 the forward and dx see the
    bfloat16-rounded weight, and the float32 parameter receives the weight
    gradient through the cast."""

    def __init__(self, features: int, kernel: int, stride: int):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.weight = nn.Parameter(torch.empty(features, 1, kernel, kernel))

    def forward(self, x: torch.Tensor, pads) -> torch.Tensor:
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                 else x.dtype)
        return dw_conv_pallas(x.to(dtype), self.weight.to(dtype), self.stride,
                              tuple(tuple(p) for p in pads))
