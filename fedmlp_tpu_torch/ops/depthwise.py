"""Depthwise-convolution backends of the EfficientNet blocks (port of
``fedmlp_tpu/ops/depthwise.py``), NCHW, filter ``[C, 1, k, k]``.

* ``depthwise_taps``: the k×k depthwise convolution as the sum of k²
  shifted elementwise products, summed in JAX's order (row-major over the
  taps, ``out = term``, then ``out + term``); autograd differentiates the
  plain ops.
* ``depthwise_dense``: one full convolution with the diagonal-masked dense
  filter ``wd[o, i] = w[o, 0] · δ(o, i)`` ``[C, C, k, k]``: the same sums,
  the off-diagonal taps adding exact zeros.
* ``ops/dw_conv.py::dw_conv``: the grouped forward with JAX's rerouted
  backward.
* ``ops/dw_pallas.py::dw_conv_pallas``: the grouped forward with the
  hand-written backward kernels.

Each has a module beside it that stands in for the grouped
``nn.Conv2d(C, C, k, stride, groups=C, bias=False)`` on a TF-SAME padded
input, with the same one parameter (``weight`` [C, 1, k, k], float32), so a
``state_dict`` is the same whichever backend built the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.ops.dw_conv import dw_conv, pad_pairs
from fedmlp_tpu_torch.ops.dw_pallas import dw_conv_pallas


def depthwise_taps(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """x [B, C, H, W], w [C, 1, k, k] → [B, C, H', W']; ``pads`` is
    ((top, bottom), (left, right))."""
    k = w.shape[-1]
    x = pad_pairs(x, pads)
    H, W = x.shape[2], x.shape[3]
    out = None
    for dy in range(k):
        for dx in range(k):
            sl = x[:, :, dy:H - k + 1 + dy:stride, dx:W - k + 1 + dx:stride]
            term = sl * w[:, 0, dy, dx].view(1, -1, 1, 1)
            out = term if out is None else out + term
    return out


def depthwise_dense(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """The depthwise convolution as one dense ``F.conv2d`` with the filter
    ``w`` spread onto the diagonal of [C, C, k, k]."""
    C = w.shape[0]
    eye = torch.eye(C, dtype=w.dtype, device=w.device)
    wd = w[:, 0][:, None] * eye[:, :, None, None]
    return F.conv2d(pad_pairs(x, pads), wd.to(x.dtype), stride=stride)


class DepthwiseModule(nn.Module):
    """A depthwise backend as a module: ``forward(x, pads)`` casts x and the
    weight to the compute type (the autocast type when autocast is on for
    x's device, else x's own type), so in bfloat16 the op sees the
    bfloat16-rounded weight and the float32 parameter receives its gradient
    through the cast, then calls the backend's ``op(x, w, stride, pads)``.
    ``pads`` is ((top, bottom), (left, right)), computed by the caller from
    the size of the input it hands over."""

    op = None

    def __init__(self, features: int, kernel: int, stride: int):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.weight = nn.Parameter(torch.empty(features, 1, kernel, kernel))

    def forward(self, x: torch.Tensor, pads) -> torch.Tensor:
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                 else x.dtype)
        return type(self).op(x.to(dtype), self.weight.to(dtype), self.stride,
                             tuple(tuple(p) for p in pads))


class DepthwiseTaps(DepthwiseModule):
    """k² shifted products (:func:`depthwise_taps`)."""

    op = staticmethod(depthwise_taps)


class DepthwiseDense(DepthwiseModule):
    """One dense convolution with the diagonal filter (:func:`depthwise_dense`)."""

    op = staticmethod(depthwise_dense)


class DepthwiseReroute(DepthwiseModule):
    """The grouped forward with the rerouted backward (``ops/dw_conv.py``)."""

    op = staticmethod(dw_conv)


class DepthwisePallas(DepthwiseModule):
    """The grouped forward with the backward kernels of
    ``ops/dw_pallas.py``."""

    op = staticmethod(dw_conv_pallas)
