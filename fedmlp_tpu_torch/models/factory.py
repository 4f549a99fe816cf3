"""Model factory: name → ``nn.Module`` (``smallcnn`` and ``efficient_b*``;
the JAX package's other backbones are not ported yet), and the port's own
initialization, drawn from the same distributions as flax's defaults."""

from __future__ import annotations

import math

import torch
from torch import nn

from fedmlp_tpu_torch.models import efficientnet, smallcnn
from fedmlp_tpu_torch.models.layers import BatchNorm
from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas

MODEL_REGISTRY = {
    "smallcnn": (smallcnn.smallcnn, smallcnn.FEATURE_DIM),
    "efficient_b0": (efficientnet.efficientnet_b0, 1280),
    "efficient_b1": (efficientnet.efficientnet_b1, 1280),
    "efficient_b2": (efficientnet.efficientnet_b2, 1408),
    "efficient_b3": (efficientnet.efficientnet_b3, 1536),
    "efficient_b4": (efficientnet.efficientnet_b4, 1792),
    "efficient_b5": (efficientnet.efficientnet_b5, 2048),
    "efficient_b6": (efficientnet.efficientnet_b6, 2304),
    "efficient_b7": (efficientnet.efficientnet_b7, 2560),
}
_ALIASES = {"efficientnet_b" + str(i): "efficient_b" + str(i) for i in range(8)}


def _canon(name: str) -> str:
    n = name.lower()
    return _ALIASES.get(n, n)


def feature_dim_of(name: str) -> int:
    return MODEL_REGISTRY[_canon(name)][1]


def is_ported(name: str) -> bool:
    return _canon(name) in MODEL_REGISTRY


def build_model(name: str, num_classes: int, dw_backend: str | None = None,
                **kw) -> nn.Module:
    """The module for ``name`` with a ``num_classes``-way head, weights
    uninitialized (see :func:`init_model`). ``dw_backend`` selects the
    depthwise-conv implementation of the EfficientNet family (see
    ``MBConv``) and is not passed to other architectures."""
    key = _canon(name)
    if key not in MODEL_REGISTRY:
        raise ValueError(f"Name of model unknown {name}")
    if dw_backend and key.startswith("efficient_b"):
        kw["dw_backend"] = dw_backend
    return MODEL_REGISTRY[key][0](num_classes, **kw)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in; fan_in = in_features (per group) × receptive field."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # σ of N(0,1) cut at ±2
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_model(model: nn.Module, seed: int) -> nn.Module:
    """Initialize in place from ``seed`` as flax does by default:
    lecun-normal conv and linear kernels, zero biases, batch-norm scale 1,
    bias 0, running mean 0 and variance 1."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, DepthwisePallas)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            _lecun_normal_(w, g)
            m.weight.copy_(w)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model
