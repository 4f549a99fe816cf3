"""Model factory: name → ``nn.Module``, covering the JAX package's whole
registry (``fedmlp_tpu/models/factory.py``: smallcnn, ResNet 18–152, the
SE-ResNets and SENet-154, EfficientNet B0–B7, VGG 11–19, DenseNet
121–201) with its aliases; names are case-insensitive, so the reference's
spellings ('Resnet18', 'Efficient_b0', 'Dense121', 'SENet50', 'Vgg11')
resolve too. Also the port's own initialization, drawn from the same
distributions as flax's defaults, and the loading of converted weights."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fedmlp_tpu_torch.models import densenet, efficientnet, resnet, senet, smallcnn, vgg
from fedmlp_tpu_torch.models.heads import FCNormHead
from fedmlp_tpu_torch.models.layers import BatchNorm
from fedmlp_tpu_torch.ops.depthwise import DepthwiseModule
from fedmlp_tpu_torch.weights import leaf_from_jax, to_jax_variables

MODEL_REGISTRY = {
    # test/debug backbone (not in the reference zoo)
    "smallcnn": (smallcnn.smallcnn, smallcnn.FEATURE_DIM),
    "resnet18": (resnet.resnet18, 512),
    "resnet34": (resnet.resnet34, 512),
    "resnet50": (resnet.resnet50, 2048),
    "resnet101": (resnet.resnet101, 2048),
    "resnet152": (resnet.resnet152, 2048),
    "senet50": (resnet.se_resnet50, 2048),
    "senet101": (resnet.se_resnet101, 2048),
    "senet152": (resnet.se_resnet152, 2048),
    "senet154": (senet.senet154, 2048),
    "efficient_b0": (efficientnet.efficientnet_b0, 1280),
    "efficient_b1": (efficientnet.efficientnet_b1, 1280),
    "efficient_b2": (efficientnet.efficientnet_b2, 1408),
    "efficient_b3": (efficientnet.efficientnet_b3, 1536),
    "efficient_b4": (efficientnet.efficientnet_b4, 1792),
    "efficient_b5": (efficientnet.efficientnet_b5, 2048),
    "efficient_b6": (efficientnet.efficientnet_b6, 2304),
    "efficient_b7": (efficientnet.efficientnet_b7, 2560),
    "vgg11": (vgg.vgg11, 4096),
    "vgg13": (vgg.vgg13, 4096),
    "vgg16": (vgg.vgg16, 4096),
    "vgg19": (vgg.vgg19, 4096),
    "dense121": (densenet.densenet121, 1024),
    "dense161": (densenet.densenet161, 2208),
    "dense169": (densenet.densenet169, 1664),
    "dense201": (densenet.densenet201, 1920),
}
_ALIASES = {"efficientnet_b" + str(i): "efficient_b" + str(i) for i in range(8)}
_ALIASES.update({"densenet" + s: "dense" + s for s in ("121", "161", "169", "201")})
_ALIASES.update({"se_resnet50": "senet50", "se_resnet101": "senet101",
                 "se_resnet152": "senet152"})


def _canon(name: str) -> str:
    n = name.lower()
    return _ALIASES.get(n, n)


def feature_dim_of(name: str) -> int:
    return MODEL_REGISTRY[_canon(name)][1]


def is_ported(name: str) -> bool:
    return _canon(name) in MODEL_REGISTRY


def build_model(name: str, num_classes: int, dw_backend: str | None = None,
                normed_head: bool = False, image_size: int = 224, remat: bool = False,
                remat_stages=(), **kw) -> nn.Module:
    """The module for ``name`` with a ``num_classes``-way head, weights
    uninitialized (see :func:`init_model`); ``kw`` goes to the constructor.
    ``normed_head`` puts the cosine head (``FCNormHead``) in place of the
    linear one. ``dw_backend`` selects the depthwise-conv implementation of
    the EfficientNet family (see ``MBConv``); ``image_size`` sets the width
    of VGG's ``fc1``, which flax infers from the input at init. ``remat``
    rematerializes the blocks of the EfficientNet, ResNet and SE-ResNet
    families, ``remat_stages`` (stage indices) EfficientNet's only. Each
    reaches only those architectures, and is dropped for the others, as in
    ``fedmlp_tpu/models/factory.py``."""
    key = _canon(name)
    if key not in MODEL_REGISTRY:
        raise ValueError(f"Name of model unknown {name}")
    kw["normed_head"] = normed_head
    if dw_backend and key.startswith("efficient_b"):
        kw["dw_backend"] = dw_backend
    if remat and (key.startswith("efficient_b") or key.startswith("resnet")
                  or key in ("senet50", "senet101", "senet152")):
        kw["remat"] = True
    if remat_stages and key.startswith("efficient_b"):
        kw["remat_stages"] = tuple(remat_stages)
    if key.startswith("vgg"):
        kw["image_size"] = image_size
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
    bias 0, running mean 0 and variance 1; the cosine head's parameter
    U(0, 2), the flax draw that its forward shifts to U(−1, 1)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseModule)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            _lecun_normal_(w, g)
            m.weight.copy_(w)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, FCNormHead):
            m.weight.copy_(torch.rand(m.weight.shape, generator=g) * 2.0)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


@torch.no_grad()
def load_pretrained(model: nn.Module, npz_path: str) -> tuple[int, list]:
    """Load converted weights (``tools/convert_torch_weights.py``'s npz,
    keys '<collection>/<path...>/<leaf>' in flax's layout) into ``model`` in
    place, as the JAX package's ``load_pretrained`` merges them into its
    variables: every variable of the model whose key is in the file with the
    same shape is loaded; every other one keeps its value and is listed.
    Returns (number loaded, missing keys in flax's sorted order). The head,
    which the converter leaves out, keeps its fresh init."""
    flat = dict(np.load(npz_path))
    sd = model.state_dict()
    loaded, missing = 0, []

    def walk(tree, prefix):
        nonlocal loaded
        for k in sorted(tree):
            path = prefix + (k,)
            v = tree[k]
            if isinstance(v, dict):
                walk(v, path)
                continue
            key = "/".join(path)
            src = flat.get(key)
            if src is None or src.shape != v.shape:
                missing.append(key)
                continue
            name, a = leaf_from_jax(path[0], path[1:], src)
            sd[name].copy_(torch.from_numpy(a))
            loaded += 1

    walk(to_jax_variables(sd), ())
    return loaded, missing
