"""VGG 11/13/16/19 in NCHW, after ``fedmlp_tpu/models/vgg.py``
(torchvision's topology; flax's names ``conv{i}``, ``fc1``, ``fc2``,
``head``, every conv and ``fc1``/``fc2`` with a bias).

Before the classifier the activation is pooled by the JAX package's own
rule, not by ``adaptive_avg_pool2d``: unchanged at a side of 7, a mean
over 7x7 equal blocks when the side divides by 7, else an average pool
with window and stride max(1, side // 7). It is then flattened in (h, w, c)
order, the order of the flax kernel of ``fc1`` (and of
``tools/convert_torch_weights.py::convert_vgg``). So ``fc1``'s width
follows the image size, which flax infers at init and the port takes as
``image_size``. Dropout 0.5 after ``fc1`` and after ``fc2``, in train mode
only with a generator. The feature is the 4096-wide activation after the
second dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import make_head
from fedmlp_tpu_torch.models.layers import dropout

_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _pool_window(side: int) -> int:
    """The pre-classifier pool's window (and stride) for a square side."""
    if side == 7:
        return 1
    return side // 7 if side % 7 == 0 else max(1, side // 7)


class VGG(nn.Module):
    def __init__(self, cfg, num_classes: int, image_size: int = 224,
                 normed_head: bool = False, dropout_rate: float = 0.5):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dropout_rate = dropout_rate
        ch, side, ci = 3, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                self.add_module(f"conv{ci}", nn.Conv2d(ch, v, 3, 1, 1))
                ch, ci = v, ci + 1
        side //= _pool_window(side)
        self.fc1 = nn.Linear(side * side * ch, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.head = make_head(4096, num_classes, normed_head)

    def forward(self, x: torch.Tensor, generator=None):
        ci = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{ci}")(x))
                ci += 1
        k = _pool_window(x.shape[2])
        if k > 1:
            x = F.avg_pool2d(x, k, k)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), as the flax kernel
        stochastic = self.training and generator is not None
        x = F.relu(self.fc1(x))
        if stochastic:
            x = dropout(x, self.dropout_rate, generator)
        x = F.relu(self.fc2(x))
        if stochastic:
            x = dropout(x, self.dropout_rate, generator)
        feature = x.float()
        return feature, self.head(feature)


def _make(name):
    def ctor(num_classes, **kw):
        return VGG(_CFGS[name], num_classes, **kw)

    ctor.__name__ = name
    return ctor


vgg11 = _make("vgg11")
vgg13 = _make("vgg13")
vgg16 = _make("vgg16")
vgg19 = _make("vgg19")
