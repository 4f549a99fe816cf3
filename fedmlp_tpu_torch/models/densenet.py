"""DenseNet 121/161/169/201 in NCHW, after ``fedmlp_tpu/models/densenet.py``
(torchvision's topology; flax's names ``stem_conv``, ``block{b}_layer{l}``
with ``bn1``/``conv1``/``bn2``/``conv2``, ``trans{b}_bn``/``trans{b}_conv``,
``final_bn``, ``head``). A dense layer appends its ``growth`` new channels
to its input along the channel axis. The feature is the pooled output of
the final batch norm and ReLU: 1024 wide for 121, 2208 for 161, 1664 for
169, 1920 for 201.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import make_head
from fedmlp_tpu_torch.models.layers import BatchNorm

# (growth, layers a block, stem width)
_CFGS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, 0.1, 1e-5)  # flax momentum 0.9


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        self.bn1 = _bn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.bn2 = _bn(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([x, h], dim=1)


class DenseNet(nn.Module):
    def __init__(self, growth: int, block_config, stem: int, num_classes: int,
                 normed_head: bool = False):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, stem, 7, 2, 3, bias=False)
        self.stem_bn = _bn(stem)
        self.stages = []  # the layer names of each dense block
        ch = stem
        for bi, n_layers in enumerate(block_config):
            names = []
            for li in range(n_layers):
                name = f"block{bi}_layer{li}"
                self.add_module(name, DenseLayer(ch, growth))
                names.append(name)
                ch += growth
            if bi != len(block_config) - 1:
                self.add_module(f"trans{bi}_bn", _bn(ch))
                self.add_module(f"trans{bi}_conv", nn.Conv2d(ch, ch // 2, 1, bias=False))
                ch //= 2
            self.stages.append(names)
        self.final_bn = _bn(ch)
        self.head = make_head(ch, num_classes, normed_head)

    def forward(self, x: torch.Tensor, generator=None):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with −inf
        for bi, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if bi != len(self.stages) - 1:
                x = getattr(self, f"trans{bi}_conv")(F.relu(getattr(self, f"trans{bi}_bn")(x)))
                x = F.avg_pool2d(x, 2, 2)
        x = F.relu(self.final_bn(x))
        feature = x.mean(dim=(2, 3)).float()
        return feature, self.head(feature)


def _make(name):
    def ctor(num_classes, **kw):
        growth, cfg, stem = _CFGS[name]
        return DenseNet(growth, cfg, stem, num_classes, **kw)

    ctor.__name__ = name
    return ctor


densenet121 = _make("densenet121")
densenet161 = _make("densenet161")
densenet169 = _make("densenet169")
densenet201 = _make("densenet201")
