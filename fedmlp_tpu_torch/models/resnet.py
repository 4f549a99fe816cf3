"""ResNet 18/34/50/101/152 and the SE-ResNets 50/101/152, after
``fedmlp_tpu/models/resnet.py`` (torchvision's topology), with their
activations channels-last.

Submodules carry flax's names, the automatic ones inside a block
(``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ...) and the explicit ones
(``stem_conv``, ``layer2_0``, ``downsample_conv``/``downsample_bn``, the SE
variants' biased ``se_reduce``/``se_expand``, ``head``), so ``weights.py``
maps weights between the two packages mechanically. Batch norm follows
flax: momentum 0.9 (0.1 here), eps 1e-5, biased variance. A block gets a
projection shortcut where its output shape differs from its input's. The
stem's 3x3/2 max-pool pads with −inf, as flax's does. The feature is the
pooled last activation: 512 wide for ResNet-18/34, 2048 for the others.
``remat`` rematerializes every block in the backward (``layers.remat``), as
JAX's ``nn.remat(block_cls)``.

The forward turns its NCHW input channels-last once, before the stem, and
every later activation keeps that layout: cuDNN's convolutions (NHWC kernels
on Hopper in bf16) take and give it without transposing, and batch norm, the
max-pool, the residual sums, ReLUs and the SE gate run ATen's channels-last
kernels on it. Shapes stay NCHW; only the strides differ. The pooled feature
is a plain ``[B, C]``. Parameters and buffers keep PyTorch's default layout,
so state dicts, the aggregation and ``weights.py`` see what they always saw.
Each forward counts ``fedmlp.nhwc_forwards`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import make_head
from fedmlp_tpu_torch.models.layers import BatchNorm, remat as remat_block
from fedmlp_tpu_torch.utils import profiling as trace


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, 0.1, 1e-5)  # flax momentum 0.9


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


class _Block(nn.Module):
    """The shared tail of both block kinds: the squeeze-excite gate, the
    projection shortcut where the shape changes, the residual sum."""

    def _tail(self, in_ch: int, out_ch: int, stride: int, se_ratio: float):
        if se_ratio > 0:
            hidden = max(1, int(out_ch * se_ratio))
            self.se_reduce = nn.Conv2d(out_ch, hidden, 1)
            self.se_expand = nn.Conv2d(hidden, out_ch, 1)
        self.se = se_ratio > 0
        if stride != 1 or in_ch != out_ch:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride)
            self.downsample_bn = _bn(out_ch)

    def _finish(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.se:
            s = y.mean(dim=(2, 3), keepdim=True)
            y = y * torch.sigmoid(self.se_expand(F.relu(self.se_reduce(s))))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 se_ratio: float = 0.0):
        super().__init__()
        self.Conv_0 = _conv(in_ch, filters, 3, stride)
        self.BatchNorm_0 = _bn(filters)
        self.Conv_1 = _conv(filters, filters, 3)
        self.BatchNorm_1 = _bn(filters)
        self._tail(in_ch, filters, stride, se_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return self._finish(x, y)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 se_ratio: float = 0.0):
        super().__init__()
        self.Conv_0 = _conv(in_ch, filters, 1)
        self.BatchNorm_0 = _bn(filters)
        self.Conv_1 = _conv(filters, filters, 3, stride)
        self.BatchNorm_1 = _bn(filters)
        self.Conv_2 = _conv(filters, filters * 4, 1)
        self.BatchNorm_2 = _bn(filters * 4)
        self._tail(in_ch, filters * 4, stride, se_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return self._finish(x, y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes, block_cls, num_classes: int,
                 normed_head: bool = False, se_ratio: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = _bn(64)
        self.block_names = []
        ch = 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(
                    ch, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1, se_ratio))
                self.block_names.append(name)
                ch = 64 * 2 ** i * block_cls.expansion
        self.feature_dim = ch
        self.head = make_head(ch, num_classes, normed_head)

    def forward(self, x: torch.Tensor, generator=None):
        x = x.contiguous(memory_format=torch.channels_last)
        trace.count(trace.NHWC_FORWARDS)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with −inf
        for name in self.block_names:
            blk = getattr(self, name)
            x = remat_block(blk, x) if self.remat else blk(x)
        feature = x.mean(dim=(2, 3)).float()
        return feature, self.head(feature)


def resnet18(num_classes, **kw):
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, **kw)


def resnet34(num_classes, **kw):
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, **kw)


def resnet50(num_classes, **kw):
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes, **kw)


def resnet101(num_classes, **kw):
    return ResNet((3, 4, 23, 3), Bottleneck, num_classes, **kw)


def resnet152(num_classes, **kw):
    return ResNet((3, 8, 36, 3), Bottleneck, num_classes, **kw)


def se_resnet50(num_classes, **kw):
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes, se_ratio=1 / 16, **kw)


def se_resnet101(num_classes, **kw):
    return ResNet((3, 4, 23, 3), Bottleneck, num_classes, se_ratio=1 / 16, **kw)


def se_resnet152(num_classes, **kw):
    return ResNet((3, 8, 36, 3), Bottleneck, num_classes, se_ratio=1 / 16, **kw)
