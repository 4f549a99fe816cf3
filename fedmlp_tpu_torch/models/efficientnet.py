"""EfficientNet B0–B7 in NCHW, built from the same block table and scaling
parameters as ``fedmlp_tpu/models/efficientnet.py``.

Submodules carry the flax names (``stem_conv``, ``block{bi}_{r}.dw_conv``,
``head.fc``, ...), so ``weights.py`` maps weights between the two packages
mechanically. The stem and every depthwise conv pad TF-"SAME" (extra pixel
right/bottom) before an unpadded conv; the depthwise convs are grouped
``conv2d`` (the JAX package's default ``dw_backend``). Batch norm follows
flax: momentum 0.99 (0.01 here), eps 1e-3, biased variance. Dropout on the
pooled feature and per-block stochastic depth are active in train mode
when the forward is given a generator, as flax's are with a 'dropout' rng.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import LinearHead
from fedmlp_tpu_torch.models.layers import BatchNorm, drop_connect, dropout, same_pad

# (expand_ratio, channels, repeats, stride, kernel)
_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# (width_mult, depth_mult, resolution, dropout)
_SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}
_BN_MOMENTUM = 0.01  # flax 0.99
_BN_EPS = 1e-3


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, _BN_MOMENTUM, _BN_EPS)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, se_ratio: float = 0.25, drop_rate: float = 0.0):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.expand, self.kernel, self.stride = expand, kernel, stride
        self.drop_rate = drop_rate
        mid = in_ch * expand
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.expand_bn = _bn(mid)
        self.dw_conv = nn.Conv2d(mid, mid, kernel, stride, groups=mid, bias=False)
        self.dw_bn = _bn(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self.se_reduce = nn.Conv2d(mid, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, mid, 1)
        self.project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.project_bn = _bn(out_ch)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = F.silu(self.expand_bn(self.expand_conv(h)))
        h = self.dw_conv(same_pad(h, self.kernel, self.stride))
        h = F.silu(self.dw_bn(h))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = self.se_expand(F.silu(self.se_reduce(s)))
        h = h * torch.sigmoid(s)
        h = self.project_bn(self.project_conv(h))
        if self.stride == 1 and self.in_ch == self.out_ch:
            if generator is not None and self.training and self.drop_rate > 0:
                h = drop_connect(h, self.drop_rate, generator)
            h = h + x
        return h


class EfficientNet(nn.Module):
    def __init__(self, width_mult: float, depth_mult: float, num_classes: int,
                 blocks=_B0_BLOCKS, dropout_p: float = 0.2,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        self.dropout_p = dropout_p
        stem = _round_filters(32, width_mult)
        self.stem_conv = nn.Conv2d(3, stem, 3, 2, bias=False)
        self.stem_bn = _bn(stem)
        in_ch = stem
        n_blocks = sum(_round_repeats(reps, depth_mult) for _, _, reps, _, _ in blocks)
        self.block_names = []
        gi = 0  # global block index scales the stochastic-depth rate
        for bi, (expand, ch, reps, stride, kernel) in enumerate(blocks):
            out_ch = _round_filters(ch, width_mult)
            for r in range(_round_repeats(reps, depth_mult)):
                name = f"block{bi}_{r}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, kernel, stride if r == 0 else 1,
                    drop_rate=drop_connect_rate * gi / n_blocks))
                self.block_names.append(name)
                in_ch = out_ch
                gi += 1
        head_ch = _round_filters(1280, width_mult)
        self.head_conv = nn.Conv2d(in_ch, head_ch, 1, bias=False)
        self.head_bn = _bn(head_ch)
        self.head = LinearHead(head_ch, num_classes)

    def forward(self, x: torch.Tensor, generator=None):
        stochastic = self.training and generator is not None
        x = self.stem_conv(same_pad(x, 3, 2))
        x = F.silu(self.stem_bn(x))
        for name in self.block_names:
            x = getattr(self, name)(x, generator if stochastic else None)
        x = F.silu(self.head_bn(self.head_conv(x)))
        feature = x.mean(dim=(2, 3)).float()
        if stochastic:
            feature = dropout(feature, self.dropout_p, generator)
        return feature, self.head(feature)


def _make(variant):
    def ctor(num_classes, **kw):
        w, d, _res, drop = _SCALING[variant]
        kw.setdefault("dropout_p", drop)
        return EfficientNet(w, d, num_classes, **kw)

    ctor.__name__ = f"efficientnet_{variant}"
    return ctor


efficientnet_b0 = _make("b0")
efficientnet_b1 = _make("b1")
efficientnet_b2 = _make("b2")
efficientnet_b3 = _make("b3")
efficientnet_b4 = _make("b4")
efficientnet_b5 = _make("b5")
efficientnet_b6 = _make("b6")
efficientnet_b7 = _make("b7")


def feature_dim(variant: str) -> int:
    return _round_filters(1280, _SCALING[variant][0])
