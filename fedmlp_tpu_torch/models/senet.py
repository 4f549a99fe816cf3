"""SENet-154 in NCHW, after ``fedmlp_tpu/models/senet.py``
(pretrainedmodels' ``senet154``; flax's names kept for ``weights.py``).

Where it differs from the SE-ResNets:

* stem: three 3x3 convs (64 stride 2, 64, 128), each with batch norm and
  ReLU, then a 3x3/2 max-pool in ceil mode, written as JAX writes it: −inf
  padding of one row and column at the bottom and right, then floor;
* bottleneck: a 1x1 conv to ``planes*2``, a grouped 3x3 (64 groups) to
  ``planes*4``, a 1x1 at ``planes*4``, the squeeze-excite module with
  biased 1x1 convs (``fc1``/``fc2``, reduction 16);
* shortcuts: a 1x1 projection in layer 1, a 3x3 stride-2 one (padding 1)
  in layers 2-4;
* dropout p = 0.2 on the pooled feature before the head, drawn in train
  mode only when the forward is given a generator (flax: only with a
  'dropout' rng). The feature returned is the one after dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedmlp_tpu_torch.models.heads import make_head
from fedmlp_tpu_torch.models.layers import BatchNorm, dropout

_LAYERS = ((3, 64), (8, 128), (36, 256), (3, 512))  # (blocks, planes)


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, 0.1, 1e-5)  # flax momentum 0.9


class SEModule(nn.Module):
    def __init__(self, ch: int, reduction: int):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, ch // reduction, 1)
        self.fc2 = nn.Conv2d(ch // reduction, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class SEBottleneck154(nn.Module):
    """senet154's widened grouped bottleneck; ``downsample_kernel`` 0 keeps
    the identity shortcut."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, groups: int = 64,
                 reduction: int = 16, downsample_kernel: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes * 2, 1, bias=False)
        self.bn1 = _bn(planes * 2)
        self.conv2 = nn.Conv2d(planes * 2, planes * 4, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = _bn(planes * 4)
        self.conv3 = nn.Conv2d(planes * 4, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.se_module = SEModule(planes * 4, reduction)
        if downsample_kernel:
            k = downsample_kernel
            self.downsample_conv = nn.Conv2d(in_ch, planes * 4, k, stride, (k - 1) // 2,
                                             bias=False)
            self.downsample_bn = _bn(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se_module(self.bn3(self.conv3(y)))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class SENet154(nn.Module):
    def __init__(self, num_classes: int, normed_head: bool = False,
                 dropout_p: float = 0.2):
        super().__init__()
        self.dropout_p = dropout_p
        for i, (cin, cout) in enumerate(((3, 64), (64, 64), (64, 128))):
            self.add_module(f"stem_conv{i + 1}",
                            nn.Conv2d(cin, cout, 3, 2 if i == 0 else 1, 1, bias=False))
            self.add_module(f"stem_bn{i + 1}", _bn(cout))
        self.block_names = []
        ch = 128
        for i, (n_blocks, planes) in enumerate(_LAYERS):
            for j in range(n_blocks):
                name = f"layer{i + 1}_{j}"
                dk = 0 if j else (1 if i == 0 else 3)
                self.add_module(name, SEBottleneck154(
                    ch, planes, 2 if i > 0 and j == 0 else 1, downsample_kernel=dk))
                self.block_names.append(name)
                ch = planes * 4
        self.head = make_head(ch, num_classes, normed_head)

    def forward_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The three stem convolutions and the ceil-mode max-pool."""
        for i in range(1, 4):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
        return F.max_pool2d(x, 3, 2)

    def forward(self, x: torch.Tensor, generator=None):
        x = self.forward_stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        feature = x.mean(dim=(2, 3)).float()
        if self.training and generator is not None:
            feature = dropout(feature, self.dropout_p, generator)
        return feature, self.head(feature)


def senet154(num_classes, **kw):
    return SENet154(num_classes, **kw)
