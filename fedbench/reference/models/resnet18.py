"""ResNet-18 (He et al. 2016, arXiv:1512.03385, Table 1) in plain float32,
torchvision's topology: a 7x7/2 stem, a 3x3/2 max pool, four stages of two
basic blocks (64, 128, 256, 512 wide), a 1x1 projection shortcut where a
block's shape changes, average pooling and a linear head. Batch norm at
momentum 0.9 and eps 1e-5 (flax's convention). No random draws."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference.layers import batch_norm, bn_state, conv, lecun_weights, linear, q

FEATURE_DIM = 512
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def block_table():
    """[(name, in_ch, out_ch, stride)] of the 8 basic blocks."""
    out, ch = [], 64
    for i in range(4):
        for j in range(2):
            width = 64 * 2 ** i
            out.append((f"layer{i + 1}_{j}", ch, width, 2 if i > 0 and j == 0 else 1))
            ch = width
    return out


def init_weights(n_classes: int, generator: torch.Generator, device) -> dict:
    kernels, state = {"stem_conv.weight": (64, 3, 7, 7)}, bn_state("stem_bn", 64, device)
    for name, cin, cout, s in block_table():
        kernels[f"{name}.Conv_0.weight"] = (cout, cin, 3, 3)
        kernels[f"{name}.Conv_1.weight"] = (cout, cout, 3, 3)
        state.update(bn_state(f"{name}.BatchNorm_0", cout, device))
        state.update(bn_state(f"{name}.BatchNorm_1", cout, device))
        if s != 1 or cin != cout:
            kernels[f"{name}.downsample_conv.weight"] = (cout, cin, 1, 1)
            state.update(bn_state(f"{name}.downsample_bn", cout, device))
    kernels["head.fc.weight"] = (n_classes, FEATURE_DIM)
    state["head.fc.bias"] = torch.zeros(n_classes, device=device)
    return {**lecun_weights(kernels, generator, device), **state}


def forward(w: dict, x, train: bool, generator=None, upd=None, quant: bool = False):
    """(feature [B, 512], logits [B, C]); ``generator`` is unused (no draws)."""
    upd = {} if upd is None else upd

    def bn(h, name):
        return batch_norm(h, w, name, train, BN_EPS, BN_MOMENTUM, upd, quant)

    def relu(h):
        return q(F.relu(h), quant)

    h = relu(bn(conv(x, w, "stem_conv", 2, 3, quant=quant), "stem_bn"))
    h = q(F.max_pool2d(h, 3, 2, 1), quant)
    for name, cin, cout, s in block_table():
        y = relu(bn(conv(h, w, f"{name}.Conv_0", s, 1, quant=quant), f"{name}.BatchNorm_0"))
        y = bn(conv(y, w, f"{name}.Conv_1", 1, 1, quant=quant), f"{name}.BatchNorm_1")
        if s != 1 or cin != cout:
            h = bn(conv(h, w, f"{name}.downsample_conv", s, quant=quant),
                   f"{name}.downsample_bn")
        h = relu(q(y + h, quant))
    feature = h.mean((2, 3))
    return feature, linear(feature, w, "head.fc")
