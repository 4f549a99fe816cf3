"""EfficientNet-B0 (Tan & Le 2019, arXiv:1905.11946, Table 1) in plain
float32, as the efficientnet-pytorch package that the FedMLP reference trains:
TF "SAME" padding, squeeze-excite at a quarter of the block's input width,
stochastic depth at 0.2 · (block index / 16) on the blocks with an identity
shortcut, dropout 0.2 on the pooled feature, batch norm at momentum 0.99 and
eps 1e-3 (flax's convention).

The random draws follow the order the program states for a train-mode forward
with a generator: each stochastic-depth uniform [B, 1, 1, 1] just before its
block runs, then the dropout uniform [B, 1280] on the feature.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference.layers import (batch_norm, bn_state, conv, lecun_weights,
                                       linear, q, same_pad)

# (expand ratio, output channels, repeats, stride, kernel), Table 1
BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
          (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
STEM, HEAD, FEATURE_DIM = 32, 1280, 1280
DROPOUT, DROP_CONNECT = 0.2, 0.2
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def block_table():
    """[(name, in_ch, out_ch, expand, kernel, stride, drop_rate)] of the 16 blocks."""
    out, in_ch, n = [], STEM, sum(b[2] for b in BLOCKS)
    gi = 0
    for bi, (expand, ch, reps, stride, kernel) in enumerate(BLOCKS):
        for r in range(reps):
            out.append((f"block{bi}_{r}", in_ch, ch, expand, kernel,
                        stride if r == 0 else 1, DROP_CONNECT * gi / n))
            in_ch = ch
            gi += 1
    return out


def init_weights(n_classes: int, generator: torch.Generator, device) -> dict:
    kernels, state = {"stem_conv.weight": (STEM, 3, 3, 3)}, bn_state("stem_bn", STEM, device)
    for name, cin, cout, expand, k, _s, _d in block_table():
        mid = cin * expand
        se = max(1, int(cin * 0.25))
        if expand != 1:
            kernels[f"{name}.expand_conv.weight"] = (mid, cin, 1, 1)
            state.update(bn_state(f"{name}.expand_bn", mid, device))
        kernels[f"{name}.dw_conv.weight"] = (mid, 1, k, k)
        state.update(bn_state(f"{name}.dw_bn", mid, device))
        kernels[f"{name}.se_reduce.weight"] = (se, mid, 1, 1)
        kernels[f"{name}.se_expand.weight"] = (mid, se, 1, 1)
        state[f"{name}.se_reduce.bias"] = torch.zeros(se, device=device)
        state[f"{name}.se_expand.bias"] = torch.zeros(mid, device=device)
        kernels[f"{name}.project_conv.weight"] = (cout, mid, 1, 1)
        state.update(bn_state(f"{name}.project_bn", cout, device))
    kernels["head_conv.weight"] = (HEAD, 320, 1, 1)
    state.update(bn_state("head_bn", HEAD, device))
    kernels["head.fc.weight"] = (n_classes, HEAD)
    state["head.fc.bias"] = torch.zeros(n_classes, device=device)
    return {**lecun_weights(kernels, generator, device), **state}


def forward(w: dict, x, train: bool, generator=None, upd=None, quant: bool = False):
    """(feature [B, 1280], logits [B, C]); stochastic depth and dropout only
    in training with a generator."""
    upd = {} if upd is None else upd
    stochastic = train and generator is not None

    def bn(h, name):
        return batch_norm(h, w, name, train, BN_EPS, BN_MOMENTUM, upd, quant)

    def silu(h):
        return q(F.silu(h), quant)

    h = silu(bn(conv(same_pad(x, 3, 2), w, "stem_conv", 2, quant=quant), "stem_bn"))
    for name, cin, cout, expand, k, s, rate in block_table():
        identity = s == 1 and cin == cout
        u = None
        if stochastic and identity and rate > 0:
            u = torch.rand((h.shape[0], 1, 1, 1), generator=generator, device=h.device)
        y = h
        if expand != 1:
            y = silu(bn(conv(y, w, f"{name}.expand_conv", quant=quant), f"{name}.expand_bn"))
        y = conv(same_pad(y, k, s), w, f"{name}.dw_conv", s, groups=y.shape[1], quant=quant)
        y = silu(bn(y, f"{name}.dw_bn"))
        g = q(y.mean((2, 3), keepdim=True), quant)
        g = silu(conv(g, w, f"{name}.se_reduce", bias=True, quant=quant))
        g = conv(g, w, f"{name}.se_expand", bias=True, quant=quant)
        y = q(y * q(torch.sigmoid(g), quant), quant)
        y = bn(conv(y, w, f"{name}.project_conv", quant=quant), f"{name}.project_bn")
        if identity:
            if u is not None:
                keep = 1.0 - rate
                y = q(y / keep * torch.floor(keep + u), quant)
            y = q(y + h, quant)
        h = y
    h = silu(bn(conv(h, w, "head_conv", quant=quant), "head_bn"))
    feature = h.mean((2, 3))
    if stochastic:
        u = torch.rand(feature.shape, generator=generator, device=feature.device)
        keep = 1.0 - DROPOUT
        feature = torch.where(u < keep, feature / keep, torch.zeros_like(feature))
    return feature, linear(feature, w, "head.fc")
