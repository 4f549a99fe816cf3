"""K clients' forwards as one network of K×-wide grouped layers (port of
``fedmlp_tpu/models/stacked.py``).

Activations are NCHW [B, K·C, H, W] with k-major channel blocks: client k
owns channels [k·C, (k+1)·C). The forward reads the client-stacked state
dict {name: [K, ...]} that the rounds return, so aggregation, checkpoints
and the other engines stay interchangeable with this one. In PyTorch's OIHW
layout every stacked weight is a reshape, with no transpose:

* a dense k×k conv (the stem, SmallCNN) and a 1×1 conv: [K·Co, Ci, k, k]
  with ``groups=K``;
* a depthwise conv: [K·C, 1, k, k] with ``groups=K·C``;
* squeeze-excite and the head: the einsum 'bkc,kdc->bkd' over [B, K, C];
* batch norm: the port's ``BatchNorm`` arithmetic over K·C channels
  (biased variance, flax's momentum), running statistics as [K, C].

The module passed in gives only the architecture (block table, batch-norm
momentum and eps, head kind); its own tensors are not read. As in the JAX
package the stacked forward ignores ``dw_backend``. JAX's two custom VJPs
and its per-layer choice of pointwise form are workarounds for XLA with
the same math: autograd of the plain ops serves here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedmlp_tpu_torch.models.efficientnet import EfficientNet
from fedmlp_tpu_torch.models.heads import FCNormHead
from fedmlp_tpu_torch.models.layers import dropout, same_pad
from fedmlp_tpu_torch.models.smallcnn import SmallCNN


def supports_stacking(model) -> bool:
    return isinstance(model, (EfficientNet, SmallCNN))


def _conv(h, w, stride: int = 1, padding: int = 0):
    """Per-client convs w [K, Co, Ci, kh, kw] (no bias) on h [B, K·C, H, W]
    as one grouped conv: K groups for a dense conv (Ci = C), K·C for a
    depthwise one (Ci = 1)."""
    return F.conv2d(h, w.reshape((-1,) + w.shape[2:]), None, stride, padding,
                    groups=h.shape[1] // w.shape[2])


def _batch_norm(h, sv, name, bn, train, new_stats):
    """``layers.BatchNorm`` over the K·C channels of ``h`` with the [K, C]
    tensors ``sv[name + '.*']``; in train mode the new running statistics
    go to ``new_stats``."""
    w, b = sv[name + ".weight"].reshape(-1), sv[name + ".bias"].reshape(-1)
    rm, rv = sv[name + ".running_mean"], sv[name + ".running_var"]
    if not train:
        return F.batch_norm(h, rm.reshape(-1), rv.reshape(-1), w, b, False, 0.0, bn.eps)
    batch_mean = torch.zeros_like(rm).reshape(-1)
    batch_var = torch.zeros_like(rv).reshape(-1)
    y = F.batch_norm(h, batch_mean, batch_var, w, b, True, 1.0, bn.eps)
    n = h.numel() // h.shape[1]
    m = bn.momentum
    with torch.no_grad():
        new_stats[name + ".running_mean"] = rm * (1.0 - m) + (batch_mean * m).view_as(rm)
        new_stats[name + ".running_var"] = (rv * (1.0 - m)
                                            + (batch_var * ((n - 1) / n * m)).view_as(rv))
    return y


def _dense(x, w, b):
    """[B, K, C] through per-client 1×1 convs w [K, D, C, 1, 1], b [K, D]."""
    y = torch.einsum("bkc,kdc->bkd", x, w[..., 0, 0])
    return y + b.to(y.dtype)


def _head(head, sv, feature):
    """feature [B, K, D] → logits [B, K, n], float32 as ``heads.py``."""
    with torch.autocast(feature.device.type, enabled=False):
        if isinstance(head, FCNormHead):
            w = sv["head.weight"] - 1.0  # [K, D, n]
            xn = feature / torch.clamp(
                torch.linalg.vector_norm(feature, dim=-1, keepdim=True), min=1e-12)
            wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                                 min=1e-12)
            return head.s * torch.einsum("bkd,kdn->bkn", xn, wn)
        return (torch.einsum("bkd,knd->bkn", feature, sv["head.fc.weight"])
                + sv["head.fc.bias"])


def _mbconv(blk, name, sv, x, K, train, generator, new_stats):
    p = name + "."
    B = x.shape[0]
    h = x
    if blk.expand != 1:
        h = _conv(h, sv[p + "expand_conv.weight"])
        h = F.silu(_batch_norm(h, sv, p + "expand_bn", blk.expand_bn, train, new_stats))
    h = _conv(same_pad(h, blk.kernel, blk.stride), sv[p + "dw_conv.weight"], blk.stride)
    h = F.silu(_batch_norm(h, sv, p + "dw_bn", blk.dw_bn, train, new_stats))
    s = h.mean(dim=(2, 3)).view(B, K, -1)
    s = F.silu(_dense(s, sv[p + "se_reduce.weight"], sv[p + "se_reduce.bias"]))
    s = _dense(s, sv[p + "se_expand.weight"], sv[p + "se_expand.bias"])
    h = h * torch.sigmoid(s).reshape(B, -1, 1, 1)
    h = _conv(h, sv[p + "project_conv.weight"])
    h = _batch_norm(h, sv, p + "project_bn", blk.project_bn, train, new_stats)
    if blk.stride == 1 and blk.in_ch == blk.out_ch:
        if generator is not None and blk.drop_rate > 0:
            # one draw per (sample, client), as ``layers.drop_connect`` per sample
            keep = 1.0 - blk.drop_rate
            u = torch.rand((B, K, 1, 1, 1), generator=generator, device=h.device)
            h5 = h.reshape((B, K, -1) + h.shape[2:])
            h = (h5 / keep * torch.floor(keep + u).to(h.dtype)).reshape(h.shape)
        h = h + x
    return h


def _efficientnet(model, sv, h, K, train, generator, new_stats):
    h = _conv(same_pad(h, 3, 2), sv["stem_conv.weight"], 2)
    h = F.silu(_batch_norm(h, sv, "stem_bn", model.stem_bn, train, new_stats))
    for name in model.block_names:
        h = _mbconv(getattr(model, name), name, sv, h, K, train, generator, new_stats)
    h = _conv(h, sv["head_conv.weight"])
    h = F.silu(_batch_norm(h, sv, "head_bn", model.head_bn, train, new_stats))
    feature = h.mean(dim=(2, 3)).float().view(h.shape[0], K, -1)
    if generator is not None:
        feature = dropout(feature, model.dropout_p, generator)
    return feature


def _smallcnn(model, sv, h, K, train, generator, new_stats):
    for i in range(3):
        h = _conv(h, sv[f"conv{i}.weight"], 2, 1)
        h = F.relu(_batch_norm(h, sv, f"bn{i}", getattr(model, f"bn{i}"), train,
                               new_stats))
    return h.mean(dim=(2, 3)).float().view(h.shape[0], K, -1)


def stacked_apply(model, svars: dict, x: torch.Tensor, train: bool = True,
                  generator=None):
    """Run K clients' forwards at once.

    ``svars``: the client-stacked state dict {name: [K, ...]}; ``x``: f32
    views [K, B, 3, H, W]. Returns ((feature [K, B, D], logits [K, B, n]),
    new running statistics {name: [K, C]} in train mode, else None).
    ``generator`` drives drop-connect (one draw per sample and client) and
    dropout (on the [B, K, D] feature) in train mode, as in ``model``."""
    if isinstance(model, EfficientNet):
        body = _efficientnet
    elif isinstance(model, SmallCNN):
        body = _smallcnn
    else:
        raise NotImplementedError(
            f"stacked execution unsupported for {type(model).__name__}")
    K, B = x.shape[:2]
    h = x.transpose(0, 1).reshape((B, -1) + x.shape[3:])
    new_stats = {}
    feature = body(model, svars, h, K, train, generator if train else None, new_stats)
    logits = _head(model.head, svars, feature)
    return ((feature.transpose(0, 1), logits.transpose(0, 1)),
            new_stats if train else None)
