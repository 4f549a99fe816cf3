"""Depthwise convolution with a rerouted backward (port of
``fedmlp_tpu/ops/dw_conv.py``), NCHW.

``dw_conv`` keeps the forward as the grouped convolution and computes its
backward by other means:

* dx — a depthwise convolution of the cotangent, zero-inserted by the
  stride, with the spatially flipped filter (the forward's own op);
* dw — k² strided-shift multiply-and-sum taps in float32.

No hand-written kernel: every piece is a stock PyTorch op, as every piece
of the JAX version is an XLA op. Layout: x ``[B, C, H, W]``, the filter as
the grouped ``nn.Conv2d``'s weight ``[C, 1, k, k]``; ``pads`` is the TF-SAME
``((top, bottom), (left, right))`` that the caller computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_pairs(x: torch.Tensor, pads) -> torch.Tensor:
    """NCHW ``x`` zero-padded by ``pads`` ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (pl, pr, pt, pb))


def dw_conv_xla(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """The grouped convolution of the padded input, as autograd
    differentiates it (JAX's native-VJP form, under its name); the forward
    of :func:`dw_conv`."""
    return F.conv2d(pad_pairs(x, pads), w.to(x.dtype), stride=stride, groups=x.shape[1])


def _dx_via_fwd(dy: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """dx: dy with stride − 1 zeros inserted between neighbours, padded
    (k − 1 − before, k − 1 − after) on each axis, correlated with the
    flipped filter (``lax.conv_general_dilated`` with ``lhs_dilation``)."""
    k = w.shape[-1]
    (pt, pb), (pl, pr) = pads
    if stride > 1:
        B, C, Ho, Wo = dy.shape
        dil = dy.new_zeros((B, C, (Ho - 1) * stride + 1, (Wo - 1) * stride + 1))
        dil[:, :, ::stride, ::stride] = dy
        dy = dil
    dy = F.pad(dy, (k - 1 - pl, k - 1 - pr, k - 1 - pt, k - 1 - pb))
    return F.conv2d(dy, w.flip((2, 3)).to(dy.dtype), groups=dy.shape[1])


def _dw_grad_taps(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int,
                  pads) -> torch.Tensor:
    """dw[c, 0, ky, kx] = Σ_{b,y,x} x_pad[b, c, s·y + ky, s·x + kx] ·
    dy[b, c, y, x], one strided slice, product and float32 sum a tap."""
    xp = pad_pairs(x, pads)
    Ho, Wo = dy.shape[2], dy.shape[3]
    dyf = dy.float()
    rows = []
    for ky in range(k):
        cols = []
        for kx in range(k):
            xs = xp[:, :, ky:ky + stride * (Ho - 1) + 1:stride,
                    kx:kx + stride * (Wo - 1) + 1:stride]
            cols.append((xs.float() * dyf).sum(dim=(0, 2, 3)))
        rows.append(torch.stack(cols, -1))
    return torch.stack(rows, -2)[:, None]  # [C, 1, k, k]


class _DwConv(torch.autograd.Function):
    """The grouped-conv forward with JAX's rerouted ``_bwd``. x and w come
    in already cast to the compute type, so autocast changes nothing here."""

    @staticmethod
    def forward(ctx, x, w, stride, pads):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads = stride, pads
        return dw_conv_xla(x, w, stride, pads)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = _dx_via_fwd(dy, w, ctx.stride, ctx.pads)
        dw = _dw_grad_taps(x, dy, w.shape[-1], ctx.stride, ctx.pads).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def dw_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """Depthwise convolution, forward as :func:`dw_conv_xla`, backward
    rerouted (dx through the forward op, dw as float32 taps cast to w's
    type)."""
    return _DwConv.apply(x, w, stride, tuple(tuple(p) for p in pads))
