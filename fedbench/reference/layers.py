"""Plain float32 building blocks of the reference models.

Every function takes the weights as a flat dict keyed by the program's
``state_dict`` names, so the benchmark hands one set of weights to both sides.
Batch norm follows flax's convention, which the program states: the batch's
biased variance normalizes and also updates the running variance. A train-mode
batch norm writes its new running statistics into ``upd``.

``quant`` (the control) computes the backbone in fp8, where the program
computes it in bfloat16 under autocast: the operands of every convolution and
the output of every operation of the backbone (``q``) are rounded to e4m3 with
one scale a tensor, and so is every gradient that flows back through them.
The head stays in float32, as the program's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (amax to 448) and
    back to float32."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def q(t: torch.Tensor, quant: bool) -> torch.Tensor:
    """``t`` in fp8 forward and backward when ``quant``, else ``t``."""
    return _FP8.apply(t) if quant else t


def conv(x, w, name: str, stride: int = 1, padding=0, groups: int = 1, bias: bool = False,
         quant: bool = False):
    k = q(w[name + ".weight"], quant)
    return q(F.conv2d(q(x, quant), k, w[name + ".bias"] if bias else None, stride, padding, 1,
                      groups), quant)


def batch_norm(x, w, name: str, train: bool, eps: float, momentum: float, upd: dict,
               quant: bool = False):
    """flax BatchNorm on NCHW ``x``; ``momentum`` is the weight of the new
    batch statistic (flax's 0.99 is 0.01 here)."""
    if train:
        mean = x.mean((0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
        upd[name + ".running_mean"] = ((1.0 - momentum) * w[name + ".running_mean"]
                                       + momentum * mean.detach())
        upd[name + ".running_var"] = ((1.0 - momentum) * w[name + ".running_var"]
                                      + momentum * var.detach())
    else:
        mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    inv = torch.rsqrt(var + eps) * w[name + ".weight"]
    return q((x - mean[None, :, None, None]) * inv[None, :, None, None]
             + w[name + ".bias"][None, :, None, None], quant)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF "SAME" padding of one side of n for a k-wide stride-s window: the
    odd pixel goes after."""
    out = -(-n // s)
    total = max(0, (out - 1) * s + k - n)
    return total // 2, total - total // 2


def same_pad(x, k: int, s: int):
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom))


def linear(x, w, name: str):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def lecun_weights(shapes: dict, generator: torch.Generator, device) -> dict:
    """float32 weights for ``shapes`` {name: shape} of conv and linear kernels:
    normal with variance 1/fan_in, all drawn in one call and sliced."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        fan_in = n // shape[0]
        out[name] = (flat[at:at + n] * fan_in ** -0.5).reshape(shape)
        at += n
    return out


def bn_state(name: str, ch: int, device) -> dict:
    return {name + ".weight": torch.ones(ch, device=device),
            name + ".bias": torch.zeros(ch, device=device),
            name + ".running_mean": torch.zeros(ch, device=device),
            name + ".running_var": torch.ones(ch, device=device)}
