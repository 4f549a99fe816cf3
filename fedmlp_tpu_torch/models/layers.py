"""Layers with the JAX package's (flax's) semantics where PyTorch's differ,
and the block rematerialization of ``nn.remat``."""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# per thread: whether train-mode batch norms hold their running statistics
# (set while a rematerialized block recomputes its forward)
_RUNNING_STATS = threading.local()


@contextlib.contextmanager
def running_stats_held():
    """Inside, a train-mode :class:`BatchNorm` normalizes with the batch
    statistics as always but leaves its running statistics as they are."""
    before = getattr(_RUNNING_STATS, "held", False)
    _RUNNING_STATS.held = True
    try:
        yield
    finally:
        _RUNNING_STATS.held = before


class BatchNorm(nn.Module):
    """Batch norm as ``flax.linen.BatchNorm``: train mode normalizes with the
    biased batch variance AND updates the running variance with it
    (``nn.BatchNorm2d`` would update with the unbiased one). ``momentum``
    is PyTorch's: the weight of the new batch statistic (flax 0.99 → 0.01).

    The batch statistics come from PyTorch's fused batch-norm kernel, run
    with scratch running buffers at momentum 1 so that they receive exactly
    the batch mean and unbiased variance; the biased variance is that times
    (n − 1)/n. No ``num_batches_tracked`` buffer, as flax keeps none. Under
    :func:`running_stats_held` the running statistics are not updated."""

    def __init__(self, num_features: int, momentum: float, eps: float):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        batch_mean = torch.zeros_like(self.running_mean)
        batch_var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, batch_mean, batch_var, self.weight, self.bias,
                         True, 1.0, self.eps)
        if getattr(_RUNNING_STATS, "held", False):
            return y
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(batch_mean * m)
            self.running_var.mul_(1.0 - m).add_(batch_var * ((n - 1) / n * m))
        return y


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF-"SAME" (before, after) zero padding of one spatial dim of size n
    for a size-k stride-s conv: the extra pixel goes after (``_same_pads``
    of the JAX EfficientNet, lukemelas' Conv2dStaticSamePadding)."""
    out = -(-n // s)
    total = max(0, (out - 1) * s + k - n)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NCHW ``x`` zero-padded TF-"SAME" for a k×k stride-s conv."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """``flax.linen.Dropout`` in train mode, drawing from ``generator``."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def drop_connect_draw(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The uniform [B, 1, 1, 1] of :func:`drop_connect` for a batch ``x``."""
    return torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device)


def drop_connect(h: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Per-sample stochastic depth (efficientnet-pytorch ``drop_connect``)
    with the draw ``u`` of :func:`drop_connect_draw`."""
    keep = 1.0 - rate
    return h / keep * torch.floor(keep + u).to(h.dtype)


def _remat_contexts():
    return contextlib.nullcontext(), running_stats_held()


def remat(module: nn.Module, *args):
    """``module(*args)``, rematerialized as flax's ``nn.remat``: in training
    with gradients on, only the block's inputs are kept for the backward,
    which recomputes the forward
    (``torch.utils.checkpoint.checkpoint``, non-reentrant); otherwise a
    plain call.

    The recompute reads the parameter tensors that the forward read (the
    module's own, or those a ``torch.func.functional_call`` put in place),
    runs under the forward's autocast, and holds batch norm's running
    statistics (:func:`running_stats_held`), which the forward updated once,
    as flax drops the recompute's mutation. The module must draw nothing
    from a generator: its random draws come in through ``args``, so the
    recompute repeats them."""
    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    params = dict(module.named_parameters())

    def run(*a):
        return torch.func.functional_call(module, params, a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_remat_contexts)
