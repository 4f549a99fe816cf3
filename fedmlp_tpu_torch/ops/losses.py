"""Losses of the ported slices, and the rampups that weight them."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-6  # the clip of the KL, JS and entropy terms


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, pos_weight=None):
    """Elementwise, unreduced BCE with logits, ``BCEWithLogitsLoss(
    reduction='none', pos_weight=...)`` semantics:
    loss = −(pos_w·y·log σ(x) + (1 − y)·log(1 − σ(x)))."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    return -(pw * targets * log_p + (1.0 - targets) * log_not_p)


def bce_on_probs(probs: torch.Tensor, targets: torch.Tensor, weight=None):
    """Elementwise BCE on probabilities (reference: utils/FedNoRo.py:22).

    ``F.binary_cross_entropy`` is exactly what the JAX package imitates in
    ``fedmlp_tpu/ops/losses.py::bce_on_probs``: each log term is clamped at
    −100, and its backward is (p − y) / max(p·(1 − p), 1e-12), finite at
    p ∈ {0, 1} where autodiff through the clamp would give 0·∞ (the JAX
    package's ``_bce_core_bwd`` copies that formula). Runs in float32 outside
    autocast, which refuses this function."""
    with torch.autocast(probs.device.type, enabled=False):
        loss = F.binary_cross_entropy(probs.float(), targets.float(),
                                      reduction="none")
    if weight is not None:
        loss = loss * weight
    return loss


def masked_class_mean(loss: torch.Tensor, class_mask: torch.Tensor, batch_size=None):
    """The reference's ``loss[:, cls_list].sum() / (batch * len(cls_list))``
    as a mask-weighted mean: ``class_mask`` [C] (bool or 0/1) picks the
    classes, the denominator is ``batch_size`` (default: the leading size)
    times at least one class. The reference divides by the CONFIGURED batch
    size even for a ragged last batch (utils/local_training.py:956-957), so
    pass it for parity."""
    class_mask = class_mask.to(loss.dtype)
    b = loss.shape[0] if batch_size is None else batch_size
    return (loss * class_mask[None, :]).sum() / (b * torch.clamp(class_mask.sum(), min=1.0))


def la_kd(probs: torch.Tensor, targets: torch.Tensor, soft_targets: torch.Tensor, w_kd,
          active_mask: torch.Tensor, negative_mask: torch.Tensor, batch_size=None):
    """FedNoRo's LA_KD (reference: utils/FedNoRo.py:35-38): (1 − w)·BCE(probs,
    y) over the annotated classes + w·MSE(probs, soft) over the missing ones,
    each a ``masked_class_mean``. (``algos/fednoro.py`` writes it inline, as
    the JAX package's FedNoRo does.)"""
    bce = masked_class_mean(bce_on_probs(probs, targets), active_mask, batch_size)
    kl = masked_class_mean((probs - soft_targets) ** 2, negative_mask, batch_size)
    return w_kd * kl + (1.0 - w_kd) * bce


def sigmoid_mse(input_logits: torch.Tensor, target_logits: torch.Tensor):
    """(σ(a) − σ(b))² elementwise (reference: utils/local_training.py:94-107)."""
    return (torch.sigmoid(input_logits) - torch.sigmoid(target_logits)) ** 2


def kd_symmetric_kl(source: torch.Tensor, target: torch.Tensor):
    """Symmetric KL with torch 'batchmean' semantics: the sum over elements
    over the batch dimension (reference: utils/local_training.py:109-113)."""
    q = torch.clamp(source, min=_EPS)
    p = torch.clamp(target, min=_EPS)
    b = source.shape[0]
    kl_qp = (p * (torch.log(p) - torch.log(q))).sum() / b
    kl_pq = (q * (torch.log(q) - torch.log(p))).sum() / b
    return (kl_qp + kl_pq) / 2.0


def js_divergence(p_output: torch.Tensor, q_output: torch.Tensor):
    """Jensen-Shannon with torch ``KLDivLoss(reduction='mean')`` semantics:
    the mean over ALL elements (reference: utils/local_training.py:1258-1266)."""
    m = (p_output + q_output) / 2.0
    log_m = torch.log(torch.clamp(m, min=_EPS))
    n = p_output.numel()
    kl_mp = (p_output * (torch.log(torch.clamp(p_output, min=_EPS)) - log_m)).sum() / n
    kl_mq = (q_output * (torch.log(torch.clamp(q_output, min=_EPS)) - log_m)).sum() / n
    return (kl_mp + kl_mq) / 2.0


def anti_sigmoid(p: torch.Tensor):
    """Inverse sigmoid (reference: utils/local_training.py:1268-1269)."""
    return torch.log(p / (1.0 - p))


def binary_entropy_per_class(probs: torch.Tensor):
    """−Σ_{b∈{p,1−p}} b·log b, per element (RoFL's L_e and FedIRM's
    uncertainty, reference: utils/local_training.py:595-601)."""
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -(p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))


# ----------------------------------------------------------------------
# Rampups (host-side floats, computed with numpy)
# ----------------------------------------------------------------------

def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(−5(1 − t)²) rampup (reference: utils/local_training.py:83-90)."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def sigmoid_rampup_bounded(current: float, begin: float, end: float) -> float:
    """FedNoRo's rampup, clipped to [begin, end] (reference:
    utils/FedNoRo.py:72-81)."""
    current = float(np.clip(current, begin, end))
    phase = 1.0 - (current - begin) / (end - begin)
    return float(np.exp(-5.0 * phase * phase))


def pos_weight_from_counts(n_local: float, class_counts) -> np.ndarray:
    """Inverse class frequency, float32 ``n_local / max(count, 1e-12)``
    (reference: utils/local_training.py:40, loss_w = N_local / class_count),
    computed in float64 as the JAX package does."""
    counts = np.maximum(np.asarray(class_counts, dtype=np.float64), 1e-12)
    return (n_local / counts).astype(np.float32)
