"""Prototype / similarity math for FedMLP stage 2."""

from __future__ import annotations

import torch

_EPS = 1e-12


def cosine_similarity_matrix(x: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """cos-sim of every row of x [N, D] against every row of protos [P, D]
    → [N, P] (reference CosineSimilarityFast)."""
    dots = x.float() @ protos.float().T
    xn = torch.linalg.norm(x.float(), dim=1, keepdim=True)
    pn = torch.linalg.norm(protos.float(), dim=1, keepdim=True)
    return dots / torch.clamp(xn * pn.T, min=_EPS)


def fedmlp_similarity_scores(features: torch.Tensor, prototypes: torch.Tensor):
    """Per-class score cos(f, proto_0_c) − cos(f, proto_1_c) → [N, C];
    ``prototypes`` [2C, D] laid out [cls0_p0, cls0_p1, cls1_p0, ...]."""
    sims = cosine_similarity_matrix(features, prototypes)
    return sims[:, 0::2] - sims[:, 1::2]


def masked_binary_prototypes(features, labels, sample_mask, n_classes: int):
    """Per-class mean feature over label==0 and label==1 valid samples →
    (proto [2C, D], counts [2C]); classes without members keep zeros."""
    f32 = features.float()
    m = sample_mask.float()[:, None]
    lab = labels.float()
    w1 = m * lab
    w0 = m * (1.0 - lab)
    w = torch.stack([w0, w1], dim=2).reshape(f32.shape[0], 2 * n_classes)
    sums = w.T @ f32
    counts = w.sum(dim=0)
    proto = sums / torch.clamp(counts[:, None], min=1.0)
    proto = torch.where(counts[:, None] > 0, proto, torch.zeros_like(proto))
    return proto, counts


def confidence_fraction(probs, sample_mask, L: float, U: float):
    """Per-class fraction of valid samples with prob < L or prob > U → [C]."""
    m = sample_mask.float()[:, None]
    confident = ((probs < L) | (probs > U)).float()
    n = torch.clamp(sample_mask.float().sum(), min=1.0)
    return (confident * m).sum(dim=0) / n
