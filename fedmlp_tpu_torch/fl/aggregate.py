"""Server-side aggregation rules of the ported slice.

Client state arrives stacked on a leading client axis: a dict
``{name: tensor [K, ...]}`` of every model variable (parameters AND batch-norm
running statistics), as the engine returns it.
"""

from __future__ import annotations

import numpy as np
import torch


def _weighted_mean_tree(stacked: dict, weights) -> dict:
    """Weighted mean over the leading axis of every entry. weights [K]."""
    out = {}
    wsum = None
    for name, x in stacked.items():
        w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
        if wsum is None:
            wsum = w.sum()
        wr = w.reshape((-1,) + (1,) * (x.dim() - 1))
        out[name] = (x.float() * wr).sum(0) / wsum
    return out


def fedavg(stacked: dict, dict_len) -> dict:
    """FedAvg weighted by client dataset sizes (reference: utils/FedAvg.py:7-14)."""
    return _weighted_mean_tree(stacked, dict_len)


def fed_w(stacked: dict, weight) -> dict:
    """Weighted mean with arbitrary client weights (reference:
    utils/FedAvg.py:16-23)."""
    return _weighted_mean_tree(stacked, weight)


def fedavg_tao(taos, weight, class_client_mask=None):
    """Per-class weighted mean of τ [K, C] over the clients in the mask
    [C, K]; an empty subset gives 1.0 (reference: utils/FedAvg.py:51-70).
    FedMLP passes the NEGATIVE client mask (reference main.py:223): τ of
    class c averages over the clients missing c."""
    t = torch.as_tensor(taos, dtype=torch.float32)
    w = torch.as_tensor(weight, dtype=torch.float32, device=t.device)
    if class_client_mask is None:
        return (t * w[:, None]).sum(0) / w.sum()
    m = torch.as_tensor(class_client_mask, dtype=torch.float32, device=t.device)
    num = (m * (w[None, :] * t.T)).sum(1)
    den = (m * w[None, :]).sum(1)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                       torch.ones_like(den))


def fedavg_proto(protos, weight, class_active_mask):
    """Per-class weighted mean of (proto_0, proto_1) pairs [K, 2C, D] over
    the clients annotating the class, mask [C, K] → [2C, D]; the server
    replaces its prototypes with it (λ = 1, reference main.py:230-234)."""
    p = torch.as_tensor(protos, dtype=torch.float32)
    w = torch.as_tensor(weight, dtype=torch.float32, device=p.device)
    m = torch.as_tensor(class_active_mask, dtype=torch.float32, device=p.device)
    wm = torch.repeat_interleave(m, 2, dim=0) * w[None, :]  # [2C, K]
    num = torch.einsum("ck,kcd->cd", wm, p)
    den = wm.sum(1)[:, None]
    return num / torch.clamp(den, min=1e-12)


def model_dist(tree_a: dict, tree_b: dict) -> torch.Tensor:
    """Σ over entries of ‖a − b‖_F in f32, floating-point entries only
    (reference: utils/FedAvg.py:43-49; the FedNoRo variant skips integer
    tensors, utils/FedNoRo.py:110-111)."""
    total = None
    for name, a in tree_a.items():
        if not a.is_floating_point():
            continue
        n = torch.linalg.vector_norm((a.float() - tree_b[name].float()).reshape(-1))
        total = n if total is None else total + n
    return torch.zeros((), dtype=torch.float32) if total is None else total


def rscfed(dma_groups, stacked: dict, K: int, dict_len, M: int) -> dict:
    """RSCFed's sub-consensus (reference: utils/FedAvg.py:25-41): for each of
    the M groups of K clients in ``dma_groups`` [M, K], the uniform mean,
    then the mean reweighted by a = n_i/N_group, b = exp(−0.01·d_i/n_i), d_i
    the ``model_dist`` of client i to that uniform mean; the result is the
    uniform mean of the M sub-models."""
    device = next(iter(stacked.values())).device
    n_all = torch.as_tensor(np.asarray(dict_len), dtype=torch.float32, device=device)
    groups = torch.as_tensor(np.asarray(dma_groups), dtype=torch.int64, device=device)
    subs = []
    for g in range(M):
        sel = {name: x[groups[g]] for name, x in stacked.items()}
        w_avg = _weighted_mean_tree(sel, torch.ones(K))
        dist = None
        for name, x in sel.items():
            if not x.is_floating_point():
                continue
            d = torch.linalg.vector_norm((x.float() - w_avg[name]).reshape(K, -1), dim=1)
            dist = d if dist is None else dist + d
        n = n_all[groups[g]]
        subs.append(_weighted_mean_tree(sel, n / n.sum() * torch.exp(-0.01 * dist / n)))
    return _weighted_mean_tree({name: torch.stack([s[name] for s in subs])
                                for name in subs[0]}, torch.ones(M))


def fedavg_rela(mats, weight, class_active_mask):
    """FedIRM's relation-matrix rows (reference: utils/FedAvg.py:95-103):
    row c is the weighted mean of the clients' rows c over the clients
    annotating class c. mats [K, C, C], mask [C, K] → [C, C]."""
    p = torch.as_tensor(np.asarray(mats), dtype=torch.float32)
    w = torch.as_tensor(np.asarray(weight), dtype=torch.float32)
    m = torch.as_tensor(np.asarray(class_active_mask), dtype=torch.float32)
    wm = m * w[None, :]
    num = torch.einsum("ck,kcd->cd", wm, p)
    return num / torch.clamp(wm.sum(1)[:, None], min=1e-12)


def _pair_dists(stacked: dict, rows, cols) -> torch.Tensor:
    """``model_dist`` between client ``rows[i]`` and client ``cols[j]`` of
    the client-stacked ``stacked`` → [len(rows), len(cols)] f32: per entry,
    all pairs at once."""
    total = None
    for x in stacked.values():
        if not x.is_floating_point():
            continue
        flat = x.float().reshape(x.shape[0], -1)
        a, b = flat[list(rows)], flat[list(cols)]
        d = torch.linalg.vector_norm(a[:, None, :] - b[None, :, :], dim=2)
        total = d if total is None else total + d
    return total


def daagg_weights(stacked: dict, dict_len, clean_clients, noisy_clients) -> torch.Tensor:
    """FedNoRo's client weights [K] (reference: utils/FedNoRo.py:84-103):
    dataset-size shares, each noisy client's scaled by exp(−d), d its least
    ``model_dist`` to a clean client over the largest such distance, then
    renormalized to sum to 1."""
    device = next(iter(stacked.values())).device
    w = torch.as_tensor(np.asarray(dict_len), dtype=torch.float32, device=device)
    w = w / w.sum()
    distance = torch.zeros_like(w)
    if len(noisy_clients) and len(clean_clients):
        dmin = _pair_dists(stacked, noisy_clients, clean_clients).min(dim=1).values
        distance[list(noisy_clients)] = dmin
    distance = distance / torch.clamp(distance.max(), min=1e-12)
    cw = w * torch.exp(-distance)
    return cw / cw.sum()


def weighted_sum(stacked: dict, weights: torch.Tensor) -> dict:
    """Σ_k weights[k]·x[k] for every entry, in f32, not divided by
    Σ weights."""
    return {name: (x.float() * weights.reshape((-1,) + (1,) * (x.dim() - 1))).sum(0)
            for name, x in stacked.items()}


def daagg(stacked: dict, dict_len, clean_clients, noisy_clients) -> dict:
    """FedNoRo distance-aware aggregation: the clients' sum weighted by
    :func:`daagg_weights` (which already sum to 1, so the sum is not divided
    again, as the reference's dict loop)."""
    return weighted_sum(stacked, daagg_weights(stacked, dict_len, clean_clients,
                                               noisy_clients))
