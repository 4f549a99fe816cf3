"""Server-side aggregation rules of the ported slice.

Client state arrives stacked on a leading client axis: a dict
``{name: tensor [K, ...]}`` of every model variable (parameters AND batch-norm
running statistics), as the engine returns it.
"""

from __future__ import annotations

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
