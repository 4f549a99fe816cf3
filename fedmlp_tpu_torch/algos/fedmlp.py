"""FedMLP — the flagship two-stage method (reference:
utils/local_training.py:904-1256 + server side main.py:216-237), ported from
``fedmlp_tpu/algos/fedmlp.py``.

Stage 1 (rnd < rounds_stage1): BCE on two weak views over the active
classes + MSE to the frozen global model's probabilities over the missing
classes; the last stage-1 round harvests per-class binary prototypes and
per-missing-class confidence fractions τ with each client's trained model.

Stage 2: harvest the untagged pool with the arriving global model, score it
against the prototypes, tag the top clean_threshold / bottom
noise_threshold fractions on the host, train on view 1 with BCE masked to
the confident cells, then refresh prototypes and τ with the trained
clients. Tags live in an int8 [K, M, C] array (0 untagged, 1 clean,
2 noise).
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.fl import fedavg_proto, fedavg_tao
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.ops.similarity import (
    confidence_fraction,
    fedmlp_similarity_scores,
    masked_binary_prototypes,
)
from fedmlp_tpu_torch.parallel import fl_runtime as rt

VIEW_MODE = "dual"
NEEDS_GLOBAL = True


# ----------------------------------------------------------------------
# Stage-1 loss: the reference's two sequential train-mode forwards (BN
# statistics update on view 1, then on view 2)
# ----------------------------------------------------------------------

def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits1 = apply_train(model, views["x1"], generator)
    _, logits2 = apply_train(model, views["x2"], generator)
    p1 = torch.sigmoid(logits1.float())
    p2 = torch.sigmoid(logits2.float())
    B = logits1.shape[0]
    g1 = torch.sigmoid(views["g_logits1"].float())
    g2 = torch.sigmoid(views["g_logits2"].float())
    sup = (L.bce_on_probs(p1, labels) + L.bce_on_probs(p2, labels)) / 2.0
    dis = ((p1 - g1) ** 2 + (p2 - g2) ** 2) / 2.0
    sup = masked_rows(sup, svalid)
    dis = masked_rows(dis, svalid)
    active, negative = ctx["active"], ctx["negative"]
    loss_sup = (sup * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))
    loss_dis = (dis * negative[None, :]).sum() / (B * torch.clamp(negative.sum(), min=1.0))
    return loss_sup + loss_dis


# ----------------------------------------------------------------------
# Stage-2 loss: supervised-only on view 1 over confident cells
# ----------------------------------------------------------------------

def stage2_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    supmask = sample["supmask"]  # [B, C] — active ∪ tagged classes
    _, logits1 = apply_train(model, views["x"], generator)
    p1 = torch.sigmoid(logits1.float())
    cell = supmask * svalid.to(supmask.dtype)[:, None]
    sup = L.bce_on_probs(p1, labels) * cell
    loss = sup.sum() / torch.clamp(cell.sum(), min=1.0)
    glog = views.get("g_logits")
    if glog is not None:
        # paper-behavior distillation term (cfg.fedmlp.stage2_distill; the
        # released reference comments it out, :1187-1188)
        dcell = (1.0 - supmask) * svalid.to(supmask.dtype)[:, None]
        dis = ((p1 - torch.sigmoid(glog.float())) ** 2) * dcell
        denom = torch.clamp(cell.sum() + dcell.sum(), min=1.0)
        loss = (sup.sum() + dis.sum()) / denom
    return loss


# ----------------------------------------------------------------------
# Extraction: prototypes + τ for every client
# ----------------------------------------------------------------------

def _extract_stats(trainer, feats, probs):
    """(features [K,M,D], probs [K,M,C]) → (taos [K,C], protos [K,2C,D]).
    Prototypes use the observed labels of active classes; τ counts
    confident samples of missing classes (reference :985-1000)."""
    fd = trainer.fd
    C = fd.n_classes
    fm = trainer.cfg.fedmlp
    taos, protos = [], []
    for k in range(fd.n_clients):
        valid = fd.valid[k].float()
        active = fd.active[k].float()
        proto, _ = masked_binary_prototypes(feats[k], fd.obs_targets[k], valid, C)
        proto = proto * torch.repeat_interleave(active, 2)[:, None]
        t = confidence_fraction(probs[k], valid, fm.L, fm.U)
        taos.append(t * (1.0 - active))
        protos.append(proto)
    return torch.stack(taos), torch.stack(protos)


# ----------------------------------------------------------------------
# Host-side tagging (data-dependent top-k counts)
# ----------------------------------------------------------------------

def _update_tags(trainer, scores: np.ndarray, order: np.ndarray) -> None:
    """Accumulate clean/noise tags (reference: utils/local_training.py:
    1066-1112). scores [K, M, C]; ``order`` is the stable ascending argsort
    of scores along M. Vectorized over (K, C): selecting by rank in the
    stable full-table sort equals a stable sort of each pool subset."""
    st = trainer.server_state
    tags = st["tags"]  # int8 [K, M, C]
    cfg = trainer.cfg.fedmlp
    valid = trainer.fd.valid.cpu().numpy()
    active = trainer.fd.active.cpu().numpy().astype(bool)
    K, M, C = tags.shape

    pool = valid[:, :, None] & (tags == 0)
    n_clean_cand = (pool & (scores >= 0)).sum(axis=1)
    n_noise_cand = (pool & (scores < 0)).sum(axis=1)
    if cfg.difficulty_estimate:
        t = np.maximum(st["tao"].astype(np.float64), cfg.tao_min)[None, :]
        clean_frac, noise_frac = t, t
    else:
        clean_frac = np.float64(cfg.clean_threshold)
        noise_frac = np.float64(cfg.noise_threshold)
    clean_n = (clean_frac * n_clean_cand).astype(np.int64)
    noise_n = (noise_frac * n_noise_cand).astype(np.int64)
    clean_n = np.where(active, 0, clean_n)
    noise_n = np.where(active, 0, noise_n)

    pool_sorted = np.take_along_axis(pool, order, axis=1)
    rank = np.cumsum(pool_sorted, axis=1)  # 1-based rank within pool
    total = rank[:, -1:, :]
    new_sorted = np.zeros((K, M, C), np.int8)
    noise_band = pool_sorted & (rank <= noise_n[:, None, :])
    clean_band = pool_sorted & (rank > total - clean_n[:, None, :])
    new_sorted[noise_band] = 2
    new_sorted[clean_band] = 1
    new_tags = np.zeros_like(tags)
    np.put_along_axis(new_tags, order, new_sorted, axis=1)
    np.copyto(tags, new_tags, where=new_tags != 0)


def _stage2_sample_arrays(trainer):
    """Pseudo labels + supervision mask from the tags (DatasetSplit_pseudo,
    reference :1456-1469): non-active classes zeroed, tagged noise set to
    1; supervise active ∪ tagged cells."""
    fd = trainer.fd
    tags = trainer.server_state["tags"]
    active = fd.active.cpu().numpy()[:, None, :]
    true_k = fd.targets.cpu().numpy()[fd.idx.cpu().numpy()]
    labels = true_k * active
    labels = np.where(tags == 2, 1.0, labels).astype(np.float32)
    supmask = (active | (tags > 0)).astype(np.float32)
    return {
        "labels": torch.as_tensor(labels, device=trainer.device),
        "supmask": torch.as_tensor(supmask, device=trainer.device),
    }


# ----------------------------------------------------------------------
# Trainer hooks
# ----------------------------------------------------------------------

def init_server_state(trainer):
    from fedmlp_tpu_torch.models import feature_dim_of

    fd = trainer.fd
    C = fd.n_classes
    return {
        "tao": np.zeros((C,), np.float32),
        "proto": np.zeros((2 * C, feature_dim_of(trainer.cfg.model)), np.float32),
        "tags": np.zeros((fd.n_clients, fd.max_local, C), np.int8),
    }


def _get_harvest(trainer):
    if not hasattr(trainer, "_fedmlp_harvest"):
        trainer._fedmlp_harvest = rt.make_harvest_fn(
            trainer.model, trainer.cfg.data.mean, trainer.cfg.data.std,
            batch_size=trainer.cfg.batch_size * 4,
            augment_backend=trainer.cfg.data.augment_backend,
            compute_dtype=trainer.cfg.compute_dtype,
        )
    return trainer._fedmlp_harvest


def _get_stage2_fn(trainer):
    if not hasattr(trainer, "_fedmlp_stage2_fn"):
        if trainer.cfg.fedmlp.mixup:
            raise NotImplementedError("fedmlp.mixup is not ported yet")
        trainer._fedmlp_stage2_fn = rt.make_local_round(
            trainer.model, stage2_loss_fn,
            lr=trainer.cfg.base_lr,
            batch_size=trainer.cfg.batch_size,
            mean=trainer.cfg.data.mean,
            std=trainer.cfg.data.std,
            # stage 2 trains on view 1 only (reference :1176-1188)
            view_mode="single",
            needs_global=trainer.cfg.fedmlp.stage2_distill,
            augment_backend=trainer.cfg.data.augment_backend,
            compute_dtype=trainer.cfg.compute_dtype,
            global_model=trainer.global_model,
        )
    return trainer._fedmlp_stage2_fn


def _aggregate_tao_proto(trainer, taos, protos):
    st = trainer.server_state
    active = trainer.fd.active.cpu().numpy()
    st["tao"] = fedavg_tao(taos, trainer.dict_len, (~active).T).cpu().numpy()
    # λ = 1: full replacement (main.py:233-234)
    st["proto"] = fedavg_proto(protos, trainer.dict_len, active.T).cpu().numpy()


def custom_round(trainer, rnd: int):
    cfg = trainer.cfg
    stage1_rounds = cfg.fedmlp.rounds_stage1
    fd = trainer.fd
    if rnd < stage1_rounds:
        out_state, losses = trainer.local_pass(
            trainer.round_fn, {"labels": fd.obs_targets}, trainer.round_scalars(rnd))
        svars = out_state["vars"]
        if rnd == stage1_rounds - 1:
            # prototypes and τ from each client's TRAINED model (:971-1002)
            feats, probs = _get_harvest(trainer)(svars, fd.images, fd.idx,
                                                 trainer.generator)
            _aggregate_tao_proto(trainer, *_extract_stats(trainer, feats, probs))
        trainer.global_vars = trainer.aggregate(svars, trainer.dict_len)
        return losses

    # ---------------- stage 2 ----------------
    harvest = _get_harvest(trainer)
    gstack = trainer.broadcast(trainer.global_vars)
    feats, _ = harvest(gstack, fd.images, fd.idx, trainer.generator)
    proto = torch.as_tensor(trainer.server_state["proto"], device=trainer.device)
    scores = torch.stack([fedmlp_similarity_scores(f, proto) for f in feats])
    order = torch.argsort(scores, dim=1, stable=True)  # stable, on device
    _update_tags(trainer, scores.cpu().numpy(), order.cpu().numpy())

    out_state, losses = trainer.local_pass(
        _get_stage2_fn(trainer), _stage2_sample_arrays(trainer),
        trainer.round_scalars(rnd))
    svars = out_state["vars"]
    feats, probs = harvest(svars, fd.images, fd.idx, trainer.generator)
    _aggregate_tao_proto(trainer, *_extract_stats(trainer, feats, probs))
    trainer.global_vars = trainer.aggregate(svars, trainer.dict_len)
    return losses
