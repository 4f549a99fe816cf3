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
the confident cells (with ``cfg.fedmlp.mixup``, on view 1 mixed in the
batch, the loss interpolated between the two samples' cells), then refresh
prototypes and τ with the trained clients. Tags live in an int8 [K, M, C]
array (0 untagged, 1 clean, 2 noise).
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.fl import fedavg_proto, fedavg_tao
from fedmlp_tpu_torch.models.stacked import stacked_apply
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.ops.mixup import draw_mixup, mixup_images
from fedmlp_tpu_torch.ops.similarity import (
    confidence_fraction,
    fedmlp_similarity_scores,
    masked_binary_prototypes,
)
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.parallel.step_graph import graph_safe
from fedmlp_tpu_torch.utils import profiling as trace

VIEW_MODE = "dual"
NEEDS_GLOBAL = True


# ----------------------------------------------------------------------
# Stage-1 loss: the reference's two sequential train-mode forwards (BN
# statistics update on view 1, then on view 2)
# ----------------------------------------------------------------------

@graph_safe
def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    _, logits1 = apply_train(model, views["x1"], generator)
    _, logits2 = apply_train(model, views["x2"], generator)
    return _stage1_loss(logits1, logits2, views, sample, svalid, ctx)


def loss_fn_viewcat(model, views, sample, svalid, ctx, generator, scalars):
    """Stage-1 loss with the two weak views run as ONE 2B forward
    (``view_concat='on'``): the same loss as ``loss_fn``, but the batch-norm
    statistics are taken over the joint 2B batch and the running statistics
    update once a step instead of twice. 'x12', where the lockstep engine
    brings it (``view_precat``), is that concatenation made once a step."""
    x = views.get("x12")
    if x is None:
        x = torch.cat([views["x1"], views["x2"]])
    _, logits = apply_train(model, x, generator)
    logits1, logits2 = logits.chunk(2)
    return _stage1_loss(logits1, logits2, views, sample, svalid, ctx)


def _stage1_loss(logits1, logits2, views, sample, svalid, ctx):
    """The stage-1 loss of one client ([B, C] logits), or of K clients at
    once ([K, B, C] logits, [K, B] ``svalid``, [K, C] ctx): then the
    per-client losses [K]."""
    labels = sample["labels"]
    p1 = torch.sigmoid(logits1.float())
    p2 = torch.sigmoid(logits2.float())
    B = logits1.shape[-2]
    g1 = torch.sigmoid(views["g_logits1"].float())
    g2 = torch.sigmoid(views["g_logits2"].float())
    sup = (L.bce_on_probs(p1, labels) + L.bce_on_probs(p2, labels)) / 2.0
    dis = ((p1 - g1) ** 2 + (p2 - g2) ** 2) / 2.0
    sup = masked_rows(sup, svalid)
    dis = masked_rows(dis, svalid)
    active = ctx["active"].unsqueeze(-2)
    negative = ctx["negative"].unsqueeze(-2)
    loss_sup = (sup * active).sum((-2, -1)) / (
        B * torch.clamp(active.sum((-2, -1)), min=1.0))
    loss_dis = (dis * negative).sum((-2, -1)) / (
        B * torch.clamp(negative.sum((-2, -1)), min=1.0))
    return loss_sup + loss_dis


def stacked_loss_fn(model, svars, views, sample, svalid, ctx, generator, scalars):
    """Stage-1 loss of all K clients in one stacked forward a view
    (``models/stacked.py``; the engine's ``make_stacked_local_round``): the
    math of ``loss_fn`` with the [K] client axis kept, the second view's
    forward on the running statistics the first one left. Returns (summed
    loss, per-client losses [K], new running statistics)."""
    (_, logits1), st1 = stacked_apply(model, svars, views["x1"], True, generator)
    (_, logits2), st2 = stacked_apply(model, {**svars, **st1}, views["x2"], True,
                                      generator)
    loss_k = _stage1_loss(logits1, logits2, views, sample, svalid, ctx)
    return loss_k.sum(), loss_k, st2


# ----------------------------------------------------------------------
# Stage-2 loss: supervised-only on view 1 over confident cells. A round
# with views made before it (pre_augment) brings the algorithm's two views:
# view 1 is then 'x1'.
# ----------------------------------------------------------------------

def stage2_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    supmask = sample["supmask"]  # [B, C] — active ∪ tagged classes
    _, logits1 = apply_train(model, views["x"] if "x" in views else views["x1"],
                             generator)
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


def stage2_stacked_loss_fn(model, svars, views, sample, svalid, ctx, generator,
                           scalars):
    """``stage2_loss_fn`` for all K clients in one stacked forward; returns
    (summed loss, per-client losses [K], new running statistics)."""
    labels = sample["labels"]  # [K, B, C]
    supmask = sample["supmask"]
    (_, logits1), st = stacked_apply(model, svars, views["x"] if "x" in views
                                     else views["x1"], True, generator)
    p1 = torch.sigmoid(logits1.float())
    sv = svalid.to(supmask.dtype)[..., None]
    cell = supmask * sv
    sup = (L.bce_on_probs(p1, labels) * cell).sum((1, 2))
    loss_k = sup / torch.clamp(cell.sum((1, 2)), min=1.0)
    glog = views.get("g_logits")
    if glog is not None:
        dcell = (1.0 - supmask) * sv
        dis = (((p1 - torch.sigmoid(glog.float())) ** 2) * dcell).sum((1, 2))
        loss_k = (sup + dis) / torch.clamp(cell.sum((1, 2)) + dcell.sum((1, 2)), min=1.0)
    return loss_k.sum(), loss_k, st


def stage2_mixup_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    """Stage 2 with in-batch mixup (``cfg.fedmlp.mixup``; the reference's
    DatasetSplit_Mixup + mixup_criterion, utils/local_training.py:1365-1415,
    827-828, an ablation path main.py never enables). Each sample of view 1
    mixes with a partner at weight lam (``draw_mixup``, before the
    forward's dropout draws); the loss interpolates the two samples'
    supervised cells, the partner's counted where both are real:
    lam · L(p, y_a | cell_a) / |cell_a| + (1 − lam) · L(p, y_b | cell_b) / |cell_b|."""
    labels = sample["labels"]
    supmask = sample["supmask"]
    x1 = views["x"] if "x" in views else views["x1"]
    lam, perm = draw_mixup(generator, x1.shape[0], x1.device)
    _, logits1 = apply_train(model, mixup_images(x1, lam, perm), generator)
    p1 = torch.sigmoid(logits1.float())
    sv = svalid.to(supmask.dtype)
    cell_a = supmask * sv[:, None]
    cell_b = supmask[perm] * (sv * sv[perm])[:, None]
    sup_a = (L.bce_on_probs(p1, labels) * cell_a).sum()
    sup_b = (L.bce_on_probs(p1, labels[perm]) * cell_b).sum()
    lam = lam.to(sup_a.dtype)
    return (lam * sup_a / torch.clamp(cell_a.sum(), min=1.0)
            + (1.0 - lam) * sup_b / torch.clamp(cell_b.sum(), min=1.0))


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
            compute_dtype=trainer.cfg.compute_dtype, mesh=trainer.round_mesh,
        )
    return trainer._fedmlp_harvest


def _get_stage2_fn(trainer):
    """Stage 2's round, on view 1 only (reference :1176-1188), on the
    trainer's engine; with ``fedmlp.mixup`` on the per-client loop, as the
    JAX package does."""
    if not hasattr(trainer, "_fedmlp_stage2_fn"):
        cfg = trainer.cfg
        if cfg.fedmlp.mixup:
            trainer._fedmlp_stage2_fn = rt.make_local_round(
                trainer.model, stage2_mixup_loss_fn, lr=cfg.base_lr,
                batch_size=cfg.batch_size, mean=cfg.data.mean, std=cfg.data.std,
                view_mode="single", needs_global=cfg.fedmlp.stage2_distill,
                augment_backend=cfg.data.augment_backend,
                compute_dtype=cfg.compute_dtype, global_model=trainer.global_model,
                hoist_augment=bool(cfg.hoist_augment),
                weight_stream_dtype=trainer.weight_stream_dtype, mesh=trainer.round_mesh)
        else:
            trainer._fedmlp_stage2_fn = trainer.make_round(
                stage2_loss_fn, stage2_stacked_loss_fn, view_mode="single",
                needs_global=cfg.fedmlp.stage2_distill)
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
        out_state, losses, _ = trainer.local_pass(
            trainer.round_fn, {"labels": fd.obs_targets}, trainer.round_scalars(rnd))
        svars = out_state["vars"]
        if rnd == stage1_rounds - 1:
            # prototypes and τ from each client's TRAINED model (:971-1002)
            feats, probs = _get_harvest(trainer)(svars, fd.images, fd.idx,
                                                 trainer.generator, trainer.loader)
            with trace.span(trace.TAGGING):
                _aggregate_tao_proto(trainer, *_extract_stats(trainer, feats, probs))
        trainer.global_vars = trainer.aggregate(svars, trainer.dict_len)
        return losses

    # ---------------- stage 2 ----------------
    harvest = _get_harvest(trainer)
    gstack = trainer.broadcast(trainer.global_vars)
    feats, _ = harvest(gstack, fd.images, fd.idx, trainer.generator, trainer.loader)
    with trace.span(trace.TAGGING):
        proto = torch.as_tensor(trainer.server_state["proto"], device=trainer.device)
        scores = torch.stack([fedmlp_similarity_scores(f, proto) for f in feats])
        order = torch.argsort(scores, dim=1, stable=True)  # stable, on device
        _update_tags(trainer, scores.cpu().numpy(), order.cpu().numpy())

    out_state, losses, _ = trainer.local_pass(
        _get_stage2_fn(trainer), _stage2_sample_arrays(trainer),
        trainer.round_scalars(rnd))
    svars = out_state["vars"]
    feats, probs = harvest(svars, fd.images, fd.idx, trainer.generator, trainer.loader)
    with trace.span(trace.TAGGING):
        _aggregate_tao_proto(trainer, *_extract_stats(trainer, feats, probs))
    trainer.global_vars = trainer.aggregate(svars, trainer.dict_len)
    return losses
