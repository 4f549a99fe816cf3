"""RoFL, robust FL with per-class binary feature centroids (port of
``fedmlp_tpu/algos/rofl.py``).

Reference: utils/local_training.py:466-626 (train_RoFL + RFLloss +
get_small_loss_samples); the server's aggregation per the (commented) block
at main.py:253-268: FedAvg of the weights and a cosine-similarity-weighted
aggregation of the centroids into the global table f_G.

A round:
  1. an eval pass of the global model over each client's data: hard
     pseudo-labels pseudo[item] = 1{σ(logit) > 0.5}; at round 0 the local
     centroids f_k are the per-(class, 0/1) feature means, afterwards
     f_k = f_G (:480-510).
  2. every step: small-loss selection keeps the (1 − forget_rate) fraction
     with the smallest per-sample BCE (pos_weight = loss_w with missing
     classes at 5.0, :615-626); agreement m_i = 1 where the centroid-nearest
     binary code equals the observed labels (:526-533); before T_pl rounds
     the selected samples refresh the pseudo table with their observed
     labels (:536-538); training labels m·y + (1 − m)·pseudo (:541-544);
     loss L_c + λ_cen·L_cen + λ_e·L_e (RFLloss, :582-613), λ_cen ramped by
     round/T_pl; f_k moves toward the selected batch's feature means by
     squared cosine similarity (:553-572).

Per-client state ``cstate = {'f_k' [2C, D], 'pseudo' [M, C]}`` goes
through the engine's ``post_step``; the pseudo table is indexed by table
position. ``server_state`` holds ``f_G``, ``pseudo`` and
``forget_schedule`` (numpy).

Known difference: the JAX package's ``pseudo.at[pos].set(upd)`` also
scatters a ragged batch's padding rows, which point at table position 0;
on its CPU the last write wins, so a refresh of position 0 in such a batch
is lost. Here only the valid rows are written, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train
from fedmlp_tpu_torch.models import feature_dim_of
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.ops.similarity import masked_binary_prototypes, rofl_centroid_update
from fedmlp_tpu_torch.parallel import fl_runtime as rt

VIEW_MODE = "single"
NEEDS_GLOBAL = False

_EPS = 1e-12


def loss_fn(model, views, sample, svalid, ctx, generator, scalars, cstate):
    labels = sample["labels"]
    f_k = cstate["f_k"]  # [2C, D]
    feature, logit = apply_train(model, views["x"], generator)
    feature, logit = feature.detach().float(), logit.float()
    B, C = logit.shape
    D = f_k.shape[1]
    sv = svalid.to(torch.float32)

    # ---- small-loss selection (:615-626): loss_w with missing classes = 5
    loss_w_sel = torch.where(ctx["negative"] > 0, 5.0, ctx["loss_w"])
    per_sample = L.bce_with_logits(logit.detach(), labels, loss_w_sel).sum(1)
    per_sample = torch.where(sv > 0, per_sample, torch.full_like(per_sample, float("inf")))
    num_remember = torch.floor((1.0 - scalars["forget_rate"]) * sv.sum())
    rank = torch.argsort(torch.argsort(per_sample, stable=True), stable=True)
    sel = (rank < num_remember).to(torch.float32) * sv

    # ---- centroid agreement (:526-533)
    f_pairs = f_k.reshape(C, 2, D)
    fn = feature / torch.clamp(torch.linalg.norm(feature, dim=1, keepdim=True), min=_EPS)
    pn = f_pairs / torch.clamp(torch.linalg.norm(f_pairs, dim=2, keepdim=True), min=_EPS)
    sims = torch.einsum("bd,ctd->bct", fn, pn)  # [B, C, 2]
    y_tilde = (sims[..., 1] > sims[..., 0]).to(torch.float32)
    agree = (y_tilde == labels).all(dim=1).to(torch.float32) * sel

    pseudo = cstate["pseudo"][sample["_pos"]]  # [B, C]
    new_labels = agree[:, None] * labels + (1.0 - agree[:, None]) * pseudo

    # ---- RFLloss (:582-613)
    elem = L.bce_with_logits(logit, new_labels, ctx["loss_w"])
    n_sel = torch.clamp(sel.sum(), min=1.0)
    L_c = (elem * sel[:, None]).sum() / (n_sel * C)  # torch mean over sel×C
    # L_cen: per class, the squared distance to the centroid of the
    # sample's bit, over the agreeing selected samples
    cent = f_pairs[torch.arange(C, device=labels.device)[None, :], labels.long()]  # [B, C, D]
    se = ((feature[:, None, :] - cent) ** 2).sum(-1)
    L_cen = ((agree[:, None] * se * sel[:, None]).sum(0) / (n_sel * D)).sum() / C
    # L_e: binary entropy of the selected samples, per class, averaged
    ent = L.binary_entropy_per_class(torch.sigmoid(logit))
    L_e = ((ent * sel[:, None]).sum(0) / n_sel).sum() / C

    loss = L_c + scalars["lambda_cen_r"] * L_cen + scalars["lambda_e"] * L_e
    aux = {
        "feature": feature,
        "sel": sel,
        # the in-training pseudo refresh runs only before T_pl (:536-538)
        "sel_pl": sel * scalars["before_T_pl"],
        "labels": labels,
    }
    return loss, aux


def post_step(cstate, aux, sample, svalid, ctx):
    """Per-step centroid EMA and pseudo-table refresh (:536-572)."""
    f_k, pseudo = cstate["f_k"], cstate["pseudo"]
    feature, sel, labels = aux["feature"], aux["sel"], aux["labels"]
    C = labels.shape[1]

    # f_kj_hat: the selected batch's per-(class, bit) feature means (:553-567)
    w = torch.stack([sel[:, None] * (1.0 - labels), sel[:, None] * labels],
                    dim=2).reshape(-1, 2 * C)  # [B, 2C]
    f_kj_hat = (w.T @ feature) / torch.clamp(w.sum(0), min=1.0)[:, None]

    # refresh of the selected samples (sel_pl is 0 from T_pl on); the
    # padding rows write into a scratch row M that is dropped
    sel_pl = aux["sel_pl"][:, None]
    pos = sample["_pos"]
    M = pseudo.shape[0]
    table = torch.cat([pseudo, pseudo[:1]])
    table[torch.where(svalid, pos, M)] = sel_pl * labels + (1.0 - sel_pl) * pseudo[pos]
    return {"f_k": rofl_centroid_update(f_k, f_kj_hat), "pseudo": table[:M]}


def init_server_state(trainer):
    cfg = trainer.cfg
    C = trainer.fd.n_classes
    rng = np.random.RandomState(cfg.seed)
    return {
        # f_G ~ N(0, 1) (main.py:99)
        "f_G": rng.randn(2 * C, feature_dim_of(cfg.model)).astype(np.float32),
        "pseudo": np.zeros((trainer.n_clients, trainer.fd.max_local, C), np.float32),
        "forget_schedule": _forget_schedule(cfg),
    }


def _forget_schedule(cfg):
    """The forget rate ramps linearly over num_gradual rounds (main.py:100-104)."""
    sched = np.ones(cfg.rounds_warmup) * cfg.rofl.forget_rate
    n = min(cfg.rofl.num_gradual, cfg.rounds_warmup)
    sched[:n] = np.linspace(0, cfg.rofl.forget_rate, n)
    return sched.astype(np.float32)


def _get_fns(trainer):
    if not hasattr(trainer, "_rofl_round_fn"):
        cfg = trainer.cfg
        trainer._rofl_round_fn = rt.make_local_round(
            trainer.model, loss_fn, lr=cfg.base_lr, batch_size=cfg.batch_size,
            mean=cfg.data.mean, std=cfg.data.std, view_mode="single",
            post_step=post_step, augment_backend=cfg.data.augment_backend,
            compute_dtype=cfg.compute_dtype, hoist_augment=bool(cfg.hoist_augment),
            weight_stream_dtype=trainer.weight_stream_dtype,
        )
        trainer._rofl_harvest = rt.make_harvest_fn(
            trainer.model, cfg.data.mean, cfg.data.std, batch_size=cfg.batch_size * 4,
            augment_backend=cfg.data.augment_backend, compute_dtype=cfg.compute_dtype,
        )
    return trainer._rofl_round_fn, trainer._rofl_harvest


def _scalars(trainer, rnd: int) -> dict:
    """The round's RoFL scalars as float32 values, as the JAX package forms
    them (forget_rate a device scalar, so the step's selection count stays
    on the device)."""
    st, cfg = trainer.server_state, trainer.cfg.rofl
    f32 = np.float32
    sched = st["forget_schedule"]
    lambda_cen = f32(cfg.lambda_cen)
    if f32(rnd) < f32(cfg.T_pl):
        lambda_cen = lambda_cen * f32(rnd) / f32(cfg.T_pl)
    return {
        "forget_rate": torch.tensor(sched[min(rnd, len(sched) - 1)],
                                    dtype=torch.float32, device=trainer.device),
        "lambda_cen_r": float(lambda_cen),
        "lambda_e": float(f32(cfg.lambda_e)),
        "before_T_pl": 1.0 if rnd < cfg.T_pl else 0.0,
    }


def custom_round(trainer, rnd: int):
    st = trainer.server_state
    fd = trainer.fd
    C = fd.n_classes
    round_fn, harvest = _get_fns(trainer)

    # 1. eval pass: global-guided pseudo-labels, refreshed EVERY round
    # (reference :480-496; only the in-training write-back is gated by T_pl),
    # and round 0's centroids
    feats, probs = harvest(trainer.broadcast(trainer.global_vars), fd.images, fd.idx,
                           trainer.generator, trainer.loader)
    pseudo = (probs > 0.5).to(torch.float32)
    if rnd == 0:
        f_k0 = torch.stack([masked_binary_prototypes(feats[k], fd.obs_targets[k],
                                                     fd.valid[k], C)[0]
                            for k in range(trainer.n_clients)])
    else:
        f_G = torch.as_tensor(st["f_G"], device=trainer.device)
        f_k0 = f_G[None].expand((trainer.n_clients,) + f_G.shape)

    scalars = trainer.round_scalars(rnd)
    scalars.update(_scalars(trainer, rnd))
    out_state, losses, _ = trainer.local_pass(
        round_fn, {"labels": fd.obs_targets}, scalars,
        extra_state={"cstate": {"f_k": f_k0, "pseudo": pseudo}})
    f_locals = out_state["cstate"]["f_k"].cpu().numpy()  # [K, 2C, D]
    st["pseudo"] = out_state["cstate"]["pseudo"].cpu().numpy()
    trainer.global_vars = trainer.aggregate(out_state["vars"], trainer.dict_len)

    # centroid aggregation by cosine similarity to f_G (main.py:256-268)
    f_G = st["f_G"]
    w_sum = np.zeros((2 * C, 1), np.float32)
    tmp = np.zeros_like(f_G)
    for f in f_locals:
        sim = (f_G * f).sum(1) / np.maximum(
            np.linalg.norm(f_G, axis=1) * np.linalg.norm(f, axis=1), _EPS)
        w_sum += sim[:, None]
        tmp += sim[:, None] * f
    w_sum[w_sum == 0] = 1.0
    st["f_G"] = (tmp / w_sum).astype(np.float32)
    return losses
