"""CBAFed, class-balanced adaptive pseudo-labels (port of
``fedmlp_tpu/algos/cbafed.py``).

Warm-up (rnd < rounds_CBAFed_warmup, reference: utils/local_training.py:
236-279): BCE_w over active classes only; clients report class_num_list /
data_num counters. Server (main.py:273-300): FedAvg, with residual weight
mixing every 5 rounds (0.2·new + 0.8·residual); at the warm-up boundary the
global threshold vector is computed:
    pt  = Σ class_num / Σ data_num
    tao = clip(pt + 0.45 − std(pt), 0.55, 0.95)

Post-warm-up (reference: utils/local_training.py:280-342): per missing
class c, batch samples with σ(logit) > τ_c get pseudo-label 1; samples with
σ < 1−τ_c count as clean; the per-batch dynamic pos_weight for c is
(noise+clean)/noise (or 1); loss = active-class supervised term + per-class
pseudo-label terms normalized by their counts. Server (main.py:301-316):
FedAvg weighted by reported data_nums, residual mixing 0.5/0.5 every 5
rounds; τ recomputed every round.

The counters leave the loss functions as ``aux`` and come back from the
engine summed over each client's steps. ``server_state`` holds ``tao``
(numpy [C]) and ``residual`` (a dict of tensors, or None).
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.parallel import fl_runtime as rt

VIEW_MODE = "single"
NEEDS_GLOBAL = False


def warmup_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits = apply_train(model, views["x"], generator)
    logits = logits.float()
    B = logits.shape[0]
    active = ctx["active"]
    sup = masked_rows(L.bce_with_logits(logits, labels, ctx["loss_w"]), svalid)
    loss = (sup * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))
    return loss, {"data_num": svalid.sum()}


def pseudo_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    tao = scalars["tao"]  # [C]
    _, logits = apply_train(model, views["x"], generator)
    logits = logits.float()
    B = logits.shape[0]
    active, negative = ctx["active"], ctx["negative"]
    sv = svalid.to(torch.float32)

    prob = torch.sigmoid(logits.detach())
    is_noise = (prob > tao[None, :]) & (sv[:, None] > 0)  # pseudo-positive
    is_clean = (prob < (1.0 - tao)[None, :]) & (sv[:, None] > 0)
    pseudo_any = (is_noise | is_clean).to(torch.float32)

    labels2 = torch.where(is_noise & (negative[None, :] > 0),
                          torch.ones_like(labels), labels)
    noise_num = (is_noise * negative[None, :]).sum(0)  # [C]
    clean_num = (is_clean * negative[None, :]).sum(0)
    lw_dyn = torch.where(noise_num > 0,
                         (noise_num + clean_num) / torch.clamp(noise_num, min=1.0),
                         torch.ones_like(noise_num))
    loss_w = torch.where(negative > 0, lw_dyn, ctx["loss_w"])

    elem = masked_rows(L.bce_with_logits(logits, labels2, loss_w), svalid)
    loss = (elem * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))
    # per missing class: pseudo-sample mean (reference :331-333)
    per_cls = (elem * pseudo_any * negative[None, :]).sum(0)
    cnt = (pseudo_any * negative[None, :]).sum(0)
    loss = loss + torch.where(cnt > 0, per_cls / torch.clamp(cnt, min=1.0),
                              torch.zeros_like(cnt)).sum()

    class_num = active * sv.sum() + negative * cnt
    data_num = sv.sum() * torch.clamp(active.sum(), min=1.0) + (cnt * negative).sum()
    return loss, {"class_num": class_num, "data_num": data_num}


# the Trainer builds its default round_fn from `loss_fn`
loss_fn = warmup_loss_fn


def init_server_state(trainer):
    C = trainer.fd.n_classes
    return {"tao": np.full((C,), 0.95, np.float32), "residual": None}


def _get_pseudo_fn(trainer):
    if not hasattr(trainer, "_cbafed_pseudo_fn"):
        trainer._cbafed_pseudo_fn = rt.make_local_round(
            trainer.model, pseudo_loss_fn,
            lr=trainer.cfg.base_lr, batch_size=trainer.cfg.batch_size,
            mean=trainer.cfg.data.mean, std=trainer.cfg.data.std,
            view_mode="single",
            augment_backend=trainer.cfg.data.augment_backend,
            compute_dtype=trainer.cfg.compute_dtype,
            hoist_augment=bool(trainer.cfg.hoist_augment),
            weight_stream_dtype=trainer.weight_stream_dtype, mesh=trainer.round_mesh,
        )
    return trainer._cbafed_pseudo_fn


def _residual_mix(new_vars: dict, res_vars: dict, w_new: float) -> dict:
    return {n: w_new * v + (1.0 - w_new) * res_vars[n] for n, v in new_vars.items()}


def _server_mix(trainer, st, w_new: dict, phase_rnd: int, mix: float) -> None:
    """Every 5th round of a phase the aggregate is mixed with the residual
    (except the phase's first round) and becomes the new residual."""
    if phase_rnd % 5 == 0:
        if phase_rnd != 0 and st["residual"] is not None:
            w_new = _residual_mix(w_new, st["residual"], mix)
        st["residual"] = w_new
    trainer.global_vars = w_new


def custom_round(trainer, rnd: int):
    st = trainer.server_state
    warmup = trainer.cfg.cbafed.rounds_warmup
    scalars = trainer.round_scalars(rnd)
    labels = {"labels": trainer.fd.obs_targets}

    if rnd < warmup:
        out_state, losses, aux = trainer.local_pass(trainer.round_fn, labels, scalars)
        # warm-up counters (reference :274-276): class_num[active] = data_num
        data_nums = aux["data_num"].cpu().numpy()  # [K]
        class_nums = trainer.fd.active.cpu().numpy() * data_nums[:, None]
        w_new = trainer.aggregate(out_state["vars"], trainer.dict_len)
        _server_mix(trainer, st, w_new, rnd, 0.2)
        if rnd >= warmup - 1:
            _update_tao(st, class_nums, data_nums)
        return losses

    # ---------------- post-warm-up ----------------
    scalars["tao"] = torch.as_tensor(st["tao"], device=trainer.device)
    out_state, losses, aux = trainer.local_pass(_get_pseudo_fn(trainer), labels, scalars)
    class_nums = aux["class_num"].cpu().numpy()  # [K, C]
    data_nums = aux["data_num"].cpu().numpy()  # [K]
    wti = data_nums / max(data_nums.sum(), 1e-12)
    w_new = trainer.aggregate(out_state["vars"], wti)
    _server_mix(trainer, st, w_new, rnd - warmup, 0.5)
    _update_tao(st, class_nums, data_nums)
    return losses


def _update_tao(st, class_nums, data_nums):
    """tao = clip(pt + 0.45 − std(pt), 0.55, 0.95) (main.py:289-300)."""
    pt = class_nums.sum(0) / max(data_nums.sum(), 1e-12)
    std = np.sqrt(((pt - pt.mean()) ** 2).sum() / max(len(pt) - 1, 1))
    st["tao"] = np.clip(pt + 0.45 - std, 0.55, 0.95).astype(np.float32)
