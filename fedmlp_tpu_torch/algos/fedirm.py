"""FedIRM, inter-client relation matching (port of
``fedmlp_tpu/algos/fedirm.py``).

Supervised phase (rnd < rounds_FedIRM_sup, reference:
utils/local_training.py:344-390): BCE_w on both weak views over active
classes; at the last supervised round each client reports its relation
("confusion") matrix, class-conditional mean logits sharpened by a sigmoid
at T=2 (get_confuse_matrix, :73-81), averaged over its steps.

Relation phase (:392-464): a per-step EMA teacher over the parameters
(update_ema_variables, :62-65, α = min(1 − 1/(it + 1), ema_decay)),
initialized from the arriving global model at the first relation round;
samples pass an uncertainty filter (entropy < 2.0) AND a confidence filter
(every class prob > 0.7 or < 0.3); their hard pseudo-labels build the local
source relation matrix (0.5 everywhere when no sample passes); loss:
    cw·Σ sigmoid_mse(outputs, ema_outputs)/B
  + cw·sym-KL(source, target relation)
  + supervised BCE on both views (active classes)
with cw = consistency·sigmoid_rampup(rnd, rampup) (:91-92).

Server (main.py:238-252): FedAvg; the relation matrix aggregated row by row
over the clients annotating the class (``fedavg_rela``), replacing the old.
``server_state`` holds ``relation`` (numpy [C, C]) and ``ema_init``.
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.fl import fedavg_rela
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.parallel import fl_runtime as rt

VIEW_MODE = "dual"
NEEDS_GLOBAL = False
NEEDS_TEACHER = True


def _confuse_matrix(logits, labels, sample_w):
    """get_confuse_matrix over C classes with sample weights (reference:
    utils/local_training.py:73-81): row i = σ(mean logits over the samples
    positive for class i / 2)."""
    w = labels * sample_w[:, None]  # [B, C]
    sums = w.T @ logits  # [C, C]
    counts = w.sum(0)[:, None]
    return torch.sigmoid(sums / (counts + 1e-8) / 2.0)


def _supervised(l1, l2, labels, svalid, ctx):
    B = l1.shape[0]
    active = ctx["active"]
    sup = masked_rows(L.bce_with_logits(l1, labels, ctx["loss_w"])
                      + L.bce_with_logits(l2, labels, ctx["loss_w"]), svalid)
    return (sup * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))


def _aux(logits, labels, svalid):
    cm = _confuse_matrix(logits.detach(), labels, svalid.to(torch.float32))
    return {"confusion": cm, "steps": torch.ones((), device=logits.device)}


def sup_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, l1 = apply_train(model, views["x1"], generator)
    _, l2 = apply_train(model, views["x2"], generator)
    l1, l2 = l1.float(), l2.float()
    return _supervised(l1, l2, labels, svalid, ctx), _aux(l1, labels, svalid)


loss_fn = sup_loss_fn  # the Trainer's default round_fn (supervised phase)


def relation_loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, outputs = apply_train(model, views["x1"], generator)
    _, l2 = apply_train(model, views["x2"], generator)
    outputs, l2 = outputs.float(), l2.float()
    cw = scalars["consistency_weight"]
    B = outputs.shape[0]
    sv = svalid.to(torch.float32)

    preds = torch.sigmoid(outputs.detach())
    unc_mask = L.binary_entropy_per_class(preds).sum(1) < 2.0
    conf_mask = ((preds > 0.7) | (preds < 0.3)).all(dim=1)
    mask = unc_mask & conf_mask & (sv > 0)
    pseudo = (preds > 0.5).to(torch.float32)
    source = _confuse_matrix(outputs, pseudo, mask.to(torch.float32))
    source = torch.where(mask.any(), source, torch.full_like(source, 0.5))

    ema_output = views["t_logits2"].float()
    consistency = masked_rows(L.sigmoid_mse(outputs, ema_output), svalid).sum() / B
    loss = cw * consistency + cw * L.kd_symmetric_kl(source, scalars["target_matrix"])
    loss = loss + _supervised(outputs, l2, labels, svalid, ctx)
    return loss, _aux(outputs, labels, svalid)


def get_persistent(trainer):
    """Checkpoint protocol: the EMA teacher survives resume (otherwise the
    relation phase would silently restart it from the global model)."""
    if hasattr(trainer, "_fedirm_teacher"):
        return {"teacher": trainer._fedirm_teacher}
    return {}


def set_persistent(trainer, state):
    if "teacher" in state:
        trainer._fedirm_teacher = state["teacher"]


def init_server_state(trainer):
    C = trainer.fd.n_classes
    return {"relation": np.full((C, C), 0.5, np.float32), "ema_init": False}


def _get_relation_fn(trainer):
    if not hasattr(trainer, "_fedirm_rel_fn"):
        cfg = trainer.cfg
        trainer._fedirm_rel_fn = rt.make_local_round(
            trainer.model, relation_loss_fn, lr=cfg.base_lr,
            batch_size=cfg.batch_size, mean=cfg.data.mean, std=cfg.data.std,
            view_mode="dual", teacher_decay=cfg.fedirm.ema_decay,
            teacher_iter_corrected=True, teacher_scope="params",
            augment_backend=cfg.data.augment_backend,
            compute_dtype=cfg.compute_dtype, teacher_model=trainer.teacher_model,
            hoist_augment=bool(cfg.hoist_augment),
            weight_stream_dtype=trainer.weight_stream_dtype,
        )
    return trainer._fedirm_rel_fn


def _aggregate_relation(trainer, aux):
    cms = (aux["confusion"] / aux["steps"][:, None, None]).cpu().numpy()
    act_mask = trainer.fd.active.cpu().numpy().T  # [C, K]
    trainer.server_state["relation"] = fedavg_rela(cms, trainer.dict_len,
                                                   act_mask).numpy()


def custom_round(trainer, rnd: int):
    cfg = trainer.cfg.fedirm
    st = trainer.server_state
    scalars = trainer.round_scalars(rnd)
    labels = {"labels": trainer.fd.obs_targets}

    if rnd < cfg.rounds_sup:
        out_state, losses, aux = trainer.local_pass(trainer.round_fn, labels, scalars)
        trainer.global_vars = trainer.aggregate(out_state["vars"], trainer.dict_len)
        if rnd == cfg.rounds_sup - 1:
            _aggregate_relation(trainer, aux)
        return losses

    # relation phase: the teacher starts from the arriving global model at
    # the first relation round (reference :393-396)
    if not st["ema_init"] or not hasattr(trainer, "_fedirm_teacher"):
        trainer._fedirm_teacher = trainer.broadcast(trainer.global_vars)
        st["ema_init"] = True
    scalars["target_matrix"] = torch.as_tensor(st["relation"], device=trainer.device)
    scalars["consistency_weight"] = float(np.float32(
        cfg.consistency * L.sigmoid_rampup(rnd, cfg.consistency_rampup)))
    out_state, losses, aux = trainer.local_pass(
        _get_relation_fn(trainer), labels, scalars,
        extra_state={"teacher": trainer._fedirm_teacher})
    trainer._fedirm_teacher = out_state["teacher"]
    trainer.global_vars = trainer.aggregate(out_state["vars"], trainer.dict_len)
    _aggregate_relation(trainer, aux)
    return losses
