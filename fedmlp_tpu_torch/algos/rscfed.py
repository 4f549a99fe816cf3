"""RSCFed, mean-teacher SSL with sub-consensus aggregation (port of
``fedmlp_tpu/algos/rscfed.py``).

Local step (reference: utils/local_training.py:705-769): the student trains
on view 1; a PERSISTENT per-client mean teacher (initialized from the
initial global model, main.py:77) forwards view 2; after every step the
engine moves the teacher's whole state dict toward the student's with
weight 0.001 (:752-760). Loss:
    BCE_w(logits1, y) over active classes / (B·|active|)
  + MSE(σ(logits1), σ(teacher_logits2)) mean over missing-class cells.

Server (main.py:114-121, 213-215): M=10 random groups of K_g=6 clients,
each a distance-reweighted sub-consensus, then their mean
(``fl/aggregate.py::rscfed``).
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.fl import rscfed as agg_rscfed
from fedmlp_tpu_torch.ops import losses as L
from fedmlp_tpu_torch.parallel import fl_runtime as rt

VIEW_MODE = "dual"
NEEDS_GLOBAL = False
NEEDS_TEACHER = True
TEACHER_DECAY = 0.999  # weight1 = 1 - 0.001
N_GROUPS, GROUP_SIZE = 10, 6


def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits1 = apply_train(model, views["x1"], generator)
    logits1 = logits1.float()
    p1 = torch.sigmoid(logits1)
    pt = torch.sigmoid(views["t_logits2"].float())
    B = logits1.shape[0]
    active, negative = ctx["active"], ctx["negative"]

    sup = masked_rows(L.bce_with_logits(logits1, labels, ctx["loss_w"]), svalid)
    loss_sup = (sup * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))
    mse = masked_rows((p1 - pt) ** 2, svalid)
    # torch F.mse_loss 'mean' over the [B, |neg|] submatrix
    loss_unsup = (mse * negative[None, :]).sum() / (B * torch.clamp(negative.sum(), min=1.0))
    return loss_sup + loss_unsup


def _get_round_fn(trainer):
    if not hasattr(trainer, "_rscfed_round_fn"):
        cfg = trainer.cfg
        trainer._rscfed_round_fn = rt.make_local_round(
            trainer.model, loss_fn, lr=cfg.base_lr, batch_size=cfg.batch_size,
            mean=cfg.data.mean, std=cfg.data.std, view_mode="dual",
            teacher_decay=TEACHER_DECAY, teacher_scope="all",
            augment_backend=cfg.data.augment_backend,
            compute_dtype=cfg.compute_dtype, teacher_model=trainer.teacher_model,
            hoist_augment=bool(cfg.hoist_augment),
            weight_stream_dtype=trainer.weight_stream_dtype, mesh=trainer.round_mesh,
        )
    return trainer._rscfed_round_fn


def get_persistent(trainer):
    """Checkpoint protocol: the persistent mean teacher survives resume."""
    if hasattr(trainer, "_rscfed_teacher"):
        return {"teacher": trainer._rscfed_teacher}
    return {}


def set_persistent(trainer, state):
    if "teacher" in state:
        trainer._rscfed_teacher = state["teacher"]


def custom_round(trainer, rnd: int):
    if not hasattr(trainer, "_rscfed_teacher"):
        # the teacher starts as the INITIAL global model (main.py:77) and
        # then persists across rounds (restored on resume)
        trainer._rscfed_teacher = trainer.broadcast(trainer.global_vars)
    out_state, losses, _ = trainer.local_pass(
        _get_round_fn(trainer), {"labels": trainer.fd.obs_targets},
        trainer.round_scalars(rnd), extra_state={"teacher": trainer._rscfed_teacher})
    trainer._rscfed_teacher = out_state["teacher"]

    # DMA sub-consensus groups (main.py:114-121), drawn after the round's
    # batch plan from the same numpy stream as the JAX package
    k_g = min(GROUP_SIZE, trainer.n_clients)
    dma = np.stack([trainer.rng.choice(trainer.n_clients, size=k_g, replace=False)
                    for _ in range(N_GROUPS)])
    trainer.global_vars = agg_rscfed(dma, out_state["vars"], k_g, trainer.dict_len,
                                     N_GROUPS)
    return losses
