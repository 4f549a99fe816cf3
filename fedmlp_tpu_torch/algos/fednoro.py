"""FedNoRo, federated learning with noisy clients (port of
``fedmlp_tpu/algos/fednoro.py``).

Local step (reference: utils/local_training.py:115-161): the student is the
arriving global model, the teacher a frozen copy of it in eval mode; the
loss is LA_KD (utils/FedNoRo.py:25-38)
    (1 − w_kd)·BCE(σ(logits), y) over the active classes
  +      w_kd ·MSE(σ(logits), σ(teacher_logits / 0.8)) over the missing ones,
with w_kd = sigmoid_rampup_bounded(rnd, begin, end)·a (main.py:128).

Server: FedAvg during the warm-up (main.py:269-272). From round
``rounds_warmup`` on, a 2-component GMM over the previous round's client
losses splits the clients clean/noisy (``algos/detection.py``); clean
clients then train plain BCE over the whole label matrix (reference
:162-190), noisy ones keep LA_KD (:191-231), and the server aggregates with
DaAgg (utils/FedNoRo.py:84-103). A split with no noisy client aggregates
with FedAvg. ``server_state`` holds the last split's ``clean`` and
``noisy`` id lists (None before the first split).
"""

from __future__ import annotations

import numpy as np
import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.algos.detection import split_clean_noisy_gmm
from fedmlp_tpu_torch.fl import daagg_weights, weighted_sum
from fedmlp_tpu_torch.ops import losses as L

VIEW_MODE = "single"
NEEDS_GLOBAL = True


def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, logits = apply_train(model, views["x"], generator)
    logits = logits.float()
    probs = torch.sigmoid(logits)
    soft = torch.sigmoid(views["g_logits"].float() / 0.8)  # teacher temperature
    B, C = logits.shape

    bce = masked_rows(L.bce_on_probs(probs, labels), svalid)
    mse = masked_rows((probs - soft) ** 2, svalid)
    active, negative = ctx["active"], ctx["negative"]
    bce_m = (bce * active[None, :]).sum() / (B * torch.clamp(active.sum(), min=1.0))
    kl_m = (mse * negative[None, :]).sum() / (B * torch.clamp(negative.sum(), min=1.0))
    w = scalars["weight_kd"]
    loss_kd = w * kl_m + (1.0 - w) * bce_m
    if scalars["post_warmup"] <= 0:
        return loss_kd
    # post-warm-up: clean clients drop the teacher and train BCE over the
    # full matrix; noisy clients keep LA_KD. The flag is a device scalar, so
    # the select stays on the device (no read-back a step).
    loss_clean = bce.sum() / (B * C)
    return torch.where(ctx["noisy_flag"] > 0, loss_kd, loss_clean)


def round_scalars(trainer, rnd):
    cfg = trainer.cfg.fednoro
    return {
        "weight_kd": L.sigmoid_rampup_bounded(rnd, cfg.begin, cfg.end) * cfg.a,
        "post_warmup": 1.0 if rnd >= cfg.rounds_warmup else 0.0,
    }


def extra_ctx(trainer):
    """Per-client noisy flags [K] from the last split: 1.0 for every client
    until a split names a noisy client (an empty noisy list leaves every
    client on LA_KD, as the JAX package's ``if noisy:``)."""
    noisy = trainer.server_state.get("noisy") if trainer.server_state else None
    flags = np.ones((trainer.n_clients,), np.float32)
    if noisy:
        flags[:] = 0.0
        flags[list(noisy)] = 1.0
    return {"noisy_flag": torch.as_tensor(flags, device=trainer.device)}


def init_server_state(trainer):
    return {"clean": None, "noisy": None}


def server_update(trainer, rnd, svars, server_state):
    """FedAvg during the warm-up; afterwards split the clients on the
    previous round's losses (``trainer.history[-1]``: the trainer appends
    this round's record after the server update) and aggregate with DaAgg.
    The DaAgg weights of the last such round stay in
    ``trainer.daagg_weights`` (numpy [K])."""
    cfg = trainer.cfg.fednoro
    if rnd < cfg.rounds_warmup:
        return trainer.aggregate(svars, trainer.dict_len), server_state
    losses = (np.asarray(trainer.history[-1].client_losses) if trainer.history
              else np.zeros(trainer.n_clients))
    clean, noisy = split_clean_noisy_gmm(losses, trainer.cfg.seed)
    server_state = dict(server_state, clean=clean, noisy=noisy)
    if not noisy:
        return trainer.aggregate(svars, trainer.dict_len), server_state
    cw = daagg_weights(svars, trainer.dict_len, clean, noisy)
    trainer.daagg_weights = cw.cpu().numpy()
    return weighted_sum(svars, cw), server_state
