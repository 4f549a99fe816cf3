"""FedLSR, label-smoothing regularization (port of
``fedmlp_tpu/algos/fedlsr.py``).

Local step (reference: utils/local_training.py:1270-1326): two weak views;
temperature-sharpened sigmoids (T=1/3, i.e. logits·3) clamped to
[1e-6, 1]; the two views' probabilities mixed with weights mix1 ~
Beta(1,1) = U(0,1) and 1 − mix1, through inverse-sigmoid space and
re-sharpened at ·2; loss:
    BCEWithLogits_w(pred_mix, y) mean      (pred_mix is a probability fed
                                            to a with-logits loss, as in
                                            the reference)
  + β·JS(sharp1, sharp2),  β = 0.4·min(rnd/t_w, 1)

Server: FedAvg.
"""

from __future__ import annotations

import torch

from fedmlp_tpu_torch.algos.base import apply_train, masked_rows
from fedmlp_tpu_torch.ops import losses as L

VIEW_MODE = "dual"
NEEDS_GLOBAL = False


def draw_mix(generator: torch.Generator, device) -> torch.Tensor:
    """The step's mix weight mix1 ~ U(0, 1) (the reference's
    np.random.beta(1, 1)), one f32 draw from the trainer's generator."""
    return torch.rand((), generator=generator, device=device)


def loss_fn(model, views, sample, svalid, ctx, generator, scalars):
    labels = sample["labels"]
    _, l1 = apply_train(model, views["x1"], generator)
    _, l2 = apply_train(model, views["x2"], generator)
    l1, l2 = l1.float(), l2.float()
    C = l1.shape[1]

    mix1 = draw_mix(generator, l1.device)
    sharp1 = torch.clamp(torch.sigmoid(l1 * 3.0), 1e-6, 1.0)
    sharp2 = torch.clamp(torch.sigmoid(l2 * 3.0), 1e-6, 1.0)
    p = torch.sigmoid(l1) * mix1 + torch.sigmoid(l2) * (1.0 - mix1)
    pred_mix = torch.sigmoid(L.anti_sigmoid(p) * 2.0)

    elem = masked_rows(L.bce_with_logits(pred_mix, labels, ctx["loss_w"]), svalid)
    # torch reduction='mean' over the actual batch
    n = torch.clamp(svalid.to(torch.float32).sum() * C, min=1.0)
    return elem.sum() / n + L.js_divergence(sharp1, sharp2) * scalars["beta"]


def round_scalars(trainer, rnd):
    t_w = trainer.cfg.fedlsr.t_w
    return {"beta": 0.4 * rnd / t_w if rnd < t_w else 0.4}
