"""Mixup (port of ``fedmlp_tpu/ops/mixup.py``; FedMLP's stage-2 ablation).

The reference mixes in two places, both behind ablation flags that
main.py never sets (SURVEY.md §2.2): DatasetSplit_Mixup, which mixes each
sample with a partner at a Beta(1, 1) weight (utils/local_training.py:
1365-1415), and mixup_criterion, which interpolates the loss (:827-828).

The draws are explicit: :func:`draw_mixup` takes them from a
``torch.Generator``, and the mix is a plain function of (images, lam,
perm), so a caller (or a test) can pass draws of its own. Beta(1, 1) is
U(0, 1); the port draws lam that way and has no other alpha.
"""

from __future__ import annotations

import torch


def draw_mixup(generator: torch.Generator, batch: int, device=None):
    """(lam, perm): lam ~ U(0, 1) = Beta(1, 1), a scalar f32 tensor, and a
    random permutation of the batch's ``batch`` rows (each row's partner)."""
    device = generator.device if device is None else device
    lam = torch.rand((), generator=generator, device=device)
    perm = torch.randperm(batch, generator=generator, device=device)
    return lam, perm


def mixup_images(images: torch.Tensor, lam: torch.Tensor,
                 perm: torch.Tensor) -> torch.Tensor:
    """lam · images + (1 − lam) · images[perm], lam in the images' type."""
    lam = lam.to(images.dtype)
    return lam * images + (1.0 - lam) * images[perm]


def mixup_batch(images, targets, lam, perm):
    """(mixed images, targets_a, targets_b, lam): the reference's
    DatasetSplit_Mixup return contract (utils/local_training.py:1388-1406)."""
    return mixup_images(images, lam, perm), targets, targets[perm], lam


def mixup_criterion(loss_fn, pred, y_a, y_b, lam):
    """lam · L(pred, y_a) + (1 − lam) · L(pred, y_b)
    (reference: utils/local_training.py:827-828)."""
    return lam * loss_fn(pred, y_a) + (1.0 - lam) * loss_fn(pred, y_b)
