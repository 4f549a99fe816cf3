"""FedMLP's rounds in plain float32 (the FedMLP reference's
utils/local_training.py:904-1256 and main.py:216-237 as the program states
them), written apart from the program.

A local pass: each client k in turn starts from the global weights with a
fresh Adam (lr, betas 0.9/0.999, eps 1e-8, L2 weight decay 5e-4 added to the
gradient) and takes one step per batch of its shuffled split; it ends with
every variable, running statistics included, averaged over the clients
weighted by their split sizes.

Stage 1 (round < ``rounds_stage1``): a step makes two weak views of the
batch, runs the frozen global model on both in eval mode and the client's
model on view 1, then view 2, in train mode (each forward moves the running
statistics), and minimizes BCE on the probabilities of the client's annotated
classes, averaged over the views, plus the squared gap to the global model's
probabilities on its missing classes, each sum divided by the configured
batch size and the class count.

Only stage 1 is written here: the last stage-1 round's harvest and stage 2
(harvests, tagging, the masked loss, prototypes and τ) wait for the cell that
runs them, so ``rounds`` refuses a count of rounds that reaches either.

Draws: the batch plan comes from ``numpy.random.RandomState(seed)``, one
permutation per client and epoch in client order each pass; the views,
stochastic depth and dropout come, in the order the program states, from one
``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fedbench.reference import views as V

ADAM = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=5e-4)
FAULTS = ("half_batch",)


def is_param(name: str) -> bool:
    return not name.endswith((".running_mean", ".running_var"))


def batch_plan(rng: np.random.RandomState, sizes, batch_size: int, local_ep: int):
    """(pos [S, K, B] into each client's sorted split, valid [S, K, B]): per
    client and epoch a permutation, padded to whole batches of the largest
    split."""
    K = len(sizes)
    steps = int(np.ceil(max(sizes) / batch_size))
    pos = np.zeros((local_ep * steps, K, batch_size), np.int64)
    valid = np.zeros(pos.shape, bool)
    for k in range(K):
        for e in range(local_ep):
            perm = rng.permutation(np.arange(sizes[k]))
            flat = np.zeros(steps * batch_size, np.int64)
            ok = np.zeros(steps * batch_size, bool)
            flat[:len(perm)] = perm
            ok[:len(perm)] = True
            pos[e * steps:(e + 1) * steps, k] = flat.reshape(steps, batch_size)
            valid[e * steps:(e + 1) * steps, k] = ok.reshape(steps, batch_size)
    return pos, valid


def active_classes(K: int, C: int, per_client: int) -> torch.Tensor:
    """[K, C]: client k annotates classes k·a … k·a + a − 1 (mod C)."""
    act = torch.zeros((K, C))
    for k in range(K):
        for j in range(per_client):
            act[k, (k * per_client + j) % C] = 1.0
    return act


def bce(p, y):
    return F.binary_cross_entropy(p, y, reduction="none")


def stage1_loss(l1, l2, g1, g2, labels, svalid, active, batch_size: int):
    p1, p2 = torch.sigmoid(l1), torch.sigmoid(l2)
    q1, q2 = torch.sigmoid(g1), torch.sigmoid(g2)
    sup = (bce(p1, labels) + bce(p2, labels)) / 2.0
    dis = ((p1 - q1) ** 2 + (p2 - q2) ** 2) / 2.0
    v = svalid[:, None]
    neg = 1.0 - active
    loss_sup = (sup * v * active).sum() / (batch_size * active.sum().clamp(min=1.0))
    loss_dis = (dis * v * neg).sum() / (batch_size * neg.sum().clamp(min=1.0))
    return loss_sup + loss_dis


class Federation:
    """The inputs both sides are given, as the reference lays them out: each
    client's sorted split, its observed labels (every positive of a class it
    does not annotate hidden: p_pos 0), the class masks, the split sizes."""

    def __init__(self, images, labels, dict_users: dict, annotation_num: int):
        self.images, self.labels = images, labels
        device = images.device
        self.K, self.C = len(dict_users), labels.shape[1]
        self.idx = [torch.as_tensor(sorted(dict_users[k]), dtype=torch.int64, device=device)
                    for k in range(self.K)]
        self.sizes = [len(i) for i in self.idx]
        self.active = active_classes(self.K, self.C, annotation_num).to(device)
        self.obs = [labels[self.idx[k]] * self.active[k] for k in range(self.K)]
        self.weight = torch.tensor(self.sizes, dtype=torch.float32, device=device)
        if len(set(self.sizes)) != 1:
            raise NotImplementedError("the reference takes splits of one size")


def weighted_mean(states: list, weight) -> dict:
    return {n: sum(st[n] * weight[k] for k, st in enumerate(states)) / weight.sum()
            for n in states[0]}


def local_pass(model, glob: dict, fed: Federation, rng, gen, *, batch_size: int,
               local_ep: int, lr: float, mean, std, quant: bool, fault,
               first: dict | None = None):
    """One stage-1 local pass of every client → (client states, mean losses
    [K]). ``first``, when empty, receives the gradient of the first step."""
    pos, pos_valid = batch_plan(rng, fed.sizes, batch_size, local_ep)
    states, losses = [], []
    for k in range(fed.K):
        w = {n: t.clone().requires_grad_(is_param(n)) for n, t in glob.items()}
        pnames = [n for n in w if is_param(n)]
        opt = torch.optim.Adam([w[n] for n in pnames], lr=lr, foreach=False, **ADAM)
        total, count = torch.zeros((), device=fed.images.device), 0
        for s in range(pos.shape[0]):
            if not pos_valid[s, k].any():
                continue
            at = torch.as_tensor(pos[s, k], device=fed.images.device)
            svalid = torch.as_tensor(pos_valid[s, k], dtype=torch.float32,
                                     device=fed.images.device)
            B = batch_size
            if fault == "half_batch":
                at, svalid, B = at[:batch_size // 2], svalid[:batch_size // 2], batch_size // 2
            imgs = fed.images[fed.idx[k][at]]
            x1 = V.weak_view(imgs, gen, mean, std)
            x2 = V.weak_view(imgs, gen, mean, std)
            with torch.no_grad():
                _, g1 = model.forward(glob, x1, False, quant=quant)
                _, g2 = model.forward(glob, x2, False, quant=quant)
            upd = {}
            _, l1 = model.forward(w, x1, True, gen, upd, quant)
            w.update(upd)
            upd = {}
            _, l2 = model.forward(w, x2, True, gen, upd, quant)
            w.update(upd)
            loss = stage1_loss(l1, l2, g1, g2, fed.obs[k][at], svalid, fed.active[k], B)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if first is not None and not first:
                first.update({n: w[n].grad.detach().clone() for n in pnames})
            opt.step()
            total += loss.detach()
            count += 1
        losses.append(float(total) / max(count, 1))
        states.append({n: t.detach() for n, t in w.items()})
    return states, losses


def rounds(model, weights: dict, images, labels, dict_users: dict, *, seed: int,
           rounds: int, rounds_stage1: int, batch_size: int, local_ep: int, lr: float,
           annotation_num: int, mean, std, quant: bool = False,
           fault: str | None = None) -> dict:
    """``rounds`` stage-1 rounds from ``weights`` → {'losses': [[K] a
    round], 'first_grad': {name: the gradient of client 0's first step},
    'weights': the global variables after the last round}. ``model`` is a
    module of ``fedbench.reference.models``; ``quant`` computes its
    convolutions on fp8 operands (the control); ``fault`` plants one of
    ``FAULTS``."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if rounds >= rounds_stage1:
        raise NotImplementedError(f"{rounds} rounds reach the harvest of the last stage-1 "
                                  f"round ({rounds_stage1}); the reference follows stage 1 only")
    fed = Federation(images, labels, dict_users, annotation_num)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=images.device)
    gen.manual_seed(seed)
    glob = {n: t.detach().clone() for n, t in weights.items()}
    out = {"losses": [], "first_grad": {}}
    for _ in range(rounds):
        states, losses = local_pass(model, glob, fed, rng, gen, batch_size=batch_size,
                                    local_ep=local_ep, lr=lr, mean=mean, std=std, quant=quant,
                                    fault=fault, first=out["first_grad"])
        glob = weighted_mean(states, fed.weight)
        out["losses"].append(losses)
    out["weights"] = glob
    return out
