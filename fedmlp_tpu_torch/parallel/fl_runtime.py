"""Federated-learning runtime: federation tables, batch plans, the per-client
local round, the feature harvest and the evaluation forward.

The JAX package compiles a round into one program over client-stacked
state; here a round is a Python loop over clients, each trained in turn on
one working module (the JAX package's mapped engine, ``make_local_round``,
with ``lax.map`` over clients and ``lax.scan`` over steps written out).

Parity notes (as in the JAX package):
  * Adam is created afresh for every client every round (the reference
    constructs a new torch.optim.Adam per call, utils/local_training.py:
    912-913), with L2 weight decay added to the gradient.
  * Losses divide by the CONFIGURED batch size: a ragged last batch is
    filled with the client's first sample, masked out of the loss, yet
    still part of the batch-norm statistics, exactly as there.
  * A step with no valid sample is skipped: params, batch-norm statistics
    and the Adam moments and count all stay as they were.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from fedmlp_tpu_torch.data.masking import (
    build_active_matrix,
    build_client_index_table,
    observed_targets,
)
from fedmlp_tpu_torch.ops import augment as A


def torch_adam(params, lr: float) -> torch.optim.Adam:
    """The reference optimizer (utils/local_training.py:636-637), which the
    JAX package's ``torch_adam`` optax chain mirrors: Adam with L2 weight
    decay 5e-4 added to the gradient."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=5e-4)


def autocast(device: torch.device, compute_dtype: str):
    """bf16 autocast on the card when ``compute_dtype`` is 'bfloat16';
    float32 everywhere else (the CPU always computes in float32)."""
    if compute_dtype == "bfloat16" and device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


# ----------------------------------------------------------------------
# Federated data: device-resident packed arrays + per-client tables
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FederatedData:
    """All static data of a federation, on the device."""

    images: torch.Tensor       # u8 [N, H, W, 3]
    targets: torch.Tensor      # f32 [N, C] true labels
    obs_targets: torch.Tensor  # f32 [K, M, C] observed (masked) labels
    idx: torch.Tensor          # i64 [K, M] global sample index table
    valid: torch.Tensor        # bool [K, M]
    active: torch.Tensor       # bool [K, C]
    loss_w: torch.Tensor       # f32 [K, C] pos_weight = N_k / class_count
    class_num: torch.Tensor    # f32 [K, C] true per-class counts
    n_local: torch.Tensor      # i32 [K]

    @property
    def n_clients(self) -> int:
        return self.idx.shape[0]

    @property
    def n_classes(self) -> int:
        return self.targets.shape[1]

    @property
    def max_local(self) -> int:
        return self.idx.shape[1]


def build_federated_data(images, targets, dict_users, hidden, active_class_lists,
                         device="cuda") -> FederatedData:
    """Densify the reference's Python-side bookkeeping into tensors
    (reference: DatasetSplit + get_num_of_each_class + loss_w,
    utils/local_training.py:38-43, label masking :1347-1356)."""
    K = len(active_class_lists)
    C = targets.shape[1]
    idx, valid = build_client_index_table(dict_users, K)
    active = build_active_matrix(active_class_lists, C)
    M = idx.shape[1]
    obs = np.zeros((K, M, C), np.float32)
    loss_w = np.zeros((K, C), np.float32)
    class_num = np.zeros((K, C), np.float32)
    n_local = valid.sum(1).astype(np.int32)
    for k in range(K):
        tk = targets[idx[k]]
        obs[k] = observed_targets(tk, hidden[idx[k]], active[k])
        obs[k][~valid[k]] = 0.0
        cn = (tk * valid[k][:, None]).sum(0)
        class_num[k] = cn
        loss_w[k] = n_local[k] / np.maximum(cn, 1e-12)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FederatedData(
        images=dev(images), targets=dev(targets, torch.float32),
        obs_targets=dev(obs), idx=dev(idx, torch.int64), valid=dev(valid),
        active=dev(active), loss_w=dev(loss_w), class_num=dev(class_num),
        n_local=dev(n_local),
    )


def make_batch_plan(rng: np.random.RandomState, valid: np.ndarray,
                    batch_size: int, local_ep: int):
    """Per-epoch shuffled batch positions for every client → (pos [S, K, B],
    pos_valid [S, K, B], steps_per_epoch), S = local_ep·max_k ⌈n_k/B⌉; the
    same numpy stream as the JAX package, so the plans are identical."""
    valid = np.asarray(valid)
    K, M = valid.shape
    sizes = valid.sum(1)
    steps = int(np.ceil(sizes.max() / batch_size))
    S = local_ep * steps
    pos = np.zeros((S, K, batch_size), np.int32)
    pos_valid = np.zeros((S, K, batch_size), bool)
    for k in range(K):
        mine = np.where(valid[k])[0]
        for e in range(local_ep):
            perm = rng.permutation(mine)
            padded = np.zeros(steps * batch_size, np.int32)
            vmask = np.zeros(steps * batch_size, bool)
            padded[: len(perm)] = perm
            vmask[: len(perm)] = True
            sl = slice(e * steps, (e + 1) * steps)
            pos[sl, k] = padded.reshape(steps, batch_size)
            pos_valid[sl, k] = vmask.reshape(steps, batch_size)
    return pos, pos_valid, steps


def broadcast_to_clients(variables: dict, n_clients: int) -> dict:
    """Global variables as a client-stacked dict [K, ...] (expanded views,
    no copies): the reference's per-client deepcopy(netglob)."""
    return {n: v[None].expand((n_clients,) + v.shape) for n, v in variables.items()}


def client_vars(stacked: dict, k: int) -> dict:
    return {n: v[k] for n, v in stacked.items()}


# ----------------------------------------------------------------------
# Local round
# ----------------------------------------------------------------------

def make_local_round(model, loss_fn, *, lr: float, batch_size: int, mean, std,
                     view_mode: str = "single", needs_global: bool = False,
                     augment_backend: str = "auto",
                     compute_dtype: str = "float32", global_model=None):
    """A function running one local round for every client in turn.

    ``loss_fn(model, views, sample, svalid, ctx, generator, scalars) ->
    loss`` computes ONE client's step loss with ``model`` in train mode
    (which updates its batch-norm running statistics).

    * ``views`` — 'x' (single) or 'x1'/'x2' (dual) f32 NCHW views, plus the
      frozen global model's eval-mode logits 'g_logits' or
      'g_logits1'/'g_logits2' when ``needs_global``.
    * ``sample`` — per-sample rows of the plan's [K, M, ...] tables.
    * ``ctx`` — the client's rows of the per-client context.

    ``round_fn(global_vars, data, plan, scalars, generator)`` takes
      data = {'images' u8 [N,H,W,3], 'idx' [K,M], 'ctx' {name: [K, ...]}}
      plan = {'pos' [S,K,B], 'pos_valid' [S,K,B] (numpy), 'sample'
              {name: [K, M, ...]}}
    and returns ({'vars': client-stacked variables}, mean_losses [K]).
    ``global_model`` is a second module of the same architecture for the
    frozen-global forwards (built when ``needs_global``).
    """
    weak = A.pick_weak_backend(augment_backend)

    def augment_views(imgs_u8, generator):
        if view_mode == "single":
            return {"x": weak(imgs_u8, generator, mean, std)}
        if view_mode != "dual":
            raise ValueError(f"view_mode {view_mode!r} is not ported")
        return {"x1": weak(imgs_u8, generator, mean, std),
                "x2": weak(imgs_u8, generator, mean, std)}

    def round_fn(global_vars, data, plan, scalars, generator):
        pos, pos_valid = plan["pos"], plan["pos_valid"]
        S, K, B = pos.shape
        device = data["images"].device
        pos_d = torch.as_tensor(pos, dtype=torch.int64, device=device)
        valid_d = torch.as_tensor(pos_valid, device=device)
        cast = autocast(device, compute_dtype)
        if needs_global:
            global_model.load_state_dict(global_vars)
            global_model.eval()
        stacked = {n: torch.empty((K,) + v.shape, dtype=v.dtype, device=device)
                   for n, v in global_vars.items()}
        mean_losses = torch.zeros((K,), dtype=torch.float32, device=device)
        for k in range(K):
            model.load_state_dict(global_vars)
            model.train()
            opt = torch_adam(model.parameters(), lr)
            ctx = {n: v[k] for n, v in data["ctx"].items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            cnt = 0
            for s in range(S):
                if not pos_valid[s, k].any():
                    continue  # padding step: a true no-op
                p = pos_d[s, k]
                imgs = data["images"][data["idx"][k, p]]
                sample = {n: t[k, p] for n, t in plan["sample"].items()}
                views = augment_views(imgs, generator)
                with cast:
                    if needs_global:
                        with torch.no_grad():
                            for v in [v for v in views if v.startswith("x")]:
                                _, g = global_model(views[v])
                                views["g_logits" + v[1:]] = g
                    loss = loss_fn(model, views, sample, valid_d[s, k], ctx,
                                   generator, scalars)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                loss_sum += loss.detach().float()
                cnt += 1
            mean_losses[k] = loss_sum / max(cnt, 1)
            for n, v in model.state_dict().items():
                stacked[n][k].copy_(v)
        return {"vars": stacked}, mean_losses

    return round_fn


# ----------------------------------------------------------------------
# Feature harvest: per-client features + probs over the padded table
# (FedMLP prototype/τ extraction, reference utils/local_training.py:
#  971-1002, 1023-1049, 1208-1250)
# ----------------------------------------------------------------------

def make_harvest_fn(model, mean, std, batch_size: int, augment_backend: str = "auto",
                    compute_dtype: str = "float32"):
    """``harvest(stacked_vars, images, idx [K, M], generator)`` →
    (features [K, M, D], probs [K, M, C]): each client's own weights, in
    eval mode, over its table in chunks of ``batch_size`` (the last chunk
    edge-padded), on the weak view as the reference's image_aug_1
    (utils/local_training.py:982)."""
    weak = A.pick_weak_backend(augment_backend)

    @torch.no_grad()
    def harvest(stacked_vars, images, idx, generator):
        K, M = idx.shape
        nb = math.ceil(M / batch_size)
        pad = nb * batch_size - M
        idx_p = torch.cat([idx, idx[:, -1:].expand(K, pad)], 1) if pad else idx
        cast = autocast(images.device, compute_dtype)
        feats, probs = [], []
        for k in range(K):
            model.load_state_dict(client_vars(stacked_vars, k))
            model.eval()
            fk, pk = [], []
            for j in range(nb):
                imgs = images[idx_p[k, j * batch_size:(j + 1) * batch_size]]
                x = weak(imgs, generator, mean, std)
                with cast:
                    f, logits = model(x)
                fk.append(f.float())
                pk.append(torch.sigmoid(logits.float()))
            feats.append(torch.cat(fk)[:M])
            probs.append(torch.cat(pk)[:M])
        return torch.stack(feats), torch.stack(probs)

    return harvest


# ----------------------------------------------------------------------
# Evaluation forward
# ----------------------------------------------------------------------

def make_eval_fn(model, mean, std, batch_size: int = 128,
                 compute_dtype: str = "float32"):
    @torch.no_grad()
    def evaluate_probs(global_vars, images_u8) -> np.ndarray:
        """Probabilities [N, C] of the global model on host u8 NHWC images,
        sent to the device one chunk at a time."""
        device = next(model.parameters()).device
        model.load_state_dict(global_vars)
        model.eval()
        cast = autocast(device, compute_dtype)
        out = []
        for s in range(0, images_u8.shape[0], batch_size):
            chunk = torch.as_tensor(np.asarray(images_u8[s:s + batch_size]),
                                    device=device)
            with cast:
                _, logits = model(A.eval_batch(chunk, mean, std))
            out.append(torch.sigmoid(logits.float()).cpu().numpy())
        return np.concatenate(out, axis=0)

    return evaluate_probs
