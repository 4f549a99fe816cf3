"""Checkpoint / resume (port of ``fedmlp_tpu/utils/checkpoint.py``).

A checkpoint captures the full round state:

  * global model variables (parameters and batch-norm statistics)
  * algorithm server state (τ, prototypes, tag arrays — whatever the
    algorithm keeps) and the state it registers through
    ``get_persistent`` / ``set_persistent``
  * the host RNG state (batch plans), the torch generator's state
    (augmentation, dropout and stochastic-depth draws), the round index,
    the lifetime iteration counter and the history

so training resumes where it stopped, with the same plans and draws.
Tensors are stored as numpy arrays and restored onto the trainer's device.
The file is a pickle, ``ckpt_{round}.pkl``: load only files that this
program wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_TENSOR = "__tensor__"


def _pack(tree):
    """Tensors → tagged numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return {_TENSOR: tree.detach().cpu().numpy()}
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pack(v) for v in tree)
    return tree


def _unpack(tree, device):
    """Inverse of :func:`_pack`, tensors onto ``device``."""
    if isinstance(tree, dict):
        if set(tree) == {_TENSOR}:
            return torch.as_tensor(np.asarray(tree[_TENSOR]), device=device)
        return {k: _unpack(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unpack(v, device) for v in tree)
    return tree


def _persistent_state(trainer):
    """Algorithm-registered persistent trainer state (protocol: the algo
    module exposes ``get_persistent(trainer) -> tree`` and
    ``set_persistent(trainer, tree)``), so that an algorithm with state
    outside ``server_state`` registers it instead of losing it on resume."""
    algo = getattr(trainer, "algo", None)
    if algo is not None and hasattr(algo, "get_persistent"):
        return _pack(algo.get_persistent(trainer))
    return {}


def save_checkpoint(path: str, trainer, rnd: int) -> str:
    os.makedirs(path, exist_ok=True)
    payload = {
        "round": rnd,
        "global_vars": _pack(trainer.global_vars),
        "server_state": _pack(trainer.server_state),
        "host_rng": trainer.rng.get_state(),
        "generator": trainer.generator.get_state().numpy(),
        "iter_num": trainer.iter_num,
        "history": [
            (r.round, r.client_losses, r.metrics, r.seconds)
            for r in trainer.history
        ],
        "persistent": _persistent_state(trainer),
    }
    fname = os.path.join(path, f"ckpt_{rnd}.pkl")
    with open(fname, "wb") as f:
        pickle.dump(payload, f)
    return fname


def load_checkpoint(fname: str, trainer) -> int:
    """Restore a trainer in place; returns the next round index."""
    from fedmlp_tpu_torch.train import RoundRecord

    with open(fname, "rb") as f:
        payload = pickle.load(f)
    device = trainer.device
    trainer.global_vars = _unpack(payload["global_vars"], device)
    trainer.server_state = _unpack(payload["server_state"], device)
    trainer.rng.set_state(payload["host_rng"])
    trainer.generator.set_state(torch.from_numpy(payload["generator"]))
    trainer.iter_num = payload["iter_num"]
    trainer.history = [
        RoundRecord(r, losses, m, s) for r, losses, m, s in payload["history"]
    ]
    persistent = payload.get("persistent")
    if persistent and hasattr(trainer.algo, "set_persistent"):
        trainer.algo.set_persistent(trainer, _unpack(persistent, device))
    return payload["round"] + 1
