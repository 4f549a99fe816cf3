"""Weights between the JAX package's flax variables and the port's
``state_dict``.

The port names its submodules after the flax modules, so the map is
mechanical: a flax path ``params/block1_0/dw_conv/kernel`` is the key
``block1_0.dw_conv.weight``. Layouts:

* conv kernel HWIO [kh, kw, I, O] → OIHW [O, I, kh, kw] (a depthwise
  [k, k, 1, C] becomes [C, 1, k, k]);
* Dense kernel [in, out] → Linear weight [out, in];
* batch norm ``scale``/``bias`` → ``weight``/``bias``, batch_stats
  ``mean``/``var`` → ``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """flax variables ``{'params': ..., 'batch_stats': ...}`` of numpy
    arrays → the port's ``state_dict`` (float32 CPU tensors)."""
    sd = {}
    for coll, leaf_map in (("params", _PARAM_LEAF), ("batch_stats", _STAT_LEAF)):
        for path, v in _walk(variables.get(coll, {})):
            a = np.asarray(v, dtype=np.float32)
            name = ".".join(path[:-1] + (leaf_map[path[-1]],))
            sd[name] = torch.from_numpy(np.array(_to_torch_layout(a), copy=True))
    return sd


def to_jax_variables(state_dict) -> dict:
    """Inverse of :func:`from_jax_variables`: ``state_dict`` → nested flax
    variables of numpy float32 arrays."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        a = t.detach().cpu().float().numpy()
        if leaf in ("running_mean", "running_var"):
            coll, jleaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            coll, jleaf = "params", "bias"
        elif a.ndim == 1:  # a 1-D weight is a batch-norm scale
            coll, jleaf = "params", "scale"
        else:
            coll, jleaf = "params", "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = out[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[jleaf] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
