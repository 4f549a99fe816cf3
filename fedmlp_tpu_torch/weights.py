"""Weights between the JAX package's flax variables and the port's
``state_dict``.

The port names its submodules after the flax modules, so the map is
mechanical: a flax path ``params/block1_0/dw_conv/kernel`` is the key
``block1_0.dw_conv.weight``. Layouts:

* conv kernel HWIO [kh, kw, I/groups, O] → OIHW [O, I/groups, kh, kw] (a
  depthwise [k, k, 1, C] becomes [C, 1, k, k]);
* Dense kernel [in, out] → Linear weight [out, in];
* batch norm ``scale``/``bias`` → ``weight``/``bias``, batch_stats
  ``mean``/``var`` → ``running_mean``/``running_var``;
* a parameter flax declares itself under the name ``weight`` (the cosine
  head's [in, num_classes]) keeps its name and layout. In a ``state_dict``
  it is the one 2-D ``weight`` of a module named ``head``
  (``models/heads.py::FCNormHead``).

Conv and Dense biases map unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias", "weight": "weight"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaf_from_jax(coll: str, path: tuple, a) -> tuple[str, np.ndarray]:
    """One flax leaf (collection, module path + leaf name, array) → its
    ``state_dict`` key and float32 array in the port's layout (a view of
    ``a`` where no cast is needed)."""
    a = np.asarray(a, dtype=np.float32)
    leaf = path[-1]
    if leaf == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    name = ".".join(tuple(path[:-1]) + (_LEAF[coll][leaf],))
    return name, a


def leaf_to_jax(name: str, a: np.ndarray) -> tuple[str, tuple, np.ndarray]:
    """Inverse of :func:`leaf_from_jax`: a ``state_dict`` key and array →
    (collection, flax path, array in flax's layout)."""
    *mods, leaf = name.split(".")
    if leaf in ("running_mean", "running_var"):
        coll, jleaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "bias":
        coll, jleaf = "params", "bias"
    elif a.ndim == 1:  # a 1-D weight is a batch-norm scale
        coll, jleaf = "params", "scale"
    elif a.ndim == 2 and mods and mods[-1] == "head":  # the cosine head
        coll, jleaf = "params", "weight"
    else:
        coll, jleaf = "params", "kernel"
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return coll, tuple(mods) + (jleaf,), np.array(a, order="C", copy=True)


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """flax variables ``{'params': ..., 'batch_stats': ...}`` of numpy
    arrays → the port's ``state_dict`` (float32 CPU tensors)."""
    sd = {}
    for coll in _LEAF:
        for path, v in _walk(variables.get(coll, {})):
            name, a = leaf_from_jax(coll, path, v)
            sd[name] = torch.tensor(a)
    return sd


def to_jax_variables(state_dict) -> dict:
    """Inverse of :func:`from_jax_variables`: ``state_dict`` → nested flax
    variables of numpy float32 arrays."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        coll, path, a = leaf_to_jax(name, t.detach().cpu().float().numpy())
        node = out[coll]
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = a
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
