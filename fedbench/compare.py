"""The numbers that decide ``correct`` for a training cell, and the judgement.

The program's set-up rounds are compared with the plain reference's on the
same inputs, weights and draws:

* ``loss_gap``: the largest relative gap of a client's mean loss in a round,
  over the compared rounds and clients.
* ``grad_gap``: the gradient of client 0's first local step as the optimizer
  gets it; for each leaf |‖g‖ − ‖g_ref‖| over the larger of ‖g_ref‖ and the
  median leaf's ‖g_ref‖; the median over the leaves.
* ``change_gap``: the change of the global parameters over the compared
  rounds, each leaf measured as for ``grad_gap``, the median over the leaves.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (zero but for rounding, such as a batch-norm shift that the next
  batch norm removes) move under Adam by round-off alone and are left out.

Each is read by the worst leaf too (``grad_gap_worst``, ``change_gap_worst``),
the largest of the leaves' gaps where the plain one takes their median. A
cell compares the numbers its limits file names
(``fedbench/limits/<cell>.json``), and ``PERF.md`` gives the readings each
limit was set from and why a number is left out; a reading above its limit,
or one that is not finite, is not correct.
"""

from __future__ import annotations

import math

import torch

STILL_LEAF = 1e-3  # a leaf's reference gradient under this share of the median's


def _norms(tree: dict, names) -> dict:
    return {n: float(torch.linalg.vector_norm(tree[n].double())) for n in names}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    pn, rn = _norms(prog, names), _norms(ref, names)
    floor = _median(rn.values())
    return [abs(pn[n] - rn[n]) / max(rn[n], floor, 1e-30) for n in names]


def _of(gaps: list, pick) -> float:
    return pick(gaps) if gaps and all(map(math.isfinite, gaps)) else math.inf


def readings(prog: dict, ref: dict, initial: dict) -> dict:
    """``prog`` and ``ref``: {'losses': [[K] a round], 'first_grad': {name:
    tensor}, 'weights': {name: tensor} after the compared rounds};
    ``initial``: the weights both started from."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for pr, rr in zip(prog["losses"], ref["losses"], strict=True)
              for a, b in zip(pr, rr, strict=True)]
    names = sorted(ref["first_grad"])
    gnorm = _norms(ref["first_grad"], names)
    moving = [n for n in names if gnorm[n] >= STILL_LEAF * _median(gnorm.values())]
    change = lambda w: {n: w[n].double() - initial[n].double() for n in moving}  # noqa: E731
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"], names)
    moves = leaf_gaps(change(prog["weights"]), change(ref["weights"]), moving)
    out = {"loss_gap": _of(losses, max), "grad_gap": _of(grads, _median),
           "change_gap": _of(moves, _median), "grad_gap_worst": _of(grads, max),
           "change_gap_worst": _of(moves, max)}
    return out


def judge(read: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {'value', 'limit'}}) for the numbers ``limits``
    names: every one finite and at or under its limit. No limits, not
    correct."""
    if not limits:
        return False, {}
    checks = {n: {"value": read[n], "limit": lim} for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
