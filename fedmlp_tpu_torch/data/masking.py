"""Label hiding and client views as fixed-shape arrays.

The reference hides labels through Python index lists threaded across three
layers (``class_pos_idx_1``/``class_neg_idx_1`` built at main.py:58-66 and
consumed sample-by-sample in DatasetSplit.__getitem__, reference:
utils/local_training.py:1347-1356). Here all of it becomes static-shape
boolean masks:

  * ``hidden[N, C]``  — positive (n, c) whose label is masked to 0 for every
    client that does not annotate class c.
  * ``client_idx[K, M]`` + ``client_valid[K, M]`` — each client's sample
    indices padded to a common length M (ragged dict_users → dense table).
  * ``active[K, C]``  — one-hot active-class matrix per client.

The observed label seen by client k is then a pure function:
    obs[n, c] = target[n, c] * (active[k, c] OR NOT hidden[n, c])
which reproduces DatasetSplit semantics exactly.
"""

from __future__ import annotations

import numpy as np


def build_hidden_mask(
    targets: np.ndarray, p_pos: float, seed_rng: np.random.RandomState | None = None
) -> np.ndarray:
    """For every class c, mark a (1 - p_pos) fraction of its positive samples
    as hidden (reference: main.py:58-66 with p_pos_1 = 0. → all hidden).

    Returns bool [N, C]. Uses the supplied RNG to match the reference's use
    of the global numpy stream right after set_seed.
    """
    rng = seed_rng if seed_rng is not None else np.random.RandomState(0)
    N, C = targets.shape
    hidden = np.zeros((N, C), dtype=bool)
    for c in range(C):
        pos_idx = np.where(targets[:, c] == 1)[0]
        n_hide = int((1.0 - p_pos) * len(pos_idx))
        if n_hide > 0:
            hide = rng.choice(pos_idx, n_hide, replace=False)
            hidden[hide, c] = True
    return hidden


def build_client_index_table(
    dict_users: dict[int, list[int]], n_clients: int, pad_multiple: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Densify {client: [indices]} into (idx[K, M], valid[K, M]).

    M = max client size rounded up to ``pad_multiple``. Padding rows repeat
    the client's first index with valid=False so gathers stay in-bounds.
    """
    sizes = [len(dict_users[k]) for k in range(n_clients)]
    M = max(sizes)
    if pad_multiple > 1:
        M = ((M + pad_multiple - 1) // pad_multiple) * pad_multiple
    idx = np.zeros((n_clients, M), dtype=np.int32)
    valid = np.zeros((n_clients, M), dtype=bool)
    for k in range(n_clients):
        mine = np.asarray(sorted(dict_users[k]), dtype=np.int32)
        idx[k, : len(mine)] = mine
        idx[k, len(mine):] = mine[0] if len(mine) else 0
        valid[k, : len(mine)] = True
    return idx, valid


def build_active_matrix(active_class_lists: list[list[int]], n_classes: int) -> np.ndarray:
    """One-hot active-class matrix [K, C] from per-client class lists
    (reference: main.py:76 builds active_class_list=[i])."""
    K = len(active_class_lists)
    active = np.zeros((K, n_classes), dtype=bool)
    for k, classes in enumerate(active_class_lists):
        active[k, classes] = True
    return active


def observed_targets(
    targets: np.ndarray, hidden: np.ndarray, active_row: np.ndarray
) -> np.ndarray:
    """Observed labels for one client: zero non-active hidden positives
    (reference: utils/local_training.py:1347-1356)."""
    keep = active_row[None, :] | ~hidden
    return targets * keep.astype(targets.dtype)


def class_client_lists(active: np.ndarray) -> tuple[list[list[int]], list[list[int]]]:
    """Per-class active/negative client lists (reference: main.py:200-210)."""
    K, C = active.shape
    class_active = [[k for k in range(K) if active[k, c]] for c in range(C)]
    class_negative = [[k for k in range(K) if not active[k, c]] for c in range(C)]
    return class_active, class_negative
