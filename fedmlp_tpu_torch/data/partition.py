"""Client partitioning.

Re-implements the reference samplers with identical random semantics so that
cached partitions are reproducible from (dataset, seed, n_clients) alone:

  * ``iid_sampling`` — equal-size random split without replacement
    (reference: utils/sampling.py:6-17).
  * ``non_iid_dirichlet_sampling`` — Bernoulli class-selection + Dirichlet
    assignment. The reference implementation (utils/sampling.py:20-49)
    stratifies by per-sample positive-label count and indexes ``Psi[0]`` /
    ``num_clients_per_class[0]`` for every stratum; that exact behavior is
    kept behind ``faithful=True`` (default) for parity, while
    ``faithful=False`` provides the evidently intended per-class variant.
"""

from __future__ import annotations

import numpy as np


def iid_sampling(n_train: int, num_users: int, seed: int) -> dict[int, list[int]]:
    """Equal-size IID split, matching reference RNG stream exactly
    (reference: utils/sampling.py:6-17)."""
    rng = np.random.RandomState(seed)
    num_items = n_train // num_users
    dict_users: dict[int, list[int]] = {}
    all_idxs = list(range(n_train))
    for i in range(num_users):
        chosen = set(rng.choice(all_idxs, num_items, replace=False).tolist())
        dict_users[i] = list(chosen)
        all_idxs = list(set(all_idxs) - chosen)
    return dict_users


def non_iid_dirichlet_sampling(
    y_train: np.ndarray,
    num_classes: int,
    p: float,
    num_users: int,
    seed: int,
    alpha_dirichlet: float,
    faithful: bool = True,
) -> dict[int, list[int]]:
    """Non-IID Dirichlet partition over label-count strata.

    ``y_train`` is the multi-label one-hot table [N, C]. Strata are the
    per-sample positive-label counts 0..C (reference: utils/sampling.py:33-34).
    """
    rng = np.random.RandomState(seed)
    Phi = rng.binomial(1, p, size=(num_users, num_classes))
    n_classes_per_client = np.sum(Phi, axis=1)
    while np.min(n_classes_per_client) == 0:
        invalid_idx = np.where(n_classes_per_client == 0)[0]
        Phi[invalid_idx] = rng.binomial(1, p, size=(len(invalid_idx), num_classes))
        n_classes_per_client = np.sum(Phi, axis=1)
    Psi = [list(np.where(Phi[:, j] == 1)[0]) for j in range(num_classes)]
    num_clients_per_class = np.array([len(x) for x in Psi])

    dict_users: dict[int, set] = {}
    n_labels_per_sample = np.sum(y_train, axis=1)
    for stratum in range(num_classes + 1):
        all_idxs = np.where(n_labels_per_sample == stratum)[0]
        if faithful:
            # reference behavior: always class 0's client set
            client_pool = Psi[0]
            pool_size = num_clients_per_class[0]
        else:
            cls = min(stratum, num_classes - 1)
            client_pool = Psi[cls]
            pool_size = num_clients_per_class[cls]
        p_dirichlet = rng.dirichlet([alpha_dirichlet] * pool_size)
        assignment = rng.choice(client_pool, size=len(all_idxs), p=p_dirichlet.tolist())
        for client_k in client_pool:
            mine = set(all_idxs[assignment == client_k].tolist())
            if client_k in dict_users:
                dict_users[client_k] |= mine
            else:
                dict_users[client_k] = mine
    return {k: list(v) for k, v in dict_users.items()}
