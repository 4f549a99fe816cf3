"""Noisy-client detection for FedNoRo's post-warm-up phase (port of
``fedmlp_tpu/algos/detection.py``).

The JAX package fits ``sklearn.mixture.GaussianMixture(n_components=2,
random_state=seed)`` to the clients' mean losses and calls the component
with the higher mean noisy. The port has no scikit-learn (the machine with
the card has none), so this module writes the same fit out in numpy with
scikit-learn's defaults and arithmetic: ``init_params='kmeans'``, i.e.
``KMeans(n_clusters=2, n_init=1)`` with k-means++ seeds drawn from
``RandomState(seed)`` and Lloyd's iterations, then a one-dimensional
two-component EM (``covariance_type='full'``, ``tol=1e-3``,
``reg_covar=1e-6``, ``max_iter=100``). scikit-learn's Lloyd's step runs
through BLAS, so where a loss lies within a rounding of the midpoint
between the two centres the labels may differ (ROADMAP.md §C).
"""

from __future__ import annotations

import numpy as np

_TOL, _REG_COVAR, _MAX_ITER = 1e-3, 1e-6, 100


def _sq_dists(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Squared distances of centers ``c`` [m] to points ``x`` [n] → [m, n],
    as scikit-learn's ``_euclidean_distances``: −2·c·x + c² + x², clipped
    at 0."""
    d = -2.0 * (c[:, None] * x[None, :])
    d += (c * c)[:, None]
    d += (x * x)[None, :]
    return np.maximum(d, 0.0)


def _kmeans_labels(x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Labels 0/1 of ``KMeans(n_clusters=2, n_init=1)`` over ``x`` [n]:
    k-means++ seeding (two local trials) from ``rng``, then Lloyd's
    iterations (tol 1e-4 of the variance, at most 300), on the centred
    data, with scikit-learn's arithmetic."""
    n = len(x)
    tol = np.var(x) * 1e-4
    x = x - x.mean()
    w = np.ones(n)
    first = rng.choice(n, p=w / w.sum())
    closest = _sq_dists(x[[first]], x)[0]
    pot = closest @ w
    trials = np.searchsorted(np.cumsum(w * closest), rng.uniform(size=2) * pot)
    trials = np.minimum(trials, n - 1)
    cand = np.minimum(closest[None, :], _sq_dists(x[trials], x))
    centers = np.array([x[first], x[trials[np.argmin(cand @ w)]]])

    labels = np.full(n, -1)
    strict = False
    for _ in range(300):
        old = labels
        labels = np.argmin((centers * centers)[None, :] - 2.0 * (x[:, None] * centers[None, :]),
                           axis=1)
        counts = np.bincount(labels, minlength=2)
        if (counts == 0).any():  # only with repeated values: keep the seeds
            new = centers
        else:
            new = np.array([x[labels == k].sum() for k in range(2)]) / counts
        shift = ((new - centers) ** 2).sum()
        centers = new
        if np.array_equal(labels, old):
            strict = True
            break
        if shift <= tol:
            break
    if not strict:
        labels = np.argmin((centers * centers)[None, :] - 2.0 * (x[:, None] * centers[None, :]),
                           axis=1)
    return labels


def _gaussian_parameters(x, resp):
    """scikit-learn's ``_estimate_gaussian_parameters`` for one feature:
    (nk [2], means [2], variances [2])."""
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = resp.T @ x / nk
    var = np.array([np.dot(resp[:, k] * (x - means[k]), x - means[k]) / nk[k]
                    for k in range(2)]) + _REG_COVAR
    return nk, means, var


def _weighted_log_prob(x, weights, means, var):
    """log w_k + log N(x | μ_k, σ²_k) [n, 2], as scikit-learn computes it
    from the precision's Cholesky factor 1/σ."""
    prec_chol = 1.0 / np.sqrt(var)
    y = x[:, None] * prec_chol[None, :] - (means * prec_chol)[None, :]
    log_prob = -0.5 * (np.log(2 * np.pi) + y * y) + np.log(prec_chol)[None, :]
    return log_prob + np.log(weights)[None, :]


def fit_gmm_1d(x: np.ndarray, seed: int):
    """Two-component EM over ``x`` [n] float64, started from the k-means
    labels that ``RandomState(seed)`` draws → (weights, means, variances),
    each [2]."""
    resp = np.zeros((len(x), 2))
    resp[np.arange(len(x)), _kmeans_labels(x, np.random.RandomState(seed))] = 1.0
    nk, means, var = _gaussian_parameters(x, resp)
    weights = nk / len(x)
    lower_bound = -np.inf
    for _ in range(_MAX_ITER):
        prev = lower_bound
        wlp = _weighted_log_prob(x, weights, means, var)
        top = wlp.max(axis=1, keepdims=True)
        log_norm = (top + np.log(np.exp(wlp - top).sum(axis=1, keepdims=True)))[:, 0]
        resp = np.exp(wlp - log_norm[:, None])
        nk, means, var = _gaussian_parameters(x, resp)
        weights = nk / nk.sum()
        lower_bound = log_norm.mean()
        if abs(lower_bound - prev) < _TOL:
            break
    return weights, means, var


def split_clean_noisy_gmm(client_losses, seed: int = 0):
    """2-component GMM over per-client scalar losses → (clean, noisy) id
    lists; the component with the higher mean is noisy. Fewer than two
    clients are all clean; a fit that leaves no client clean falls back to
    a median split."""
    x = np.asarray(client_losses, np.float64).reshape(-1)
    if len(x) < 2:
        return list(range(len(x))), []
    weights, means, var = fit_gmm_1d(x, seed)
    labels = np.argmax(_weighted_log_prob(x, weights, means, var), axis=1)
    noisy_comp = int(np.argmax(means))
    noisy = [i for i, lab in enumerate(labels) if lab == noisy_comp]
    clean = [i for i, lab in enumerate(labels) if lab != noisy_comp]
    if not clean:  # degenerate fit
        order = np.argsort(x)
        half = max(1, len(order) // 2)
        clean, noisy = order[:half].tolist(), order[half:].tolist()
    return clean, noisy
