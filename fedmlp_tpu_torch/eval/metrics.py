"""Multi-label evaluation metrics.

Numpy implementations with exact sklearn tie-handling semantics for AP and
ROC-AUC (the reference calls sklearn directly: utils/evaluations.py:41-49,
59-65), plus the reference's own class-wise macro metrics
(utils/multilabel_metrixs.py):

  * Recall  — class-wise mean of TP/P            (:21-29)
  * BACC    — mean of (recall1 + recall0)/2       (:32-46); note recall0 is
              TN/N with TN counted as ~(y|ŷ) exactly as the reference does
  * Precision — skips classes with zero predicted positives but still
              divides by C                         (:49-60)
  * F1      — 2TP/(P + P̂) class-wise mean         (:63-71)
  * Hamming — fraction of wrong labels            (:5-9)

All take y_true [N, C] (0/1) and either probabilities or hard predictions.
"""

from __future__ import annotations

import numpy as np

# numpy >= 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TP/FP at descending score thresholds, ties grouped —
    mirrors sklearn's _binary_clf_curve."""
    desc = np.argsort(-y_score, kind="mergesort")
    y_score = y_score[desc]
    y_true = y_true[desc]
    # indices where score changes (last index of each tie group)
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn average_precision_score for one class:
    AP = Σ_n (R_n - R_{n-1}) · P_n over descending thresholds."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    n_pos = y_true.sum()
    if n_pos == 0:
        return float("nan")
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    precision_c = tps / np.maximum(tps + fps, 1e-300)
    recall_c = tps / n_pos
    # prepend (recall=0, precision=1) as sklearn does (reversed arrays)
    recall_prev = np.r_[0.0, recall_c[:-1]]
    return float(np.sum((recall_c - recall_prev) * precision_c))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn roc_curve + auc (trapezoid) for one class."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    n_pos = y_true.sum()
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    tpr = np.r_[0.0, tps] / n_pos
    fpr = np.r_[0.0, fps] / n_neg
    return float(_trapezoid(tpr, fpr))


def mean_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Per-class AP mean (reference: utils/evaluations.py:41-49)."""
    aps = [average_precision(y_true[:, c], y_score[:, c]) for c in range(y_true.shape[1])]
    return float(np.nanmean(aps))


def macro_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Per-class ROC-AUC mean (reference: utils/evaluations.py:59-65)."""
    aucs = [roc_auc(y_true[:, c], y_score[:, c]) for c in range(y_true.shape[1])]
    return float(np.nanmean(aucs))


# ----------------------------------------------------------------------
# Hard-prediction metrics — reference multilabel_metrixs.py semantics.
# ----------------------------------------------------------------------

def hamming_loss(y_true: np.ndarray, y_pred: np.ndarray, classid=None) -> float:
    y_true = np.asarray(y_true, dtype=bool)
    y_pred = np.asarray(y_pred, dtype=bool)
    return float(np.mean(y_true != y_pred))


def recall(y_true: np.ndarray, y_pred: np.ndarray, classid: int | None = None) -> float:
    y_true = np.asarray(y_true, dtype=bool)
    y_pred = np.asarray(y_pred, dtype=bool)
    if classid is not None:
        col_t, col_p = y_true[:, classid], y_pred[:, classid]
        return float(np.logical_and(col_t, col_p).sum() / col_t.sum())
    C = y_true.shape[1]
    total = 0.0
    for c in range(C):
        total += np.logical_and(y_true[:, c], y_pred[:, c]).sum() / y_true[:, c].sum()
    return float(total / C)


def bacc(y_true: np.ndarray, y_pred: np.ndarray, classid: int | None = None,
         per_class: bool = False):
    """(recall1 + recall0)/2 class-wise; recall0 counts samples where
    neither label nor prediction is 1 (reference: utils/multilabel_metrixs.py:
    36,42 uses ~(y|ŷ), i.e. TN as seen by that code)."""
    y_true = np.asarray(y_true, dtype=bool)
    y_pred = np.asarray(y_pred, dtype=bool)

    def one(c):
        t, p = y_true[:, c], y_pred[:, c]
        recall1 = np.logical_and(t, p).sum() / t.sum()
        recall0 = (~np.logical_or(t, p)).sum() / (t.size - np.count_nonzero(t))
        return (recall0 + recall1) / 2.0

    if classid is not None:
        return float(one(classid))
    vals = [one(c) for c in range(y_true.shape[1])]
    if per_class:
        return vals
    return float(np.mean(vals))


def precision(y_true: np.ndarray, y_pred: np.ndarray, classid: int | None = None) -> float:
    """Skips zero-prediction classes in the numerator but divides by C
    (reference: utils/multilabel_metrixs.py:49-60)."""
    y_true = np.asarray(y_true, dtype=bool)
    y_pred = np.asarray(y_pred, dtype=bool)
    if classid is not None:
        col_t, col_p = y_true[:, classid], y_pred[:, classid]
        return float(np.logical_and(col_t, col_p).sum() / col_p.sum())
    C = y_true.shape[1]
    total = 0.0
    for c in range(C):
        pred_pos = y_pred[:, c].sum()
        if pred_pos == 0:
            continue
        total += np.logical_and(y_true[:, c], y_pred[:, c]).sum() / pred_pos
    return float(total / C)


def f1_measure(y_true: np.ndarray, y_pred: np.ndarray, classid: int | None = None) -> float:
    y_true = np.asarray(y_true, dtype=bool)
    y_pred = np.asarray(y_pred, dtype=bool)

    def one(c):
        t, p = y_true[:, c], y_pred[:, c]
        return 2.0 * np.logical_and(t, p).sum() / (t.sum() + p.sum())

    if classid is not None:
        return float(one(classid))
    return float(np.mean([one(c) for c in range(y_true.shape[1])]))


def multilabel_report(y_true: np.ndarray, probs: np.ndarray, threshold: float = 0.5) -> dict:
    """The 7-metric suite of globaltest (reference: utils/evaluations.py:67-73)."""
    preds = probs > threshold
    return {
        "mAP": mean_average_precision(y_true, probs),
        "BACC": bacc(y_true, preds),
        "R": recall(y_true, preds),
        "F1": f1_measure(y_true, preds),
        "auc": macro_auc(y_true, probs),
        "P": precision(y_true, preds),
        "hamming_loss": hamming_loss(y_true, preds),
    }
