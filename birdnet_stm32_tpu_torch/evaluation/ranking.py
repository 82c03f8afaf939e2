"""Ranking metrics in numpy: ROC-AUC, average precision, the PR curve and
the confusion matrix, computed as scikit-learn computes them.

The JAX package reads these from scikit-learn; the port's card machine has
none, so they are written out here, in float64, and held equal to
scikit-learn in tier-1. Tied scores are one threshold, as in
scikit-learn: scores are sorted once, and the cumulative counts are read
at the last index of each distinct score. Edge cases follow
scikit-learn 1.9:
- ROC-AUC of a column with one class present is nan (older releases
  raised; the JAX evaluation turns that into nan too);
- average precision of a column with no positive is 0.0 (recall is one
  at every threshold);
- `average="micro"` flattens a [N, C] label matrix into one binary
  problem.
Labels are positive where they equal 1.
"""

from __future__ import annotations

import numpy as np


def _binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, highest first."""
    y_true = np.ravel(y_true) == 1
    y_score = np.ravel(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def auc(x, y) -> float:
    """Area under a curve by the trapezoid rule; x monotonic either way."""
    x, y = np.ravel(x), np.ravel(y)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, "
                         f"but x.shape = {x.shape[0]}")
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds), collinear points dropped; the first
    threshold is +inf. A curve with no negative (positive) has fpr (tpr)
    all nan."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def _binary_roc_auc(y_true, y_score) -> float:
    if np.unique(np.ravel(y_true)).size != 2:
        return float("nan")  # one class present: ROC-AUC is undefined
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds): recall decreasing, ending at
    precision 1 and recall 0; thresholds in the scores' dtype, increasing."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1])


def _binary_average_precision(y_true, y_score) -> float:
    """The step-function integral of the PR curve (no interpolation)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _binary_or_micro(metric, y_true, y_score, average):
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if y_true.ndim == 1:
        return metric(y_true, y_score)
    if average != "micro":
        raise ValueError(f"average={average!r}: a [N, C] label matrix takes 'micro'")
    return metric(y_true.ravel(), y_score.ravel())


def roc_auc_score(y_true, y_score, average: str | None = None) -> float:
    """ROC-AUC of a binary column, or of a [N, C] label matrix with
    average='micro' (one flattened problem)."""
    return _binary_or_micro(_binary_roc_auc, y_true, y_score, average)


def average_precision_score(y_true, y_score, average: str | None = None) -> float:
    """Average precision of a binary column, or of a [N, C] label matrix
    with average='micro'."""
    return _binary_or_micro(_binary_average_precision, y_true, y_score, average)


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """[L, L] int64 counts, rows the true label, columns the prediction, in
    the order of `labels`; pairs with a value outside `labels` are dropped."""
    labels = list(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    t = np.array([index.get(v, -1) for v in np.ravel(y_true).tolist()], np.int64)
    p = np.array([index.get(v, -1) for v in np.ravel(y_pred).tolist()], np.int64)
    keep = (t >= 0) & (p >= 0)
    n = len(labels)
    return np.bincount(t[keep] * n + p[keep], minlength=n * n).reshape(n, n).astype(np.int64)
