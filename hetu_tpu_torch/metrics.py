"""Model-quality metrics: the port's copy of the JAX package's
``hetu_tpu/metrics.py`` (reference python/hetu/metrics.py:17-315).

Numpy-side like the reference: accuracy, precision/recall/F1, AUC (ROC and
PR), confusion helpers.
"""

from __future__ import annotations

import numpy as np


def softmax_np(x, axis=-1):
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


def accuracy(y_pred, y_true):
    """y_pred logits/probs (N,C) or labels (N,); y_true one-hot or labels."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    if y_pred.ndim > 1:
        y_pred = np.argmax(y_pred, axis=-1)
    if y_true.ndim > 1:
        y_true = np.argmax(y_true, axis=-1)
    return float(np.mean(y_pred == y_true))


def _binary_counts(y_pred, y_true, threshold=0.5):
    y_pred = np.asarray(y_pred).reshape(-1) >= threshold
    y_true = np.asarray(y_true).reshape(-1) >= 0.5
    tp = np.sum(y_pred & y_true)
    fp = np.sum(y_pred & ~y_true)
    fn = np.sum(~y_pred & y_true)
    tn = np.sum(~y_pred & ~y_true)
    return tp, fp, fn, tn


def precision(y_pred, y_true, threshold=0.5):
    tp, fp, _, _ = _binary_counts(y_pred, y_true, threshold)
    return float(tp / (tp + fp)) if tp + fp else 0.0


def recall(y_pred, y_true, threshold=0.5):
    tp, _, fn, _ = _binary_counts(y_pred, y_true, threshold)
    return float(tp / (tp + fn)) if tp + fn else 0.0


def f1_score(y_pred, y_true, threshold=0.5):
    p = precision(y_pred, y_true, threshold)
    r = recall(y_pred, y_true, threshold)
    return 2 * p * r / (p + r) if p + r else 0.0


def auc_score(y_pred, y_true):
    """ROC AUC by rank statistic (reference metrics.py auc)."""
    y_pred = np.asarray(y_pred).reshape(-1)
    y_true = np.asarray(y_true).reshape(-1) >= 0.5
    n_pos = int(np.sum(y_true))
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(y_pred)
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    sorted_pred = y_pred[order]
    ranks[order] = np.arange(1, len(y_pred) + 1)
    i = 0
    while i < len(sorted_pred):
        j = i
        while j + 1 < len(sorted_pred) and sorted_pred[j + 1] == sorted_pred[i]:
            j += 1
        if j > i:
            avg = (i + j + 2) / 2.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    sum_pos = np.sum(ranks[y_true])
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def pr_auc_score(y_pred, y_true):
    """Area under precision-recall curve (trapezoid)."""
    y_pred = np.asarray(y_pred).reshape(-1)
    y_true = np.asarray(y_true).reshape(-1) >= 0.5
    order = np.argsort(-y_pred)
    y_true = y_true[order]
    tp = np.cumsum(y_true)
    fp = np.cumsum(~y_true)
    n_pos = tp[-1] if len(tp) else 0
    if n_pos == 0:
        return 0.0
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / n_pos
    return float(np.trapezoid(prec, rec))


class Accuracy:
    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, y_pred, y_true):
        y_pred = np.asarray(y_pred)
        y_true = np.asarray(y_true)
        if y_pred.ndim > 1:
            y_pred = np.argmax(y_pred, axis=-1)
        if y_true.ndim > 1:
            y_true = np.argmax(y_true, axis=-1)
        self.correct += int(np.sum(y_pred == y_true))
        self.total += len(y_pred)

    def result(self):
        return self.correct / self.total if self.total else 0.0
