"""Evaluation metrics (reference utils/eval_metrics.py:16-28 and appendix
(Appendix)CCAC2023/utils/eval_metrics.py:11-39).

Pure-numpy F1 implementations with sklearn-identical semantics (labels = sorted
union of y_true/y_pred; weighted average by true support; zero-division -> 0),
so the framework carries no sklearn dependency; tests cross-check against
sklearn when it is available.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# MELD label order (reference utils/eval_metrics.py:27)
MELD_EMOTIONS = ("Neutral", "Surprise", "Fear", "Sadness", "Joy", "Disgust",
                 "Anger")


def _f1_components(y_true: np.ndarray, y_pred: np.ndarray,
                   labels: Sequence[int]):
    tp = np.zeros(len(labels))
    fp = np.zeros(len(labels))
    fn = np.zeros(len(labels))
    support = np.zeros(len(labels))
    for i, c in enumerate(labels):
        tp[i] = np.sum((y_pred == c) & (y_true == c))
        fp[i] = np.sum((y_pred == c) & (y_true != c))
        fn[i] = np.sum((y_pred != c) & (y_true == c))
        support[i] = np.sum(y_true == c)
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    return f1, support


def per_class_f1(y_true, y_pred, labels: Optional[Sequence[int]] = None):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = sorted(set(np.unique(y_true)) | set(np.unique(y_pred)))
    f1, _ = _f1_components(y_true, y_pred, labels)
    return f1


def weighted_f1(y_true, y_pred) -> float:
    """sklearn f1_score(average='weighted') semantics."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = sorted(set(np.unique(y_true)) | set(np.unique(y_pred)))
    f1, support = _f1_components(y_true, y_pred, labels)
    total = support.sum()
    if total == 0:
        return 0.0
    return float(np.sum(f1 * support) / total)


def macro_f1(y_true, y_pred) -> float:
    """Appendix metric ((Appendix)CCAC2023/utils/eval_metrics.py:19)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = sorted(set(np.unique(y_true)) | set(np.unique(y_pred)))
    f1, _ = _f1_components(y_true, y_pred, labels)
    return float(f1.mean())


def eval_meld(results: np.ndarray, truths: np.ndarray, test: bool = False,
              verbose: bool = True) -> float:
    """argmax over logits -> weighted F1; per-class F1 printed at test time
    (reference utils/eval_metrics.py:16-28)."""
    preds = np.asarray(results).argmax(-1)
    truths = np.asarray(truths)
    wf1 = weighted_f1(truths, preds)
    if test and verbose:
        f1s = per_class_f1(truths, preds)
        print("**TEST** | f1 on each class "
              f"({', '.join(MELD_EMOTIONS)}): \n", f1s)
    return wf1
