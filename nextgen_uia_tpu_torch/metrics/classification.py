"""Binary classification metrics (torchmetrics-equivalent semantics; the
port's own copy of nextgen_uia_tpu/metrics/classification.py).

Replaces the reference's torchmetrics usage
(the reference's src/utils/tools.py:26-34, 208-226): Accuracy/Precision/
Recall/F1 at threshold 0.5 on softmax[:, 1] probabilities, AUROC via
trapezoidal integration of the ROC computed at all score thresholds.
Pure numpy — metric computation is not a hot path.
"""

from __future__ import annotations

import numpy as np


def softmax_probs(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return (e / e.sum(axis=1, keepdims=True))[:, 1]


def binary_stats(probs: np.ndarray, labels: np.ndarray, threshold: float = 0.5):
    preds = (probs >= threshold).astype(np.int64)
    labels = labels.astype(np.int64)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    tn = int(((preds == 0) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    acc = (tp + tn) / max(tp + tn + fp + fn, 1)
    pre = tp / max(tp + fp, 1) if (tp + fp) > 0 else 0.0
    rec = tp / max(tp + fn, 1) if (tp + fn) > 0 else 0.0
    f1 = 2 * pre * rec / (pre + rec) if (pre + rec) > 0 else 0.0
    return {"acc": acc, "pre": pre, "rec": rec, "f1": f1}


def roc_curve(probs: np.ndarray, labels: np.ndarray):
    """Returns (fpr, tpr, thresholds), torchmetrics-style (descending thresholds
    with a leading (0,0) point at threshold > max)."""
    order = np.argsort(-probs, kind="stable")
    probs_s = probs[order]
    labels_s = labels[order].astype(np.float64)
    tps = np.cumsum(labels_s)
    fps = np.cumsum(1.0 - labels_s)
    # keep last index of each distinct threshold
    distinct = np.r_[np.nonzero(np.diff(probs_s))[0], probs_s.size - 1]
    tps, fps, thr = tps[distinct], fps[distinct], probs_s[distinct]
    p = max(labels.sum(), 1e-12)
    n = max((1 - labels).sum(), 1e-12)
    tpr = np.r_[0.0, tps / p]
    fpr = np.r_[0.0, fps / n]
    thresholds = np.r_[1.0 if thr.size == 0 else thr[0] + 1.0, thr]
    return fpr, tpr, thresholds


def auroc(probs: np.ndarray, labels: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(probs, labels)
    return float(np.trapezoid(tpr, fpr))


def classification_report(logits: np.ndarray, labels: np.ndarray):
    probs = softmax_probs(np.asarray(logits, dtype=np.float64))
    labels = np.asarray(labels)
    out = binary_stats(probs, labels)
    out["auc"] = auroc(probs, labels)
    return out
