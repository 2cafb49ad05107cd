"""Segmentation metrics with MONAI-equivalent semantics (the port's own
copy of nextgen_uia_tpu/metrics/segmentation.py: numpy and scipy).

Replaces the reference's MONAI usage (its src/utils/tools.py:
185-206): per-sample Dice/IoU with background excluded (NaN when a class is
absent from both pred and gt — downstream means are finite-filtered, matching
tools.py:146-163), and surface metrics HD95/ASD computed from mask boundaries
via exact Euclidean distance transforms (scipy.ndimage) — the same
EDT-on-host strategy MONAI uses, so no gc-leak workaround is needed
(tools.py:196-198).

Conventions: preds are one-hot [B, C, H, W] (argmax'd logits), labels are
binary [B, 1, H, W]; metrics are per-sample arrays over the foreground class.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def one_hot_argmax(logits: np.ndarray) -> np.ndarray:
    """[B, C, H, W] logits -> one-hot [B, C, H, W] float."""
    num_classes = logits.shape[1]
    am = np.argmax(logits, axis=1)
    return np.moveaxis(np.eye(num_classes, dtype=np.float32)[am], -1, 1)


def _foreground(preds, labels):
    """Extract foreground masks: preds one-hot [B,C,H,W], labels [B,1,H,W]."""
    p = preds[:, 1].astype(bool) if preds.shape[1] > 1 else preds[:, 0].astype(bool)
    g = labels[:, 0].astype(bool)
    return p, g


def dice(preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-sample foreground Dice; NaN when both masks empty (MONAI compute_dice)."""
    p, g = _foreground(preds, labels)
    inter = (p & g).sum(axis=(1, 2)).astype(np.float64)
    denom = p.sum(axis=(1, 2)) + g.sum(axis=(1, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(denom > 0, 2.0 * inter / denom, np.nan)


def iou(preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
    p, g = _foreground(preds, labels)
    inter = (p & g).sum(axis=(1, 2)).astype(np.float64)
    union = (p | g).sum(axis=(1, 2)).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, np.nan)


def _mask_edges(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels: mask XOR eroded(mask) (MONAI get_mask_edges).

    MONAI calls ``scipy.ndimage.binary_erosion(seg)`` with the DEFAULT
    structuring element — the connectivity-1 cross, not the full 3x3 box —
    and border_value=0, so image-border-touching pixels are edges. A pixel is
    a boundary pixel iff any of its 4-neighbours (or the image border) is
    background; diagonal-only contact does not count. Pinned by the
    brute-force oracle in tests/test_monai_surface_oracle.py."""
    if not mask.any():
        return np.zeros_like(mask)
    eroded = ndimage.binary_erosion(mask)  # default cross structure, border 0
    return mask ^ eroded

def _surface_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Distances from each boundary pixel of src to the nearest boundary pixel
    of dst (directed), via exact EDT of the complement of dst's boundary."""
    src_edges = _mask_edges(src)
    dst_edges = _mask_edges(dst)
    if not src_edges.any() or not dst_edges.any():
        return np.array([np.inf])
    dt = ndimage.distance_transform_edt(~dst_edges)
    return dt[src_edges]


def hd95(preds: np.ndarray, labels: np.ndarray, percentile: float = 95.0) -> np.ndarray:
    """Per-sample symmetric Hausdorff-95 on the foreground class
    (MONAI compute_hausdorff_distance(percentile=95): max of the two directed
    percentiles; inf when either mask is empty)."""
    p, g = _foreground(preds, labels)
    out = np.empty(p.shape[0])
    for i in range(p.shape[0]):
        if not p[i].any() or not g[i].any():
            out[i] = np.inf if (p[i].any() != g[i].any()) else np.nan
            continue
        d_pg = _surface_distances(p[i], g[i])
        d_gp = _surface_distances(g[i], p[i])
        out[i] = max(np.percentile(d_pg, percentile), np.percentile(d_gp, percentile))
    return out


def asd(preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-sample average surface distance, directed pred->gt
    (MONAI compute_average_surface_distance default symmetric=False)."""
    p, g = _foreground(preds, labels)
    out = np.empty(p.shape[0])
    for i in range(p.shape[0]):
        if not p[i].any() or not g[i].any():
            out[i] = np.inf if (p[i].any() != g[i].any()) else np.nan
            continue
        out[i] = float(np.mean(_surface_distances(p[i], g[i])))
    return out


class SegAccumulator:
    """MetricAccumulator(type='seg') equivalent: batch-wise accumulation,
    finite-filtered mean/std (tools.py:121-176)."""

    def __init__(self, criterion=None):
        self.criterion = criterion
        self.reset()

    def reset(self):
        self.dice_list, self.iou_list = [], []
        self.hd95_list, self.asd_list, self.loss_list = [], [], []

    def update(self, logits: np.ndarray, labels: np.ndarray):
        logits = np.asarray(logits, dtype=np.float32)
        labels = np.asarray(labels)
        if self.criterion is not None:
            self.loss_list.append(float(self.criterion(logits, labels)))
        preds = one_hot_argmax(logits)
        self.dice_list.extend(dice(preds, labels).tolist())
        self.iou_list.extend(iou(preds, labels).tolist())
        self.hd95_list.extend(hd95(preds, labels).tolist())
        self.asd_list.extend(asd(preds, labels).tolist())

    @staticmethod
    def _finite_stats(values):
        a = np.asarray(values, dtype=np.float64)
        a = a[np.isfinite(a)]
        if a.size == 0:
            return float("nan"), float("nan")
        return float(a.mean()), float(a.std())

    def compute(self):
        d_m, d_s = self._finite_stats(self.dice_list)
        i_m, i_s = self._finite_stats(self.iou_list)
        h_m, h_s = self._finite_stats(self.hd95_list)
        a_m, a_s = self._finite_stats(self.asd_list)
        out = {"dice_mean": d_m, "dice_std": d_s, "iou_mean": i_m, "iou_std": i_s,
               "hd95_mean": h_m, "hd95_std": h_s, "asd_mean": a_m, "asd_std": a_s}
        if self.loss_list:
            out["loss"] = float(np.mean([x for x in self.loss_list if np.isfinite(x)]))
        return out


class ClsAccumulator:
    """MetricAccumulator(type='cls') equivalent (tools.py:208-226)."""

    def __init__(self, criterion=None):
        self.criterion = criterion
        self.reset()

    def reset(self):
        self.logits, self.labels = [], []

    def update(self, logits, labels):
        self.logits.append(np.asarray(logits, dtype=np.float32))
        self.labels.append(np.asarray(labels))

    def all(self):
        return np.concatenate(self.logits, axis=0), np.concatenate(self.labels, axis=0)

    def compute(self):
        from .classification import classification_report

        logits, labels = self.all()
        out = classification_report(logits, labels)
        if self.criterion is not None:
            out["loss"] = float(self.criterion(logits, labels))
        return out
