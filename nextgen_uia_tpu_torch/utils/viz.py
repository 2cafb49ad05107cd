"""Visualization: segmentation overlays and ROC curves (the port's own copy
of nextgen_uia_tpu/utils/viz.py; matplotlib is imported only for the ROC).

Reproduces the reference's src/utils/tools.py:278-354: per-image GT(red)/
pred(green) overlay PNGs (with and without the input underlay), raw predicted
mask PNGs, and the ROC figure with AUC in the title.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image


def visualize_seg(images, labels, preds, file_names, viz_path):
    """images [B,1,H,W] or [B,C,H,W] float 0..1; labels [B,1,H,W] {0,1};
    preds one-hot [B,C,H,W] or class map [B,H,W]."""
    os.makedirs(viz_path, exist_ok=True)
    images = np.asarray(images)
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    if preds.ndim == 4 and preds.shape[1] > 1:
        preds = np.argmax(preds, axis=1)
    elif preds.ndim == 4:
        preds = preds[:, 0]

    for i, file_name in enumerate(file_names):
        img = (images[i, 0] * 255).astype(np.uint8)
        lab = (labels[i, 0] * 255).astype(np.uint8)
        prd = (preds[i] * 255).astype(np.uint8)
        stem = str(Path(file_name).stem)

        rgb = np.zeros((*img.shape, 3), np.uint8)
        rgb[:, :, 0] = lab
        rgb[:, :, 1] = prd
        Image.fromarray(rgb).save(os.path.join(viz_path, f"{stem}.png"))

        rgb2 = np.zeros_like(rgb)
        rgb2[:, :, 0] = np.maximum(img, lab)
        rgb2[:, :, 1] = np.maximum(img, prd)
        rgb2[:, :, 2] = img
        Image.fromarray(rgb2).save(os.path.join(viz_path, f"{stem}_overlay.png"))

        Image.fromarray(prd).save(os.path.join(viz_path, f"{stem}_pred.png"))


def roc_figure(logits, labels, title: str = ""):
    """ROC matplotlib figure from 2-class logits; returns (fig, auc). The
    caller owns the figure (save it, hand it to TBWriter.figure, close it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..metrics.classification import auroc, roc_curve, softmax_probs

    probs = softmax_probs(np.asarray(logits, np.float64))
    labels = np.asarray(labels)
    fpr, tpr, _ = roc_curve(probs, labels)
    auc = auroc(probs, labels)

    fig = plt.figure(figsize=(4, 4), dpi=300)
    ax = fig.add_subplot(111)
    ax.plot(fpr, tpr, linewidth=2)
    ax.plot([0, 1], [0, 1], "k--", linewidth=1)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.grid(True, alpha=0.3)
    ax.set_title(title or f"AUC = {auc:.4f}")
    return fig, auc


def plot_roc(logits, labels, save_path: str, title: str = ""):
    """ROC figure from 2-class logits saved as PNG; returns AUC."""
    import matplotlib.pyplot as plt

    fig, auc = roc_figure(logits, labels, title)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return auc
