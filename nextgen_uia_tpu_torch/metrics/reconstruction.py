"""Reconstruction metrics: SSIM and PSNR with MONAI's semantics; the port's
own copy of nextgen_uia_tpu/metrics/reconstruction.py (numpy and scipy).

The reference's MetricAccumulator(type='recon') (its src/utils/tools.py:
228-247): predictions and targets clamped to [0, 1], per-sample SSIM with
MONAI SSIMMetric's Gaussian window (sigma 1.5, kernel 11, K1 0.01, K2 0.03,
max_val 1; an 11x11 uniform window would differ) and PSNR (max_val 1).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def psnr(pred: np.ndarray, target: np.ndarray, max_val: float = 1.0) -> np.ndarray:
    """Per-sample PSNR over [B, C, H, W]."""
    p = np.clip(pred, 0.0, 1.0).astype(np.float64)
    t = np.clip(target, 0.0, 1.0).astype(np.float64)
    mse = np.mean((p - t) ** 2, axis=tuple(range(1, p.ndim)))
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(max_val) - 10.0 * np.log10(mse)


def ssim(pred: np.ndarray, target: np.ndarray, *, max_val: float = 1.0,
         sigma: float = 1.5, truncate_kernel: int = 11,
         k1: float = 0.01, k2: float = 0.03) -> np.ndarray:
    """Per-sample mean SSIM over [B, C, H, W] with a gaussian window."""
    p = np.clip(pred, 0.0, 1.0).astype(np.float64)
    t = np.clip(target, 0.0, 1.0).astype(np.float64)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    radius = (truncate_kernel - 1) // 2
    trunc = radius / sigma

    def blur(x):
        return ndimage.gaussian_filter(x, sigma=sigma, truncate=trunc, mode="nearest")

    out = np.empty(p.shape[0])
    for i in range(p.shape[0]):
        vals = []
        for c in range(p.shape[1]):
            x, y = p[i, c], t[i, c]
            mx, my = blur(x), blur(y)
            mxx, myy, mxy = blur(x * x), blur(y * y), blur(x * y)
            vx = mxx - mx * mx
            vy = myy - my * my
            cov = mxy - mx * my
            s = ((2 * mx * my + c1) * (2 * cov + c2)) / \
                ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
            vals.append(np.mean(s))
        out[i] = np.mean(vals)
    return out


class ReconAccumulator:
    """MetricAccumulator(type='recon') equivalent."""

    def __init__(self, criterion=None):
        self.criterion = criterion
        self.reset()

    def reset(self):
        self.ssim_list, self.psnr_list, self.loss_list = [], [], []

    def update(self, preds: np.ndarray, targets: np.ndarray):
        preds = np.asarray(preds, np.float64)
        targets = np.asarray(targets, np.float64)
        if self.criterion is not None:
            self.loss_list.append(float(self.criterion(preds, targets)))
        self.ssim_list.extend(ssim(preds, targets).tolist())
        self.psnr_list.extend(psnr(preds, targets).tolist())

    def compute(self):
        s = np.asarray(self.ssim_list)
        p = np.asarray(self.psnr_list)
        p = p[np.isfinite(p)]
        out = {"ssim_mean": float(s.mean()), "ssim_std": float(s.std()),
               "psnr_mean": float(p.mean()) if p.size else float("nan"),
               "psnr_std": float(p.std()) if p.size else float("nan")}
        if self.loss_list:
            out["loss"] = float(np.mean(self.loss_list))
        return out
