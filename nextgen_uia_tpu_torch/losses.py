"""Losses (counterpart of nextgen_uia_tpu/losses.py's ``info_nce``,
``focal_loss`` and ``dice_ce_loss``), a float32 scalar out.

  - InfoNCE: the symmetric cross-entropy over the cosine-similarity matrix
    of paired image and text features, divided by the temperature, with
    the pairs on the diagonal.
  - FocalLoss(to_onehot_y=True): each class channel an independent binary
    problem, BCE-with-logits weighted by (1 - p_t)^gamma, mean over all
    elements.
  - DiceCELoss(to_onehot_y=True, softmax=True, squared_pred=True,
    smooth_nr=smooth_dr=1e-8): mean per-(sample, class) soft Dice loss plus
    the cross-entropy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def info_nce(image_features, text_features, temperature: float = 0.07):
    """Symmetric InfoNCE over a batch of paired embeddings [B, D]."""
    img = image_features.to(torch.float32)
    txt = text_features.to(torch.float32)
    img = img / torch.clamp(torch.linalg.vector_norm(img, dim=1, keepdim=True), min=1e-12)
    txt = txt / torch.clamp(torch.linalg.vector_norm(txt, dim=1, keepdim=True), min=1e-12)
    logits = img @ txt.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def _to_onehot_channels(labels, num_classes: int, target_ndim: int):
    """labels [B] -> [B, C]; labels [B, 1, H, W] -> [B, C, H, W] (float32)."""
    labels = labels.long()
    if labels.ndim == 1:
        return F.one_hot(labels, num_classes).to(torch.float32)
    if labels.ndim == target_ndim and labels.shape[1] == 1:
        return F.one_hot(labels[:, 0], num_classes).to(torch.float32).movedim(-1, 1)
    raise ValueError(f"Unsupported label shape {tuple(labels.shape)} for logits ndim "
                     f"{target_ndim}")


def focal_loss(logits, labels):
    """MONAI FocalLoss(to_onehot_y=True), gamma 2. logits [B, C] or
    [B, C, H, W]; labels [B] or [B, 1, H, W] int."""
    logits = logits.to(torch.float32)
    onehot = _to_onehot_channels(labels, logits.shape[1], logits.ndim)
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    return (ce * (1.0 - p_t) ** 2).mean()


def dice_ce_loss(logits, labels):
    """MONAI DiceCELoss(to_onehot_y=True, softmax=True, squared_pred=True,
    smooth 1e-8, background included). logits [B, C, H, W]; labels
    [B, 1, H, W] int. Returns dice + ce."""
    logits = logits.to(torch.float32)
    onehot = _to_onehot_channels(labels, logits.shape[1], logits.ndim)
    probs = torch.softmax(logits, dim=1)
    axes = tuple(range(2, logits.ndim))
    intersection = (onehot * probs).sum(axes)
    ground, pred = (onehot ** 2).sum(axes), (probs ** 2).sum(axes)
    dice = (1.0 - (2.0 * intersection + 1e-8) / (ground + pred + 1e-8)).mean()
    ce = -(onehot * torch.log_softmax(logits, dim=1)).sum(1).mean()
    return dice + ce
