"""Feature-pyramid adapter head (counterpart of nextgen_uia_tpu/models/heads.py's
PyramidHead): tap ViT activations, reduce each D -> reduce_dim, process with
LN-MLP blocks deep to shallow, sum into a grid x grid map, then a seg head
(1x1 conv, then bilinear upsample) or a cls head: GAP -> dropout 0.5 ->
linear (the timm adapter), or with ``cls_hidden`` GAP -> fc1 -> ReLU ->
dropout 0.1 -> fc2 (the OpenAI adapter); the dropout in train mode only.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.layers import (Conv, LayerNorm, Linear, dropout, gelu, layernorm, linear,
                         resize_bilinear)


@dataclasses.dataclass(frozen=True)
class PyramidHeadConfig:
    feature_dim: int = 768
    reduce_dim: int = 512
    num_layers: int = 3            # len(extract_layers)
    num_classes: int = 2
    img_size: int = 224
    task: str = "seg"              # 'seg' | 'cls'
    # the cls head's hidden layer (the OpenAI family's adapter): cls_head/fc1,
    # ReLU, dropout 0.1, cls_head/fc2
    cls_hidden: bool = False


class PyramidHead(nn.Module):
    """``pyramid_head_init``: reduces, LN-MLP blocks, and seg_head (1x1 conv,
    HWIO) or cls_head (linear, or fc1 and fc2 with ``cls_hidden``)."""

    def __init__(self, gen, cfg: PyramidHeadConfig):
        super().__init__()
        self.reduces = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for _ in range(cfg.num_layers):
            self.reduces.append(Linear(gen, cfg.feature_dim, cfg.reduce_dim))
            blk = nn.Module()
            blk.ln = LayerNorm(cfg.reduce_dim)
            blk.fc1 = Linear(gen, cfg.reduce_dim, cfg.reduce_dim)
            blk.fc2 = Linear(gen, cfg.reduce_dim, cfg.reduce_dim)
            self.blocks.append(blk)
        if cfg.task == "seg":
            self.seg_head = Conv(gen, 1, 1, cfg.reduce_dim, cfg.num_classes)
        elif cfg.cls_hidden:
            self.cls_head = nn.Module()
            self.cls_head.fc1 = Linear(gen, cfg.reduce_dim, cfg.reduce_dim)
            self.cls_head.fc2 = Linear(gen, cfg.reduce_dim, cfg.num_classes)
        else:
            self.cls_head = Linear(gen, cfg.reduce_dim, cfg.num_classes)


def pyramid_head_init(gen: torch.Generator, cfg: PyramidHeadConfig) -> PyramidHead:
    return PyramidHead(gen, cfg)


def pyramid_head_apply(p: PyramidHead, cfg: PyramidHeadConfig, activations, *, dtype=None,
                       gen=None):
    """activations: list of [B, N, D] token states (shallow-to-deep order).

    Returns [B, num_classes, H, W] for seg (NCHW) or [B, num_classes] for cls.
    Without ``dtype`` the products run in the promoted type, so bf16 tower
    activations meet the float32 head weights in float32. Train mode (a
    dropout generator ``gen``) drops the cls head's pooled features at rate
    0.5, or with ``cls_hidden`` its hidden features at rate 0.1; the seg head
    has no dropout.
    """
    fused = None
    # deep to shallow; zip pairs the taps with the reduces from the end
    for act, reduce_p, block_p in zip(activations[::-1], p.reduces[::-1], p.blocks[::-1]):
        a = linear(reduce_p, act[:, 1:, :], dtype=dtype)  # drop CLS
        h = layernorm(block_p.ln, a)
        h = linear(block_p.fc2, gelu(linear(block_p.fc1, h, dtype=dtype)), dtype=dtype)
        fused = h if fused is None else h + fused

    b, n, c = fused.shape
    size = int(round(n ** 0.5))
    fmap = fused.reshape(b, size, size, c)  # NHWC
    if cfg.task == "seg":
        # 1x1 conv before the upsample: both are linear and bilinear rows sum
        # to 1, so the order is exact and the upsampled tensor has
        # num_classes channels instead of reduce_dim
        seg = p.seg_head
        logits = fmap @ seg.w[0, 0].to(fmap.dtype) + seg.b.to(fmap.dtype)
        logits = resize_bilinear(logits, (cfg.img_size, cfg.img_size))
        return logits.permute(0, 3, 1, 2)
    pooled = fmap.mean(dim=(1, 2))
    if cfg.cls_hidden:
        h = torch.relu(linear(p.cls_head.fc1, pooled, dtype=dtype))
        return linear(p.cls_head.fc2, dropout(h, 0.1, gen=gen), dtype=dtype)
    return linear(p.cls_head, dropout(pooled, 0.5, gen=gen), dtype=dtype)
