"""Task heads (counterpart of nextgen_uia_tpu/models/heads.py).

PyramidHead: tap ViT activations, reduce each D -> reduce_dim, process with
LN-MLP blocks deep to shallow, sum into a grid x grid map, then a seg head
(1x1 conv, then bilinear upsample) or a cls head: GAP -> dropout 0.5 ->
linear (the timm adapter), or with ``cls_hidden`` GAP -> fc1 -> ReLU ->
dropout 0.1 -> fc2 (the OpenAI adapter); the dropout in train mode only.

ClipSegDecoder: the HF CIDAS/clipseg-rd64-refined FiLM decoder. The taps
reduced D -> reduce_dim and summed deep to shallow, FiLM conditioning
from the text embedding after the first reduce, a post-norm ReLU
transformer layer after each reduce (4 heads), the CLS token dropped, then
a 3x3 conv and two transposed convs of stride patch_size // 4 to full
resolution: single-channel logits. Its parameters carry the JAX package's
names, so the converter's ``clipseg_decoder`` output loads unchanged.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.attention import Attention, mha
from ..nn.layers import (Conv, LayerNorm, Linear, conv2d, conv_transpose2d, dropout, gelu,
                         layernorm, linear, resize_bilinear)
from ..ops import KERNELS


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


@dataclasses.dataclass(frozen=True)
class ClipSegDecoderConfig:
    hidden_size: int = 768         # vision tower width
    reduce_dim: int = 64
    cond_dim: int = 512            # text embedding width
    heads: int = 4
    intermediate: int = 2048
    extract_layers: tuple = (3, 6, 9)
    conditional_layer: int = 0
    patch_size: int = 16
    ln_eps: float = 1e-5


class ClipSegDecoder(nn.Module):
    """``clipseg_decoder_init``'s tree: film_mul, film_add, reduces/<i>,
    layers/<i>/{attn, ln1, mlp/fc1, mlp/fc2, ln2}, trans_conv1 (3x3),
    trans_up1 and trans_up2 (transposed, [k, k, in, out])."""

    def __init__(self, gen, cfg: ClipSegDecoderConfig):
        super().__init__()
        rd, depth, k = cfg.reduce_dim, len(cfg.extract_layers), cfg.patch_size // 4
        self.film_mul = Linear(gen, cfg.cond_dim, rd)
        self.film_add = Linear(gen, cfg.cond_dim, rd)
        self.reduces = nn.ModuleList(Linear(gen, cfg.hidden_size, rd) for _ in range(depth))
        self.layers = nn.ModuleList()
        for _ in range(depth):
            layer = nn.Module()
            layer.attn = Attention(gen, rd)
            layer.ln1 = LayerNorm(rd)
            layer.mlp = nn.Module()
            layer.mlp.fc1 = Linear(gen, rd, cfg.intermediate)
            layer.mlp.fc2 = Linear(gen, cfg.intermediate, rd)
            layer.ln2 = LayerNorm(rd)
            self.layers.append(layer)
        self.trans_conv1 = Conv(gen, 3, 3, rd, rd)
        self.trans_up1 = Conv(gen, k, k, rd, rd // 2)
        self.trans_up2 = Conv(gen, k, k, rd // 2, 1)


def clipseg_decoder_init(gen: torch.Generator, cfg: ClipSegDecoderConfig) -> ClipSegDecoder:
    return ClipSegDecoder(gen, cfg)


def clipseg_decoder_apply(p: ClipSegDecoder, cfg: ClipSegDecoderConfig, activations, cond, *,
                          ops=KERNELS):
    """activations: list of [B, N, D] (shallow to deep); cond: [B, cond_dim].

    Returns [B, H, W] single-channel logits (H = W = grid * patch_size).
    The products run in the promoted type, so bf16 tower activations meet
    the float32 decoder weights in float32, the attention included (``mha``
    without ``ln`` or ``residual``: the flash-attention kernel at head dim
    reduce_dim / heads)."""
    out = None
    # deep to shallow; reduces[0] takes the deepest tap, as in the JAX package
    for i, (act, reduce_p, layer) in enumerate(zip(activations[::-1], p.reduces, p.layers)):
        r = linear(reduce_p, act)
        out = r if out is None else r + out
        if i == cfg.conditional_layer:
            mul, add = linear(p.film_mul, cond), linear(p.film_add, cond)
            out = mul[:, None, :] * out + add[:, None, :]
        # post-norm ReLU transformer layer (HF CLIPSegDecoderLayer)
        a = mha(layer.attn, out, num_heads=cfg.heads, ops=ops)
        out = layernorm(layer.ln1, out + a, eps=cfg.ln_eps)
        h = linear(layer.mlp.fc2, torch.relu(linear(layer.mlp.fc1, out)))
        out = layernorm(layer.ln2, out + h, eps=cfg.ln_eps)

    out = out[:, 1:, :]  # drop CLS
    b, n, c = out.shape
    size = int(round(n ** 0.5))
    y = torch.relu(conv2d(p.trans_conv1, out.reshape(b, size, size, c)))
    k = cfg.patch_size // 4
    y = torch.relu(conv_transpose2d(p.trans_up1, y, stride=k, dtype=y.dtype))
    y = conv_transpose2d(p.trans_up2, y, stride=k, dtype=y.dtype)
    return y[..., 0]
