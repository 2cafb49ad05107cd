"""Vision Transformer (counterpart of nextgen_uia_tpu/models/vit.py).

Both reference layouts: timm/BiomedCLIP (patch bias, final norm over all
tokens, gelu) and OpenAI CLIP (no patch bias, ``ln_pre`` after the
positional embedding, ``ln_post`` on the CLS token only, quick_gelu).

Two block routes, as in the JAX package's ``ViTConfig.block_impl``:
``'fused_infer'`` runs each block forward-only through the whole-block
kernel (eval and serving forwards, models/clip.py::infer_cfg); ``'auto'``
composes the LN+QKV, attention+o-projection+residual and LN+MLP+residual
kernels, which have backward kernels, so the train step differentiates
through them (frozen tower, trainable adapters). A block whose attention
holds LoRA pairs takes ``mha``'s LoRA route at either ``block_impl`` (the
whole-block kernel declines it, as the JAX one does): LayerNorm, the
projections with their LoRA updates, the flash-attention kernel, then the
LN+MLP+residual kernel. A block the whole-block kernel does not take
(``fused_block_eligible``: a bf16 head dim other than 64, a width not a
multiple of 64) takes the composed route, as the JAX package falls back
where its ``fused_block_infer`` returns None. ``attn_impl`` 'fused_block'
or 'hybrid_block' (opt-in, frozen attention without LoRA) replaces the
composed route's LN+QKV and attention+o-projection kernels with LayerNorm
and ``mha``'s whole-attention-block op (K11). Either route then applies the
block's MONA adapter. Blocks with LayerScale (DINOv2's ``ls1``/``ls2``) take their own
route at any ``block_impl``: attention without the residual (``mha``'s
LayerScale routes, through the flash-attention kernel), then the MLP
through the fused-MLP kernel, each scaled before its residual add.
``mlp_impl='xla'`` (full fine-tuning: the tower's own weights train) takes
the JAX package's full route at any ``block_impl``: LayerNorm, ``mha``
without ``ln`` or ``residual`` (q/k/v products, the flash-attention kernel
forward and backward, the o-projection), the residual add (LayerScale
first where present), LayerNorm, the MLP as plain products (exact GELU),
the residual add, then MONA where present; no frozen-weight kernel runs
on it. The token sequence runs unpadded (N = grid^2 + 1): the kernels mask
their ragged edges themselves.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..adapters.mona import mona_apply
from ..nn.attention import Attention, mha
from ..nn.layers import (ACTIVATIONS, Conv, LayerNorm, Linear, layernorm, linear, normal,
                         param)
from ..ops import KERNELS
from ..ops.fused_block import fused_block_eligible


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    act: str = "gelu"              # 'gelu' (timm/BiomedCLIP) | 'quick_gelu' (OpenAI)
    ffn: str = "mlp"               # 'mlp' | 'swiglufused' (DINOv2 giant2)
    use_ln_pre: bool = False       # True for the OpenAI/MetaCLIP layout
    patch_bias: bool = True        # False for OpenAI/MetaCLIP conv1
    final_norm: str = "all"        # 'all' (timm) | 'cls' (OpenAI ln_post on CLS only)
    proj_dim: int | None = 512
    ln_eps: float = 1e-5           # timm uses 1e-6
    mona_variant: str = "hybrid"
    lora_alpha: float = 32.0
    # dropout on the LoRA branch's input in train mode (a dropout generator given)
    lora_dropout: float = 0.0
    # 'auto': the composed block kernels (differentiable); 'fused_infer': the
    # forward-only whole-block kernel, for paths never differentiated
    block_impl: str = "auto"
    # mha's route in the composed pre-norm block: 'auto' (LN+QKV, then
    # attention+o+residual), or the opt-in 'fused_block' / 'hybrid_block'
    # (the whole attention block as one op, ops/fused_attention.py)
    attn_impl: str = "auto"
    # 'auto': the frozen-weight kernels; 'xla': plain LayerNorm and MLP
    # products around mha's flash-attention route, for weights that train
    mlp_impl: str = "auto"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


class Block(nn.Module):
    """Pre-norm block parameters: ln1, attn (q/k/v/o), ln2, mlp (fc1/fc2, or
    SwiGLU's w12/w3 for ``ffn='swiglufused'``: hidden round8(2/3 * 4d)),
    LayerScale ``ls1``/``ls2`` [D] when ``layerscale`` gives their initial
    value, and ``mona`` once an adapter is injected."""

    def __init__(self, gen, cfg: ViTConfig, *, layerscale: float | None = None):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.ln1 = LayerNorm(cfg.width)
        self.attn = Attention(gen, cfg.width)
        self.ln2 = LayerNorm(cfg.width)
        self.mlp = nn.Module()
        if cfg.ffn == "swiglufused":
            hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
            self.mlp.w12 = Linear(gen, cfg.width, 2 * hidden)
            self.mlp.w3 = Linear(gen, hidden, cfg.width)
        else:
            self.mlp.fc1 = Linear(gen, cfg.width, hidden)
            self.mlp.fc2 = Linear(gen, hidden, cfg.width)
        if layerscale is not None:
            self.ls1 = param(torch.full((cfg.width,), layerscale))
            self.ls2 = param(torch.full((cfg.width,), layerscale))


class ViT(nn.Module):
    """``vit_init``: patch conv (HWIO, with bias unless ``patch_bias`` is
    off), cls [D], pos [N, D], blocks, final norm, ``ln_pre`` when
    ``use_ln_pre``, optional bias-free projection."""

    def __init__(self, gen, cfg: ViTConfig):
        super().__init__()
        scale = cfg.width ** -0.5
        self.patch = Conv(gen, cfg.patch_size, cfg.patch_size, 3, cfg.width,
                          bias=cfg.patch_bias)
        self.cls = param(normal(gen, (cfg.width,), scale))
        self.pos = param(normal(gen, (cfg.seq_len, cfg.width), scale))
        self.blocks = nn.ModuleList(Block(gen, cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.width)
        if cfg.use_ln_pre:
            self.ln_pre = LayerNorm(cfg.width)
        if cfg.proj_dim is not None:
            self.proj = Linear(gen, cfg.width, cfg.proj_dim, bias=False, std=scale)


def vit_init(gen: torch.Generator, cfg: ViTConfig) -> ViT:
    return ViT(gen, cfg)


def embed_patches(p: ViT, cfg: ViTConfig, images, *, dtype=None):
    """images [B, H, W, 3] -> tokens [B, N, D] with CLS + positional
    embedding (then ``ln_pre`` in the OpenAI layout)."""
    w = p.patch.w
    if dtype is not None:
        images, w = images.to(dtype), w.to(dtype)
    x = F.conv2d(images.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # [B, grid*grid, D]
    if p.patch.b is not None:
        x = x + p.patch.b.to(x.dtype)
    b = x.shape[0]
    x = torch.cat([p.cls.to(x.dtype).expand(b, 1, cfg.width), x], dim=1)
    x = x + p.pos.to(x.dtype)
    if cfg.use_ln_pre:
        x = layernorm(p.ln_pre, x, eps=cfg.ln_eps)
    return x


def run_mlp(mlp, h_in, act: str, *, dtype=None, ops=KERNELS, impl: str = "auto"):
    """fc1 -> act -> fc2 through ``ops.fused_mlp`` (frozen weights), as plain
    products with ``impl='xla'`` (weights that train), or SwiGLU (silu(x1) *
    x2 -> w3) as plain products when the block carries w12/w3."""
    if hasattr(mlp, "w12"):
        x1, x2 = linear(mlp.w12, h_in, dtype=dtype).chunk(2, dim=-1)
        return linear(mlp.w3, F.silu(x1) * x2, dtype=dtype)
    if impl == "xla":
        h = linear(mlp.fc1, h_in, dtype=dtype)
        return linear(mlp.fc2, ACTIVATIONS[act](h), dtype=dtype)
    x = h_in if dtype is None else h_in.to(dtype)
    return ops.fused_mlp(x, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, act=act)


def block_apply(p: Block, x, cfg: ViTConfig, *, dtype=None, ops=KERNELS, gen=None):
    """Pre-norm block, then the block's MONA adapter (in train mode, with
    MONA's and LoRA's dropout, when a dropout generator ``gen`` is given)."""
    x = x if dtype is None else x.to(dtype)
    if cfg.block_impl not in ("auto", "fused_infer"):
        raise ValueError(f"unknown block_impl {cfg.block_impl!r} ('auto' or 'fused_infer')")
    if cfg.mlp_impl not in ("auto", "xla"):
        raise ValueError(f"unknown mlp_impl {cfg.mlp_impl!r} ('auto' or 'xla')")
    lora = dict(lora_alpha=cfg.lora_alpha, lora_dropout=cfg.lora_dropout, gen=gen)
    if cfg.mlp_impl == "xla":
        a = mha(p.attn, layernorm(p.ln1, x, eps=cfg.ln_eps), num_heads=cfg.heads, ops=ops,
                **lora)
        x = x + (a * p.ls1.to(a.dtype) if hasattr(p, "ls1") else a)
        m = run_mlp(p.mlp, layernorm(p.ln2, x, eps=cfg.ln_eps), cfg.act, dtype=dtype, ops=ops,
                    impl="xla")
        x = x + (m * p.ls2.to(m.dtype) if hasattr(p, "ls2") else m)
    elif hasattr(p, "ls1"):
        a = mha(p.attn, x, num_heads=cfg.heads, ln=p.ln1, ln_eps=cfg.ln_eps, ops=ops, **lora)
        x = x + a * p.ls1.to(a.dtype)
        m = run_mlp(p.mlp, layernorm(p.ln2, x, eps=cfg.ln_eps), cfg.act, dtype=dtype, ops=ops)
        x = x + m * p.ls2.to(m.dtype)
    elif (cfg.block_impl == "fused_infer"
          and fused_block_eligible(x, p, heads=cfg.heads, act=cfg.act)):
        x = ops.fused_block_infer(x.contiguous(), p, heads=cfg.heads, act=cfg.act,
                                  eps=cfg.ln_eps)
    else:
        x = mha(p.attn, x, num_heads=cfg.heads, ln=p.ln1, ln_eps=cfg.ln_eps, residual=x,
                ops=ops, impl=cfg.attn_impl, **lora)
        x = ops.fused_ln_mlp_residual(x, p.ln2, p.mlp, act=cfg.act, eps=cfg.ln_eps)
    if hasattr(p, "mona"):
        x = mona_apply(p.mona, x, (cfg.grid, cfg.grid), variant=cfg.mona_variant, ops=ops,
                       gen=gen)
    return x


def vit_apply(p: ViT, cfg: ViTConfig, images, *, dtype=None, extract_layers=(),
              ops=KERNELS, gen=None):
    """Run the tower. Returns (pooled_embedding, activations), where
    ``activations`` are the post-block token states of the blocks in
    ``extract_layers``. ``gen``: the dropout generator of a train forward."""
    x = embed_patches(p, cfg, images, dtype=dtype)
    activations = []
    for i, blk in enumerate(p.blocks):
        x = block_apply(blk, x, cfg, dtype=dtype, ops=ops, gen=gen)
        if i in extract_layers:
            activations.append(x)
    if cfg.final_norm == "all":
        pooled = layernorm(p.norm, x, eps=cfg.ln_eps)[:, 0, :]
    else:  # 'cls': OpenAI's ln_post on the CLS token only
        pooled = layernorm(p.norm, x[:, 0, :], eps=cfg.ln_eps)
    if hasattr(p, "proj"):
        pooled = linear(p.proj, pooled, dtype=pooled.dtype)
    return pooled, activations


VIT_B16_TIMM = ViTConfig(act="gelu", use_ln_pre=False, patch_bias=True, final_norm="all",
                         proj_dim=512, ln_eps=1e-6)
VIT_B16_OPENAI = ViTConfig(act="quick_gelu", use_ln_pre=True, patch_bias=False,
                           final_norm="cls", proj_dim=512, ln_eps=1e-5)
