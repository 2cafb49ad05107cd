"""Vision Transformer (counterpart of nextgen_uia_tpu/models/vit.py).

Two block routes, as in the JAX package's ``ViTConfig.block_impl``:
``'fused_infer'`` runs each block forward-only through the whole-block
kernel (eval and serving forwards, models/clip.py::infer_cfg); ``'auto'``
composes the LN+QKV, attention+o-projection+residual and LN+MLP+residual
kernels, which have backward kernels, so the train step differentiates
through them (frozen tower, trainable adapters). Either route then applies
the block's MONA adapter. Blocks with LayerScale (DINOv2's ``ls1``/``ls2``)
take their own route at any ``block_impl``: attention without the residual
(``mha``'s LayerScale routes, through the flash-attention kernel), then the
MLP through the fused-MLP kernel, each scaled before its residual add. The
token sequence runs unpadded (N = grid^2 + 1): the kernels mask their ragged
edges themselves.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..adapters.mona import mona_apply
from ..nn.attention import Attention, mha
from ..nn.layers import Conv, LayerNorm, Linear, layernorm, linear, normal, param
from ..ops import KERNELS


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
    proj_dim: int | None = 512
    ln_eps: float = 1e-5           # timm uses 1e-6
    mona_variant: str = "hybrid"
    # 'auto': the composed block kernels (differentiable); 'fused_infer': the
    # forward-only whole-block kernel, for paths never differentiated
    block_impl: str = "auto"

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
    """``vit_init``, timm layout: patch conv (HWIO, with bias), cls [D],
    pos [N, D], blocks, final norm over all tokens, optional bias-free
    projection. The OpenAI layout (ln_pre, CLS-only final norm, bias-free
    patch conv) comes with the other CLIP families."""

    def __init__(self, gen, cfg: ViTConfig):
        super().__init__()
        scale = cfg.width ** -0.5
        self.patch = Conv(gen, cfg.patch_size, cfg.patch_size, 3, cfg.width)
        self.cls = param(normal(gen, (cfg.width,), scale))
        self.pos = param(normal(gen, (cfg.seq_len, cfg.width), scale))
        self.blocks = nn.ModuleList(Block(gen, cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.width)
        if cfg.proj_dim is not None:
            self.proj = Linear(gen, cfg.width, cfg.proj_dim, bias=False, std=scale)


def vit_init(gen: torch.Generator, cfg: ViTConfig) -> ViT:
    return ViT(gen, cfg)


def embed_patches(p: ViT, cfg: ViTConfig, images, *, dtype=None):
    """images [B, H, W, 3] -> tokens [B, N, D] with CLS + positional embedding."""
    w = p.patch.w
    if dtype is not None:
        images, w = images.to(dtype), w.to(dtype)
    x = F.conv2d(images.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # [B, grid*grid, D]
    x = x + p.patch.b.to(x.dtype)
    b = x.shape[0]
    x = torch.cat([p.cls.to(x.dtype).expand(b, 1, cfg.width), x], dim=1)
    return x + p.pos.to(x.dtype)


def run_mlp(mlp, h_in, act: str, *, dtype=None, ops=KERNELS):
    """fc1 -> act -> fc2 through ``ops.fused_mlp``, or SwiGLU (silu(x1) * x2
    -> w3) as plain products when the block carries w12/w3."""
    if hasattr(mlp, "w12"):
        x1, x2 = linear(mlp.w12, h_in, dtype=dtype).chunk(2, dim=-1)
        return linear(mlp.w3, F.silu(x1) * x2, dtype=dtype)
    x = h_in if dtype is None else h_in.to(dtype)
    return ops.fused_mlp(x, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, act=act)


def block_apply(p: Block, x, cfg: ViTConfig, *, dtype=None, ops=KERNELS, gen=None):
    """Pre-norm block, then the block's MONA adapter (in train mode when a
    dropout generator ``gen`` is given)."""
    x = x if dtype is None else x.to(dtype)
    if hasattr(p, "ls1"):
        a = mha(p.attn, x, num_heads=cfg.heads, ln=p.ln1, ln_eps=cfg.ln_eps, ops=ops)
        x = x + a * p.ls1.to(a.dtype)
        m = run_mlp(p.mlp, layernorm(p.ln2, x, eps=cfg.ln_eps), cfg.act, dtype=dtype, ops=ops)
        x = x + m * p.ls2.to(m.dtype)
    elif cfg.block_impl == "fused_infer":
        x = ops.fused_block_infer(x.contiguous(), p, heads=cfg.heads, act=cfg.act,
                                  eps=cfg.ln_eps)
    elif cfg.block_impl == "auto":
        x = mha(p.attn, x, num_heads=cfg.heads, ln=p.ln1, ln_eps=cfg.ln_eps, residual=x,
                ops=ops)
        x = ops.fused_ln_mlp_residual(x, p.ln2, p.mlp, act=cfg.act, eps=cfg.ln_eps)
    else:
        raise ValueError(f"unknown block_impl {cfg.block_impl!r} ('auto' or 'fused_infer')")
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
    pooled = layernorm(p.norm, x, eps=cfg.ln_eps)[:, 0, :]
    if hasattr(p, "proj"):
        pooled = linear(p.proj, pooled, dtype=pooled.dtype)
    return pooled, activations


VIT_B16_TIMM = ViTConfig(act="gelu", proj_dim=512, ln_eps=1e-6)
