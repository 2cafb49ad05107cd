"""CLIP text transformer, OpenAI layout (counterpart of
nextgen_uia_tpu/models/text_clip.py): token embedding plus a learned
positional embedding, pre-norm causal blocks (quick_gelu), the final
LayerNorm, EOT pooling (the feature at the position of the largest token id:
the EOT token has the largest id of the vocabulary) and a bias-free
projection. OpenAI CLIP and MetaCLIP use it.

Each block takes the JAX package's route (``_text_block``):
  - ``block_impl 'fused_infer'`` with ``mlp_impl 'auto'`` (the frozen tower
    forward only, models/clip.py::infer_cfg): one call of the whole-block
    kernel with the causal mask;
  - ``'auto'`` with ``mlp_impl 'auto'`` (the frozen tower inside the step
    under ``--tune_text_encoder``): ``mha``'s frozen LN route, the LN+QKV
    kernel and then the attention+o-projection+residual kernel with the
    causal mask, then LayerNorm and the fused-MLP kernel;
  - ``mlp_impl 'xla'`` (the tower's own weights train, ``--method full``):
    LayerNorm, ``mha`` with the causal mask (forward and backward), the
    residual, LayerNorm, the MLP as plain products, the residual.
The 77 tokens run unpadded on every route: the kernels mask their ragged
edges, and under the causal mask no real row reads a later column, so the
JAX package's padding to 80 changes nothing. The JAX ``'auto'`` route takes
its LN+QKV and attention+o-projection kernels only at the token counts its
tiles take (the 32- and 64-token buckets of ``trim_token_padding``) and the
flash-attention route at the others; the port takes its kernels at every
length, the same function.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.attention import mha
from ..nn.layers import Embedding, LayerNorm, Linear, embedding, layernorm, linear, normal, param
from ..ops import KERNELS
from .vit import Block, ViTConfig, run_mlp


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    depth: int = 12
    embed_dim: int = 512
    act: str = "quick_gelu"
    ln_eps: float = 1e-5
    # 'auto': the frozen kernels; 'xla': plain products for weights that train
    mlp_impl: str = "auto"
    # 'fused_infer': the whole-block kernel (forward only, mlp_impl 'auto');
    # 'auto': the composed route
    block_impl: str = "auto"


def _as_vit_cfg(cfg: TextConfig) -> ViTConfig:
    """Text blocks share the pre-norm block of the ViT."""
    return ViTConfig(width=cfg.width, heads=cfg.heads, depth=cfg.depth, act=cfg.act,
                     ln_eps=cfg.ln_eps, mlp_impl=cfg.mlp_impl, block_impl=cfg.block_impl)


class TextTransformer(nn.Module):
    """``text_init``: token_embedding, pos [ctx, D], blocks, ln_final, proj."""

    def __init__(self, gen, cfg: TextConfig):
        super().__init__()
        self.token_embedding = Embedding(gen, cfg.vocab_size, cfg.width, std=0.02)
        self.pos = param(normal(gen, (cfg.context_length, cfg.width), 0.01))
        vcfg = _as_vit_cfg(cfg)
        self.blocks = nn.ModuleList(Block(gen, vcfg) for _ in range(cfg.depth))
        self.ln_final = LayerNorm(cfg.width)
        self.proj = Linear(gen, cfg.width, cfg.embed_dim, bias=False, std=cfg.width ** -0.5)


def text_init(gen: torch.Generator, cfg: TextConfig) -> TextTransformer:
    return TextTransformer(gen, cfg)


def text_apply(p: TextTransformer, cfg: TextConfig, token_ids, *, dtype=None, ops=KERNELS):
    """token_ids [B, L] integer -> [B, embed_dim]."""
    token_ids = token_ids.long()
    x = embedding(p.token_embedding, token_ids, dtype=dtype)
    x = x + p.pos[: x.shape[1]].to(x.dtype)
    vcfg = _as_vit_cfg(cfg)
    for blk in p.blocks:
        x = _text_block(blk, x, vcfg, dtype=dtype, ops=ops)
    x = layernorm(p.ln_final, x, eps=cfg.ln_eps)
    eot = torch.argmax(token_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return linear(p.proj, pooled, dtype=pooled.dtype)


def _text_block(p: Block, x, cfg: ViTConfig, *, dtype=None, ops=KERNELS):
    """One causal pre-norm block by the module docstring's routes."""
    if cfg.block_impl not in ("auto", "fused_infer"):
        raise ValueError(f"unknown block_impl {cfg.block_impl!r} ('auto' or 'fused_infer')")
    if cfg.mlp_impl not in ("auto", "xla"):
        raise ValueError(f"unknown mlp_impl {cfg.mlp_impl!r} ('auto' or 'xla')")
    if cfg.block_impl == "fused_infer" and cfg.mlp_impl == "auto":
        return ops.fused_block_infer(x.contiguous(), p, heads=cfg.heads, act=cfg.act,
                                     eps=cfg.ln_eps, causal=True)
    if cfg.mlp_impl == "auto":
        x = mha(p.attn, x, num_heads=cfg.heads, causal=True, ln=p.ln1, ln_eps=cfg.ln_eps,
                residual=x, ops=ops)
    else:
        x = x + mha(p.attn, layernorm(p.ln1, x, eps=cfg.ln_eps), num_heads=cfg.heads,
                    causal=True, ops=ops)
    return x + run_mlp(p.mlp, layernorm(p.ln2, x, eps=cfg.ln_eps), cfg.act, dtype=dtype,
                       ops=ops, impl=cfg.mlp_impl)
