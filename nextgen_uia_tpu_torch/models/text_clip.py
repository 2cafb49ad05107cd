"""CLIP text transformer, OpenAI layout (counterpart of
nextgen_uia_tpu/models/text_clip.py): token embedding plus a learned
positional embedding, pre-norm causal blocks (quick_gelu), the final
LayerNorm, EOT pooling (the feature at the position of the largest token id:
the EOT token has the largest id of the vocabulary) and a bias-free
projection. OpenAI CLIP and MetaCLIP use it.

The text tower runs frozen and forward-only here (``block_impl
'fused_infer'``, models/clip.py::infer_cfg): each block is one call of the
whole-block kernel with the causal mask. The 77 tokens run unpadded: the
kernel masks its ragged edge, and under the causal mask no real row reads a
later column, so the JAX package's padding to 80 changes nothing. The
composed route, which the JAX package runs in the step under
``--tune_text_encoder`` (the tower still frozen), is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.layers import Embedding, LayerNorm, Linear, embedding, layernorm, linear, normal, param
from ..ops import KERNELS
from .vit import Block, ViTConfig


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
    # 'fused_infer': the whole-block kernel (forward only); 'auto': the
    # composed route, not ported
    block_impl: str = "auto"


def _as_vit_cfg(cfg: TextConfig) -> ViTConfig:
    """Text blocks share the pre-norm block of the ViT."""
    return ViTConfig(width=cfg.width, heads=cfg.heads, depth=cfg.depth, act=cfg.act,
                     ln_eps=cfg.ln_eps, block_impl=cfg.block_impl)


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
    if cfg.block_impl != "fused_infer":
        raise NotImplementedError(
            "text_apply: only the forward-only text tower (block_impl 'fused_infer', "
            "models/clip.py::infer_cfg) is ported; the composed route that "
            "--tune_text_encoder differentiates is not (ROADMAP.md, section A, item 17)")
    token_ids = token_ids.long()
    x = embedding(p.token_embedding, token_ids, dtype=dtype)
    x = x + p.pos[: x.shape[1]].to(x.dtype)
    vcfg = _as_vit_cfg(cfg)
    for blk in p.blocks:
        x = ops.fused_block_infer(x.contiguous(), blk, heads=vcfg.heads, act=vcfg.act,
                                  eps=vcfg.ln_eps, causal=True)
    x = layernorm(p.ln_final, x, eps=cfg.ln_eps)
    eot = torch.argmax(token_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return linear(p.proj, pooled, dtype=pooled.dtype)
