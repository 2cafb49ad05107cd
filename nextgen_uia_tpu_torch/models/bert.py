"""BERT text tower, PubMedBERT for BiomedCLIP (counterpart of
nextgen_uia_tpu/models/bert.py): a BERT-base encoder (12 post-norm layers,
width 768, 12 heads, intermediate 3072, vocabulary 30522, context 256,
LayerNorm eps 1e-12), CLS pooling of the last hidden state and an MLP
projection 768 -> (768 + 512) // 2 -> 512 with no biases.

Each layer takes the JAX package's route on its chip. A layer without LoRA
runs the three-kernel chain (q/k/v on the raw x, ``fused_ln_qkv`` with
``ln=None``; attention + o-projection + residual + LayerNorm,
``fused_attn_o_residual`` with ``post_ln``; MLP + residual + LayerNorm,
``fused_postnorm_mlp_ln``), differentiable in x, or, with
``block_impl='fused_infer'`` and ``ops.fused_block.bert_block_opted_in()``,
the whole layer in one forward-only call of the post-norm whole-block
kernel. A layer whose attention holds LoRA pairs (``--tune_text_encoder``,
adapters/lora.py::inject_lora_bert) runs the composed route: ``mha``'s LoRA
route with ``residual=x`` and the key-padding bias (the flash-attention
kernel forward and backward), LayerNorm, the fused MLP kernel (forward and
backward), LayerNorm. Training the tower's own weights (``mlp_impl='xla'``,
``--method full --tune_text_encoder``) takes the JAX package's plain layer
at any ``block_impl``: ``mha`` on the raw x with the key-padding bias (q/k/v
products, the flash-attention kernel forward and backward, the
o-projection; LoRA pairs where present), the residual add, LayerNorm, the
MLP as plain products (exact GELU), the residual add, LayerNorm; no
frozen-weight kernel runs on it. Padded keys carry a -1e9 score bias.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.attention import Attention, mha
from ..nn.layers import Embedding, LayerNorm, Linear, embedding, gelu, layernorm, linear
from ..ops import KERNELS
from ..ops.fused_block import bert_block_opted_in
from .vit import run_mlp


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    width: int = 768
    depth: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    context_length: int = 256
    embed_dim: int = 512          # the CLIP space
    ln_eps: float = 1e-12
    pad_id: int = 0
    # 'auto': the frozen kernels; 'xla': plain products for weights that train
    mlp_impl: str = "auto"
    lora_alpha: float = 32.0      # text-tower LoRA scaling alpha / sqrt(r)
    lora_dropout: float = 0.0     # on the LoRA branch's input, in train mode
    # 'fused_infer': the whole-layer kernel where opted in; 'auto': the chain
    block_impl: str = "auto"


class BertEmbeddings(nn.Module):
    def __init__(self, gen, cfg: BertConfig):
        super().__init__()
        self.word = Embedding(gen, cfg.vocab_size, cfg.width)
        self.position = Embedding(gen, cfg.max_positions, cfg.width)
        self.token_type = Embedding(gen, cfg.type_vocab, cfg.width)
        self.ln = LayerNorm(cfg.width)


class BertLayer(nn.Module):
    """One post-norm layer: attn (q/k/v/o), attn_ln, ffn (fc1/fc2), ffn_ln."""

    def __init__(self, gen, cfg: BertConfig):
        super().__init__()
        self.attn = Attention(gen, cfg.width)
        self.attn_ln = LayerNorm(cfg.width)
        self.ffn = nn.Module()
        self.ffn.fc1 = Linear(gen, cfg.width, cfg.intermediate)
        self.ffn.fc2 = Linear(gen, cfg.intermediate, cfg.width)
        self.ffn_ln = LayerNorm(cfg.width)


class Bert(nn.Module):
    """``bert_init``'s tree: embeddings, layers, proj (fc1/fc2, no biases)."""

    def __init__(self, gen, cfg: BertConfig):
        super().__init__()
        hidden = (cfg.width + cfg.embed_dim) // 2
        self.embeddings = BertEmbeddings(gen, cfg)
        self.layers = nn.ModuleList(BertLayer(gen, cfg) for _ in range(cfg.depth))
        self.proj = nn.Module()
        self.proj.fc1 = Linear(gen, cfg.width, hidden, bias=False)
        self.proj.fc2 = Linear(gen, hidden, cfg.embed_dim, bias=False)


def bert_init(gen: torch.Generator, cfg: BertConfig) -> Bert:
    return Bert(gen, cfg)


def bert_apply(p: Bert, cfg: BertConfig, token_ids, *, dtype=None, ops=KERNELS, gen=None):
    """token_ids [B, L] -> CLS-pooled, projected embedding [B, embed_dim];
    the ids equal to ``pad_id`` are the padding. ``gen``: the LoRA dropout
    generator of a train forward (None: eval)."""
    if cfg.mlp_impl not in ("auto", "xla"):
        raise ValueError(f"unknown mlp_impl {cfg.mlp_impl!r} ('auto' or 'xla')")
    token_ids = token_ids.long()
    emb = p.embeddings
    x = embedding(emb.word, token_ids, dtype=dtype)
    positions = torch.arange(token_ids.shape[1], device=token_ids.device)
    x = x + embedding(emb.position, positions, dtype=x.dtype)[None]
    x = x + embedding(emb.token_type, torch.zeros_like(token_ids), dtype=x.dtype)
    x = layernorm(emb.ln, x, eps=cfg.ln_eps)
    # additive key-padding bias [B, L]: 0 where attended, -1e9 where padded
    pad_bias = (token_ids == cfg.pad_id).to(torch.float32) * -1e9

    whole_layer = (cfg.block_impl == "fused_infer" and cfg.mlp_impl == "auto"
                   and bert_block_opted_in())
    for layer in p.layers:
        x = x.contiguous()
        if cfg.mlp_impl == "xla":
            a = mha(layer.attn, x, num_heads=cfg.heads, key_padding_bias=pad_bias,
                    lora_alpha=cfg.lora_alpha, lora_dropout=cfg.lora_dropout, gen=gen, ops=ops)
            x = layernorm(layer.attn_ln, x + a, eps=cfg.ln_eps)
            h = run_mlp(layer.ffn, x, "gelu", dtype=dtype, ops=ops, impl="xla")
            x = layernorm(layer.ffn_ln, x + h, eps=cfg.ln_eps)
            continue
        if "lora" in layer.attn._modules:
            a_sum = mha(layer.attn, x, num_heads=cfg.heads, key_padding_bias=pad_bias,
                        residual=x, lora_alpha=cfg.lora_alpha, lora_dropout=cfg.lora_dropout,
                        gen=gen, ops=ops)
            x = layernorm(layer.attn_ln, a_sum, eps=cfg.ln_eps)
            ffn = layer.ffn
            h = ops.fused_mlp(x, ffn.fc1.w, ffn.fc1.b, ffn.fc2.w, ffn.fc2.b, act="gelu")
            x = layernorm(layer.ffn_ln, x + h, eps=cfg.ln_eps)
            continue
        if whole_layer:
            x = ops.fused_block_infer(x, layer, heads=cfg.heads, act="gelu", eps=cfg.ln_eps,
                                      key_bias=pad_bias, layout="postnorm")
            continue
        q, k, v = ops.fused_ln_qkv(x, None, layer.attn, heads=cfg.heads)
        y = ops.fused_attn_o_residual(q, k, v, x, layer.attn.o, heads=cfg.heads, bias=pad_bias,
                                      post_ln=layer.attn_ln, ln_eps=cfg.ln_eps)
        x = ops.fused_postnorm_mlp_ln(y, layer.ffn, layer.ffn_ln, act="gelu", eps=cfg.ln_eps)

    pooled = x[:, 0, :]
    h = gelu(linear(p.proj.fc1, pooled, dtype=pooled.dtype))
    return linear(p.proj.fc2, h, dtype=h.dtype)
