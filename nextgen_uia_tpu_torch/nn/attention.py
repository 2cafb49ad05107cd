"""Attention parameters and the composed self-attention (counterpart of
nextgen_uia_tpu/nn/attention.py's ``attention_init`` and ``mha``).

The serving path's attention lives in the whole-block kernel
(ops/fused_block.py). ``mha`` ports the routes of the JAX ``mha`` that take
the pre-attention LayerNorm (``ln=``), without a generic mask, and the LoRA
route without it, as the JAX package dispatches them on its kernel path:
  - with ``residual`` and no LoRA (pre-norm blocks): the LN+QKV kernel,
    then the attention+o-projection+residual kernel;
  - with LoRA (``p.lora`` holds q/k/v/o pairs; the JAX package turns the
    LN+QKV and attention+o kernels off for it): LayerNorm, q/k/v as plain
    products plus ``(drop(z) @ a) @ b * alpha / sqrt(r)``, the
    flash-attention kernel (forward and backward; the key bias a constant),
    the o-projection plus its LoRA update on the head concat, then the
    residual. Dropout reaches only the LoRA branch's input, one mask per
    projection, drawn from ``gen`` in train mode or given as ``lora_masks``.
    Without ``ln`` (BERT's post-norm layers: ``residual=x`` and the
    key-padding bias) the projections read the raw x;
  - without residual (LayerScale blocks, DINOv2), N <= 512: the LN+QKV
    kernel, then the flash-attention kernel, then the o-projection;
  - without it, N > 512 (DINOv2 at 518 px, 1370 tokens): LayerNorm, the
    q/k/v projections as one plain product, the flash-attention kernel
    reading q, k, v as strided views of it, then the o-projection.

``impl`` is the JAX ``mha``'s: 'auto' takes the routes above;
'fused_block' and 'hybrid_block' (opt-in, frozen weights) take the
LayerNorm first when ``ln`` is given, then the whole attention block as one
op (ops/fused_attention.py: K11, or the composed forward with K11's
backward), with ``key_padding_bias`` and ``causal``, and add ``residual``
outside; with a generic mask or LoRA they fall through to 'auto', as in the
JAX package. 'einsum' and 'flash' are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import KERNELS
from .layers import Linear, dropout, dropout_mask, layernorm


class Attention(nn.Module):
    """q/k/v/o projections, each ``w`` [dim, dim] and ``b`` [dim]."""

    def __init__(self, gen, dim: int, *, bias: bool = True):
        super().__init__()
        self.q = Linear(gen, dim, dim, bias=bias)
        self.k = Linear(gen, dim, dim, bias=bias)
        self.v = Linear(gen, dim, dim, bias=bias)
        self.o = Linear(gen, dim, dim, bias=bias)


def _lora_delta(pair, x, mask, scale):
    """``(drop(x) @ a) @ b * scale`` in x's dtype; ``mask`` pre-scaled or None."""
    xl = dropout(x, 0.0, mask=mask)
    return (xl @ pair.a.to(x.dtype)) @ pair.b.to(x.dtype) * scale


def _mha_lora(p: Attention, x, *, num_heads, ln, ln_eps, residual, key_padding_bias,
              lora_alpha, lora_dropout, gen, lora_masks, ops):
    b, n, d = x.shape
    lora = p.lora
    pairs = dict(lora.named_children())
    scale = (lora_alpha if lora_alpha is not None else 1.0) / math.sqrt(
        next(iter(pairs.values())).a.shape[1])
    masks = dict(lora_masks or {})
    if not masks and gen is not None and lora_dropout > 0.0:
        masks = {t: dropout_mask(gen, lora_dropout, (b, n, d), device=x.device) for t in pairs}
    z = x if ln is None else layernorm(ln, x, eps=ln_eps)
    dt = z.dtype

    def proj(name):
        lin = getattr(p, name)
        y = z @ lin.w.to(dt)
        if lin.b is not None:
            y = y + lin.b.to(dt)
        if name in pairs:
            y = y + _lora_delta(pairs[name], z, masks.get(name), scale)
        return y.reshape(b, n, num_heads, d // num_heads)

    out = ops.flash_attention(proj("q"), proj("k"), proj("v"), bias=key_padding_bias,
                              layout="bnhd", bias_grad=False)
    cat = out.reshape(b, n, d)
    y = cat @ p.o.w.to(dt)
    if p.o.b is not None:
        y = y + p.o.b.to(dt)
    if "o" in pairs:
        y = y + _lora_delta(pairs["o"], cat, masks.get("o"), scale)
    return y if residual is None else residual + y


def mha(p: Attention, x, *, num_heads: int, ln=None, ln_eps: float = 1e-5, residual=None,
        mask=None, key_padding_bias=None, causal: bool = False, lora_alpha=None,
        lora_dropout: float = 0.0, gen=None, lora_masks=None, ops=KERNELS,
        impl: str = "auto"):
    """``[residual +] o(attention(q, k, v))`` with ``q, k, v = LN(x) W + b``
    (plus each projection's LoRA update when ``p`` holds ``lora``, scaled by
    ``lora_alpha / sqrt(r)``).

    x [B, N, D]. Without LoRA the projections and the LayerNorm are frozen
    (the kernels give no weight gradients); with LoRA, autograd reaches the
    pairs, the projection biases and x. The routes are the module
    docstring's; every other route of the JAX ``mha`` raises.
    """
    if impl in ("einsum", "flash"):
        raise NotImplementedError(
            f"mha: impl={impl!r} is not ported to the PyTorch package yet (ROADMAP.md, "
            "section A, item 3)")
    if impl not in ("auto", "fused_block", "hybrid_block"):
        raise ValueError(f"mha: unknown impl {impl!r}")
    if impl != "auto" and mask is None and "lora" not in p._modules:
        z = x if ln is None else layernorm(ln, x, eps=ln_eps)
        block = ops.fused_attn_block if impl == "fused_block" else ops.hybrid_attn_block
        out = block(z, p, heads=num_heads, bias=key_padding_bias, causal=causal)
        return out if residual is None else residual + out
    lora = "lora" in p._modules
    if (ln is None and not lora) or mask is not None or causal:
        raise NotImplementedError(
            "mha: only the LayerNorm routes and the LoRA route, without a generic mask or "
            "causal attention, are ported to the PyTorch package yet (ROADMAP.md, section A, "
            "item 3)")
    if lora:
        return _mha_lora(p, x, num_heads=num_heads, ln=ln, ln_eps=ln_eps, residual=residual,
                         key_padding_bias=key_padding_bias, lora_alpha=lora_alpha,
                         lora_dropout=lora_dropout, gen=gen, lora_masks=lora_masks, ops=ops)
    if residual is not None:
        q, k, v = ops.fused_ln_qkv(x, ln, p, heads=num_heads, eps=ln_eps)
        return ops.fused_attn_o_residual(q, k, v, residual, p.o, heads=num_heads,
                                         bias=key_padding_bias)
    b, n, d = x.shape
    dt = x.dtype
    if n <= 512:
        q, k, v = ops.fused_ln_qkv(x, ln, p, heads=num_heads, eps=ln_eps)
        out = ops.flash_attention(q, k, v, bias=key_padding_bias, layout="bhnd")
        cat = out.transpose(1, 2).reshape(b, n, d)
    else:
        z = layernorm(ln, x, eps=ln_eps)
        w = torch.cat([p.q.w, p.k.w, p.v.w], dim=1).to(dt)
        bias = torch.cat([p.q.b, p.k.b, p.v.b]).to(dt)
        qkv = (z @ w + bias).reshape(b, n, 3, num_heads, d // num_heads)
        out = ops.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                  bias=key_padding_bias, layout="bnhd")
        cat = out.reshape(b, n, d)
    return cat @ p.o.w.to(dt) + p.o.b.to(dt)
