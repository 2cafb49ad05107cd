"""Attention parameters and the composed self-attention (counterpart of
nextgen_uia_tpu/nn/attention.py's ``attention_init`` and ``mha``).

The serving path's attention lives in the whole-block kernel
(ops/fused_block.py). ``mha`` ports the JAX ``mha``'s routes as the JAX
package dispatches them on its kernel path, chosen from the caller's
arguments alone:
  - with ``ln`` and no LoRA (frozen pre-norm blocks, the causal CLIP text
    tower inside the step among them): with ``residual`` the LN+QKV kernel,
    then the attention+o-projection+residual kernel; without it (LayerScale
    blocks, DINOv2) and N <= 512: the LN+QKV kernel, then the
    flash-attention kernel, then the o-projection; ``key_padding_bias`` and
    ``causal`` reach the attention. The JAX package takes these kernels only
    at token counts its tiles take (multiples of 16 in bf16, of 8 in
    float32: the text tower's 32- and 64-token buckets); the port's take any;
  - every other call, N <= ``FLASH_N_MAX`` (weights that train under
    ``mlp_impl='xla'``, BERT's post-norm layers, LoRA, the CLIPSeg decoder,
    DINOv2 at 518 px with 1370 tokens): LayerNorm when ``ln`` is
    given, q/k/v as plain products (one packed product, or one each plus
    ``(drop(z) @ a) @ b * alpha / sqrt(r)`` where ``p.lora`` holds q/k/v/o
    pairs), the flash-attention kernel
    (forward and backward; ``key_padding_bias`` a constant, ``causal``), the
    o-projection (plus its LoRA update on the head concat) and its bias,
    then ``residual``. Dropout reaches only the LoRA branch's input, one mask
    per projection, drawn from ``gen`` in train mode or given as
    ``lora_masks``. Autograd reaches every weight the products read;
  - ``impl='einsum'``, a generic ``mask`` or N > ``FLASH_N_MAX``: the same
    projections around plain attention: float32 logits, ``mask``,
    ``key_padding_bias`` and the causal mask added, softmax, cast back to
    the projections' dtype.

``impl`` is the JAX ``mha``'s: 'auto' takes the routes above; 'flash' the
flash-attention routes at any N; 'einsum' the plain attention;
'fused_block' and 'hybrid_block' (opt-in, frozen weights) take the
LayerNorm first when ``ln`` is given, then the whole attention block as one
op (ops/fused_attention.py: K11, or the composed forward with K11's
backward), with ``key_padding_bias`` and ``causal``, and add ``residual``
outside; with a generic mask or LoRA they fall through to 'auto', as in the
JAX package.
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


# the flash-attention routes' ceiling: the JAX ``_flash_n_max()`` default
FLASH_N_MAX = 2048


def causal_mask(n: int, device=None, dtype=torch.float32):
    """Additive causal mask [1, 1, N, N]; -inf above the diagonal."""
    m = torch.triu(torch.full((n, n), float("-inf"), dtype=dtype, device=device), diagonal=1)
    return m[None, None]


def _attention_einsum(q, k, v, *, mask, key_padding_bias, causal):
    """Plain attention of [B, N, H, dh] q, k, v: float32 logits, the masks
    added, softmax, the weights cast to q's dtype before the product with v."""
    n, dh = q.shape[1], q.shape[-1]
    f32 = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * (1.0 / math.sqrt(dh))
    if mask is not None:
        logits = logits + mask
    if key_padding_bias is not None:
        logits = logits + key_padding_bias.to(f32)[:, None, None, :]
    if causal:
        logits = logits + causal_mask(n, device=q.device)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _mha_composed(p: Attention, x, *, num_heads, ln, ln_eps, residual, mask, key_padding_bias,
                  causal, flash, lora_alpha, lora_dropout, gen, lora_masks, ops):
    """q/k/v as plain products (with LoRA updates where ``p.lora`` holds
    pairs), the flash-attention op (``flash``) or plain attention, the
    o-projection, the residual."""
    b, n, d = x.shape
    heads, dh = num_heads, d // num_heads
    pairs = dict(p.lora.named_children()) if "lora" in p._modules else {}
    masks, scale = {}, 1.0
    if pairs:
        scale = (lora_alpha if lora_alpha is not None else 1.0) / math.sqrt(
            next(iter(pairs.values())).a.shape[1])
        masks = dict(lora_masks or {})
        if not masks and gen is not None and lora_dropout > 0.0:
            masks = {t: dropout_mask(gen, lora_dropout, (b, n, d), device=x.device)
                     for t in pairs}
    z = x if ln is None else layernorm(ln, x, eps=ln_eps)
    dt = z.dtype

    if pairs:
        def proj(name):
            lin = getattr(p, name)
            y = z @ lin.w.to(dt)
            if lin.b is not None:
                y = y + lin.b.to(dt)
            if name in pairs:
                y = y + _lora_delta(pairs[name], z, masks.get(name), scale)
            return y.reshape(b, n, heads, dh)

        q, k, v = proj("q"), proj("k"), proj("v")
    else:
        # one packed product; q, k, v are strided views of it
        y = z @ torch.cat([p.q.w, p.k.w, p.v.w], dim=1).to(dt)
        if p.q.b is not None:
            y = y + torch.cat([p.q.b, p.k.b, p.v.b]).to(dt)
        q, k, v = y.reshape(b, n, 3, heads, dh).unbind(2)
    if flash:
        out = ops.flash_attention(q, k, v, bias=key_padding_bias, causal=causal, layout="bnhd",
                                  bias_grad=False)
    else:
        out = _attention_einsum(q, k, v, mask=mask, key_padding_bias=key_padding_bias,
                                causal=causal)
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
    (LN only when ``ln`` is given; plus each projection's LoRA update when
    ``p`` holds ``lora``, scaled by ``lora_alpha / sqrt(r)``).

    x [B, N, D]; ``mask`` an additive mask broadcastable to [B, H, N, N],
    ``key_padding_bias`` [B, N] additive. The routes are the module
    docstring's. On the frozen LN routes the kernels give no weight
    gradients and refuse weights that train: callers that train the
    projections pass ``ln=None`` (LayerNorm applied before the call), as
    the JAX package's blocks do under ``mlp_impl='xla'``.
    """
    if impl not in ("auto", "einsum", "flash", "fused_block", "hybrid_block"):
        raise ValueError(f"mha: unknown impl {impl!r}")
    lora = "lora" in p._modules
    if impl in ("fused_block", "hybrid_block") and mask is None and not lora:
        z = x if ln is None else layernorm(ln, x, eps=ln_eps)
        block = ops.fused_attn_block if impl == "fused_block" else ops.hybrid_attn_block
        out = block(z, p, heads=num_heads, bias=key_padding_bias, causal=causal)
        return out if residual is None else residual + out
    b, n, d = x.shape
    flash = mask is None and impl != "einsum" and (impl == "flash" or n <= FLASH_N_MAX)
    if flash and ln is not None and not lora and (residual is not None or n <= 512):
        q, k, v = ops.fused_ln_qkv(x, ln, p, heads=num_heads, eps=ln_eps)
        if residual is not None:
            return ops.fused_attn_o_residual(q, k, v, residual, p.o, heads=num_heads,
                                             bias=key_padding_bias, causal=causal)
        out = ops.flash_attention(q, k, v, bias=key_padding_bias, causal=causal, layout="bhnd")
        dt = x.dtype
        return out.transpose(1, 2).reshape(b, n, d) @ p.o.w.to(dt) + p.o.b.to(dt)
    return _mha_composed(p, x, num_heads=num_heads, ln=ln, ln_eps=ln_eps, residual=residual,
                         mask=mask, key_padding_bias=key_padding_bias, causal=causal,
                         flash=flash, lora_alpha=lora_alpha, lora_dropout=lora_dropout, gen=gen,
                         lora_masks=lora_masks, ops=ops)
