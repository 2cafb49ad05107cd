"""Attention parameters and the composed self-attention (counterpart of
nextgen_uia_tpu/nn/attention.py's ``attention_init`` and ``mha``).

The serving path's attention lives in the whole-block kernel
(ops/fused_block.py). ``mha`` ports the routes of the JAX ``mha`` that take
the pre-attention LayerNorm (``ln=``), without LoRA or a generic mask, as
the JAX package dispatches them on its kernel path:
  - with ``residual`` (pre-norm blocks): the LN+QKV kernel, then the
    attention+o-projection+residual kernel;
  - without it (LayerScale blocks, DINOv2), N <= 512: the LN+QKV kernel,
    then the flash-attention kernel, then the o-projection;
  - without it, N > 512 (DINOv2 at 518 px, 1370 tokens): LayerNorm, the
    q/k/v projections as one plain product, the flash-attention kernel
    reading q, k, v as strided views of it, then the o-projection.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import KERNELS
from .layers import Linear, layernorm


class Attention(nn.Module):
    """q/k/v/o projections, each ``w`` [dim, dim] and ``b`` [dim]."""

    def __init__(self, gen, dim: int, *, bias: bool = True):
        super().__init__()
        self.q = Linear(gen, dim, dim, bias=bias)
        self.k = Linear(gen, dim, dim, bias=bias)
        self.v = Linear(gen, dim, dim, bias=bias)
        self.o = Linear(gen, dim, dim, bias=bias)


def mha(p: Attention, x, *, num_heads: int, ln=None, ln_eps: float = 1e-5, residual=None,
        mask=None, key_padding_bias=None, causal: bool = False, ops=KERNELS):
    """``[residual +] o(attention(q, k, v))`` with ``q, k, v = LN(x) W + b``.

    x [B, N, D]; frozen projections and LayerNorm (the kernels give no
    weight gradients). The routes are the module docstring's; every other
    route of the JAX ``mha`` raises.
    """
    if ln is None or mask is not None or causal or "lora" in p._modules:
        raise NotImplementedError(
            "mha: only the LayerNorm routes without LoRA, mask or causal attention are "
            "ported to the PyTorch package yet (ROADMAP.md, section A, items 3 and 4)")
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
