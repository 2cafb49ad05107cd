"""Attention parameters and the composed self-attention (counterpart of
nextgen_uia_tpu/nn/attention.py's ``attention_init`` and ``mha``).

The serving path's attention lives in the whole-block kernel
(ops/fused_block.py). ``mha`` ports the one route the train step takes: the
pre-attention LayerNorm and the residual handed in, no LoRA, no mask, which
is the LN+QKV kernel then the attention+o-projection+residual kernel.
"""

from __future__ import annotations

from torch import nn

from ..ops import KERNELS
from .layers import Linear


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
    """``residual + o(attention(q, k, v))`` with ``q, k, v = LN(x) W + b``.

    x [B, N, D]. Only the ``ln=`` + ``residual=`` route is ported, through
    ``ops.fused_ln_qkv`` and ``ops.fused_attn_o_residual`` (the frozen-tower
    kernels: the projections and LayerNorm do not train). Every other route
    of the JAX ``mha`` raises.
    """
    if ln is None or residual is None or mask is not None or causal or "lora" in p._modules:
        raise NotImplementedError(
            "mha: only the LayerNorm + residual route without LoRA, mask or causal "
            "attention is ported to the PyTorch package yet (ROADMAP.md, section A, "
            "items 3 and 4)")
    q, k, v = ops.fused_ln_qkv(x, ln, p, heads=num_heads, eps=ln_eps)
    return ops.fused_attn_o_residual(q, k, v, residual, p.o, heads=num_heads,
                                     bias=key_padding_bias)
