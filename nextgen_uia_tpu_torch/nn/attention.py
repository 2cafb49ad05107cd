"""Attention parameters (counterpart of nextgen_uia_tpu/nn/attention.py's
``attention_init``). The forward lives in ops/fused_block.py for the serving
path; the composed ``mha`` comes with training."""

from __future__ import annotations

from torch import nn

from .layers import Linear


class Attention(nn.Module):
    """q/k/v/o projections, each ``w`` [dim, dim] and ``b`` [dim]."""

    def __init__(self, gen, dim: int, *, bias: bool = True):
        super().__init__()
        self.q = Linear(gen, dim, dim, bias=bias)
        self.k = Linear(gen, dim, dim, bias=bias)
        self.v = Linear(gen, dim, dim, bias=bias)
        self.o = Linear(gen, dim, dim, bias=bias)
