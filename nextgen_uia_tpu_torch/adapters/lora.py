"""LoRA adapters as parameter slots (counterpart of
nextgen_uia_tpu/adapters/lora.py).

In the [in, out] weight layout a pair is ``a`` [in, r] (uniform in
+-1/sqrt(in): torch's kaiming_uniform_(a=sqrt(5)) on the reference's A) and
``b`` [r, out] (zeros), and the update is ``(x @ a) @ b * alpha / sqrt(r)``,
added inline by nn/attention.py::mha when an attention module holds a
``lora`` module with ``q``/``k``/``v``/``o`` pairs. The pairs draw from an
explicit ``torch.Generator``; comparisons with the JAX package cross the
weights over through the ``.npz`` bridge.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import param, uniform

TARGETS = ("q", "k", "v", "o")


class LoraPair(nn.Module):
    """``lora_pair_init``: a [in, r] uniform in +-1/sqrt(in), b [r, out] zeros."""

    def __init__(self, gen, in_dim: int, out_dim: int, r: int):
        super().__init__()
        self.a = param(uniform(gen, (in_dim, r), 1.0 / math.sqrt(in_dim)))
        self.b = param(torch.zeros(r, out_dim))


def _inject(gen, layers, *, dim, r, targets, num_layers):
    n = len(layers) if num_layers is None else min(num_layers, len(layers))
    for layer in list(layers)[:n]:
        layer.attn.lora = nn.Module()
        for t in targets:
            setattr(layer.attn.lora, t, LoraPair(gen, dim, dim, r))
    return n


def inject_lora(gen, vit, *, dim: int, r: int = 16, targets=TARGETS,
                num_layers: int | None = None):
    """Add a ``lora`` module with one pair per target to the attention of
    the first ``num_layers`` blocks of ``vit`` (all when None), in place.
    Returns (vit, count)."""
    return vit, _inject(gen, vit.blocks, dim=dim, r=r, targets=targets, num_layers=num_layers)


def inject_lora_bert(gen, bert, *, dim: int, r: int = 16, targets=TARGETS,
                     num_layers: int | None = None):
    """Add a ``lora`` module with one pair per target to the self-attention
    of the first ``num_layers`` layers of the BERT text tower (all when
    None), in place: the reference's --tune_text_encoder path (query, key,
    value and the attention output of the first layers). Returns (bert,
    count)."""
    return bert, _inject(gen, bert.layers, dim=dim, r=r, targets=targets,
                         num_layers=num_layers)
