"""MONA adapters, 4 variants, eval and train mode (counterpart of
nextgen_uia_tpu/adapters/mona.py).

With input x [B, N, D]:

    z  = LN(x) * gamma + x * gammax          (LN eps 1e-5)
    z  = z @ W_down                          (D -> c)
    cls, s = split(z); s -> [B, h, w, c]
    s  = MonaOp(s)
    z  = dropout(GELU(concat(cls, s)), 0.1) @ W_up       (dropout: train mode)
    out = x + z

MonaOp follows the JAX package's accelerator branch (``_mona_op`` on TPU):
the three depthwise kernels (3/5/7) are zero-embedded into one 7x7 kernel;
the noise-aware variants fold their per-sample softmax branch weights into
per-sample kernels and biases (in float32, then cast to s.dtype), the
shared-kernel variants broadcast the mean kernel and bias; the per-channel
frequency filter is the scale ``freq`` (irfft2(rfft2(s) * f_c) == s * f_c);
then ``y = mona_spatial(s, freq, kernels, bias)`` (ops/dwconv.py, which
autograd differentiates through its backward kernel) and ``y + pw(y)``.

With ``NEXTGEN_UIA_FUSED_MONA=1`` (``mona_fused_opted_in``, the JAX
package's opt-in) the whole adapter runs as one op,
``ops.mona_block_fused`` (ops/fused_mona.py: K12 on a CUDA tensor, its
plain version on a CPU tensor), with the dropout mask drawn here by the
call the composed route makes, so both routes see one stream under one
generator. Where that op declines (no CLS row, parameters that do not match
the variant) the composed route runs. The default is the composed route,
as in the JAX package.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (Conv, LayerNorm, Linear, dropout, dropout_mask, gelu, layernorm, linear,
                         param)
from ..ops import KERNELS

VARIANTS = ("baseline", "noise_aware", "freq_enhanced", "hybrid")
_HAS_FREQ = {"freq_enhanced", "hybrid"}
_HAS_NOISE = {"noise_aware", "hybrid"}


class Mona(nn.Module):
    """``mona_init``: one adapter's parameters."""

    def __init__(self, gen, dim: int, bottleneck: int = 64, variant: str = "hybrid"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"Unknown MONA variant: {variant!r}; choose from {VARIANTS}")
        c = bottleneck
        self.norm = LayerNorm(dim)
        self.gamma = param(torch.full((dim,), 1e-6))
        self.gammax = param(torch.ones(dim))
        self.down = Linear(gen, dim, c)
        self.up = Linear(gen, c, dim)
        self.conv3 = Conv(gen, 3, 3, c, c, groups=c)
        self.conv5 = Conv(gen, 5, 5, c, c, groups=c)
        self.conv7 = Conv(gen, 7, 7, c, c, groups=c)
        self.pw = Conv(gen, 1, 1, c, c)
        if variant in _HAS_FREQ:
            self.freq_filter = param(torch.ones(c))
        if variant in _HAS_NOISE:
            self.noise_est = nn.Module()
            self.noise_est.fc1 = Linear(gen, c, c // 4)
            self.noise_est.fc2 = Linear(gen, c // 4, 3)


def _embed_k(w):
    """Zero-embed a [k, k, 1, C] depthwise kernel into [7, 7, C]."""
    pad = (7 - w.shape[0]) // 2
    return F.pad(w[:, :, 0, :], (0, 0, pad, pad, pad, pad))


def _mona_op(p: Mona, s, variant: str, ops=KERNELS):
    """Variant-specific spatial op on s [B, h, w, c]."""
    b, c = s.shape[0], s.shape[-1]
    f32 = torch.float32
    freq = (p.freq_filter if variant in _HAS_FREQ
            else torch.ones(c, dtype=f32, device=s.device))
    stacked_k = torch.stack([_embed_k(p.conv3.w), _embed_k(p.conv5.w), _embed_k(p.conv7.w)])
    stacked_b = torch.stack([p.conv3.b, p.conv5.b, p.conv7.b])  # [3, c]
    if variant in _HAS_NOISE:
        # the GAP commutes with the frequency scale: mean(s * f) = mean(s) * f
        pooled = s.to(f32).mean(dim=(1, 2)) * freq.to(f32)
        ne = p.noise_est
        wts = torch.softmax(linear(ne.fc2, torch.relu(linear(ne.fc1, pooled))), dim=-1)
        kernels = torch.einsum("bs,shwc->bhwc", wts, stacked_k)
        bias = wts @ stacked_b
    else:
        kernels = stacked_k.mean(0).expand(b, 7, 7, c)
        bias = stacked_b.mean(0).expand(b, c)
    dt = s.dtype
    y = ops.mona_spatial(s.contiguous(), freq.to(dt).contiguous(),
                         kernels.to(dt).contiguous(), bias.to(dt).contiguous())
    proj = y @ p.pw.w[0, 0].to(dt) + p.pw.b.to(dt)  # 1x1 conv over channels
    return y + proj


def mona_fused_opted_in() -> bool:
    """Whether MONA runs as one fused op (``NEXTGEN_UIA_FUSED_MONA=1``)
    rather than the composed route, the default; the one place that reads
    it."""
    return os.environ.get("NEXTGEN_UIA_FUSED_MONA") == "1"


def mona_apply(p: Mona, x, hw, *, variant: str, ops=KERNELS, gen=None, mask=None):
    """Apply a MONA adapter to token sequence x [B, N, D].

    N = h*w + 1 (CLS first), h*w (no CLS), or h*w + 1 + pad (the trailing
    rows take the CLS path: channel mixing only). Train mode applies dropout
    (rate 0.1) after the GELU, with a mask drawn from the generator ``gen``
    or the pre-scaled ``mask`` [B, N, bottleneck] given; with neither it is
    the eval forward.
    """
    b, n, _ = x.shape
    h, w = hw
    if mona_fused_opted_in():
        if mask is None and gen is not None:
            mask = dropout_mask(gen, 0.1, (b, n, p.down.w.shape[1]), device=x.device)
        out = ops.mona_block_fused(p, x, hw, variant=variant, mask=mask)
        if out is not None:
            return out
    z = layernorm(p.norm, x) * p.gamma.to(x.dtype) + x * p.gammax.to(x.dtype)
    z = linear(p.down, z, dtype=x.dtype)  # [B, N, c]
    c = z.shape[-1]
    if n >= h * w + 1:
        sp = _mona_op(p, z[:, 1:1 + h * w].reshape(b, h, w, c), variant, ops)
        z = torch.cat([z[:, :1], sp.reshape(b, h * w, c), z[:, 1 + h * w:]], dim=1)
    else:
        z = _mona_op(p, z.reshape(b, h, w, c), variant, ops).reshape(b, n, c)
    z = dropout(gelu(z), 0.1, gen=gen, mask=mask)
    z = linear(p.up, z, dtype=x.dtype)
    return x + z


def inject_mona(gen, vit, *, dim: int, bottleneck: int = 64, variant: str = "hybrid",
                num_layers: int | None = None):
    """Add a ``mona`` adapter to the first ``num_layers`` blocks of ``vit``
    (all when None), in place. Returns (vit, count)."""
    blocks = vit.blocks
    n = len(blocks) if num_layers is None else min(num_layers, len(blocks))
    for blk in list(blocks)[:n]:
        blk.mona = Mona(gen, dim, bottleneck, variant)
    return vit, n
