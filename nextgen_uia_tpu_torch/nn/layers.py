"""Layer parameters and functions (counterpart of nextgen_uia_tpu/nn/layers.py).

Parameters live in small ``nn.Module`` containers whose attribute names are
the JAX package's dict keys; the apply functions are plain functions over
(module, tensor), as in the JAX package. Parameters are float32; compute may
run in bfloat16 by passing ``dtype``. LayerNorm statistics always run in
float32.

Layouts are the JAX package's: Linear ``w`` is [in, out], conv ``w`` is HWIO
([kh, kw, in_per_group, out]). Random init draws from a CPU
``torch.Generator``: the streams differ from jax.random, so cross-framework
comparisons go through the weight bridge (core/checkpoint.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def param(t: torch.Tensor) -> nn.Parameter:
    """A float32 parameter, frozen until a trainer marks it trainable
    (core/partition.py::set_trainable): serving runs without gradients, and
    the frozen-weight block kernels refuse weights that train."""
    return nn.Parameter(t.to(torch.float32), requires_grad=False)


class Linear(nn.Module):
    """``linear_init``: torch nn.Linear's default bounds (1/sqrt(fan_in)), or
    a normal weight of ``std``; ``w`` [in, out], ``b`` [out]."""

    def __init__(self, gen, in_dim: int, out_dim: int, *, bias: bool = True,
                 std: float | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.w = param(uniform(gen, (in_dim, out_dim), bound) if std is None
                       else normal(gen, (in_dim, out_dim), std))
        self.b = param(uniform(gen, (out_dim,), bound)) if bias else None


def linear(p: Linear, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """``x @ w + b``. With ``dtype`` both operands are cast to it; without,
    they meet in the promoted type (bf16 activations x f32 weights -> f32,
    as jnp promotes)."""
    w = p.w
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


class LayerNorm(nn.Module):
    """``layernorm_init``: scale ones, bias zeros."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = param(torch.ones(dim))
        self.bias = param(torch.zeros(dim))


def layernorm(p: LayerNorm, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) - OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}


class Conv(nn.Module):
    """``conv_init``: HWIO weight and bias, torch nn.Conv2d's default bounds."""

    def __init__(self, gen, kh: int, kw: int, in_ch: int, out_ch: int, *, groups: int = 1):
        super().__init__()
        bound = 1.0 / math.sqrt(kh * kw * (in_ch // groups))
        self.w = param(uniform(gen, (kh, kw, in_ch // groups, out_ch), bound))
        self.b = param(uniform(gen, (out_ch,), bound))


def dropout_mask(gen: torch.Generator, rate: float, shape, device=None) -> torch.Tensor:
    """Pre-scaled dropout mask (0 or 1/keep), float32, drawn from ``gen``
    (a generator on ``device``). The stream is torch's, not jax.random's:
    tests that compare with the JAX package hand both the same mask."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=gen, device=device)
    return (u < keep).to(torch.float32) / keep


def dropout(x: torch.Tensor, rate: float, *, gen: torch.Generator | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout: ``x * mask`` with a given pre-scaled mask, else a
    mask drawn from ``gen``; identity without either (eval mode) or at
    rate 0."""
    if mask is None:
        if gen is None or rate <= 0.0:
            return x
        mask = dropout_mask(gen, rate, x.shape, device=x.device)
    return (x * mask.to(x.device)).to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of an NHWC batch, align_corners=False (half-pixel)
    semantics without antialiasing - jax.image.resize's 'bilinear' for the
    upsampling the heads do."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
