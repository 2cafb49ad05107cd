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

import functools
import math

import numpy as np
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
    """``conv_init``: HWIO weight and bias (``bias=False``: none, as OpenAI
    CLIP's patch embedding), torch nn.Conv2d's default bounds."""

    def __init__(self, gen, kh: int, kw: int, in_ch: int, out_ch: int, *, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(kh * kw * (in_ch // groups))
        self.w = param(uniform(gen, (kh, kw, in_ch // groups, out_ch), bound))
        self.b = param(uniform(gen, (out_ch,), bound)) if bias else None


class Embedding(nn.Module):
    """``embedding_init``: ``w`` [vocab, dim], normal of ``std``."""

    def __init__(self, gen, vocab: int, dim: int, *, std: float = 0.02):
        super().__init__()
        self.w = param(normal(gen, (vocab, dim), std))


def embedding(p: Embedding, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Rows of ``w`` at integer ``ids``; ids outside the vocabulary are
    clamped to its ends (jnp.take's mode='clip')."""
    w = p.w if dtype is None else p.w.to(dtype)
    return F.embedding(ids.long().clamp(0, w.shape[0] - 1), w)


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


def conv2d(p: Conv, x: torch.Tensor, *, stride: int = 1, padding="same",
           dtype=None) -> torch.Tensor:
    """NHWC x, HWIO weight; returns NHWC. ``padding``: "same" (stride 1
    only: torch refuses it strided), "valid", or an int on every side, as
    the JAX package's explicit ((p, p), (p, p)). No bias added where ``p``
    has none."""
    w = p.w
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if p.b is None else y + p.b.to(y.dtype)


def conv2d_cat(p: Conv, x: torch.Tensor, sk: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """``conv2d(p, cat([x, sk], -1))`` without the concat: the kernel split
    along its input channels, the two partial convolutions summed."""
    c = x.shape[-1]
    w = p.w if dtype is None else p.w.to(dtype)
    xx, ss = (x, sk) if dtype is None else (x.to(dtype), sk.to(dtype))
    y = F.conv2d(xx.permute(0, 3, 1, 2), w[:, :, :c].permute(3, 2, 0, 1), padding="same")
    y = y + F.conv2d(ss.permute(0, 3, 1, 2), w[:, :, c:].permute(3, 2, 0, 1), padding="same")
    y = y.permute(0, 2, 3, 1)
    return y if p.b is None else y + p.b.to(y.dtype)


def max_pool(x: torch.Tensor, k: int, stride: int, pad: int = 0) -> torch.Tensor:
    """k x k max pool of ``stride`` over NHWC, padded by ``pad`` with -inf:
    jax.lax.reduce_window's max over -inf padding ('VALID' at pad 0, odd
    sizes floored)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, pad).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(k) over NHWC: kernel = stride = k, no padding (the JAX
    package's 'VALID' window sum over k * k); the identity at k <= 1."""
    if k <= 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def conv_transpose2d(p: Conv, x: torch.Tensor, *, stride: int, dtype=None) -> torch.Tensor:
    """torch ConvTranspose2d semantics on NHWC with the JAX package's weight
    [kh, kw, in, out] (torch's [in, out, kh, kw] is its transpose(2, 3, 0, 1))."""
    w = p.w
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    return y + p.b.to(y.dtype)


class BatchNorm(nn.Module):
    """``batchnorm_init``'s parameters: scale ones, bias zeros."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = param(torch.ones(dim))
        self.bias = param(torch.zeros(dim))


class BatchNormState(nn.Module):
    """``batchnorm_init``'s running statistics: buffers ``mean`` (zeros) and
    ``var`` (ones), saved beside the parameters but never trained."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))


def batchnorm(p: BatchNorm, state: BatchNormState, x: torch.Tensor, *, train: bool,
              momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Channel-last BatchNorm. Train mode normalizes by the batch statistics
    (differentiable) and updates ``state`` in place with the unbiased
    variance, as the JAX package's returned state; eval mode uses ``state``."""
    x32 = x.to(torch.float32)
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x32.mean(axes)
        var = x32.var(axes, unbiased=False)
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            state.mean.copy_((1 - momentum) * state.mean + momentum * mean)
            state.var.copy_((1 - momentum) * state.var + momentum * (var * n / max(n - 1, 1)))
    else:
        mean, var = state.mean, state.var
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def _bilinear_ac_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] taps of torch bilinear align_corners=True."""
    dst = np.arange(n_out, dtype=np.float64)
    src = dst * 0.0 if (n_out == 1 or n_in == 1) else dst * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = src - i0
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), (1.0 - t).astype(np.float32))
    np.add.at(m, (rows, i1), t.astype(np.float32))
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch ``nn.Upsample(mode='bilinear', align_corners=True)`` on NHWC, as
    two float32 products with static tap matrices."""
    (h_in, w_in), (h_out, w_out) = x.shape[1:3], out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    dt, y = x.dtype, x.to(torch.float32)
    if h_in != h_out:
        m = torch.from_numpy(_bilinear_ac_matrix(h_in, h_out)).to(x.device)
        y = torch.einsum("oi,biwc->bowc", m, y)
    if w_in != w_out:
        m = torch.from_numpy(_bilinear_ac_matrix(w_in, w_out)).to(x.device)
        y = torch.einsum("oi,bhic->bhoc", m, y)
    return y.to(dt)


def triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    """jax.image's 'bilinear' (triangle) kernel."""
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """jax.image's 'bicubic' kernel: Keys cubic with a = -0.5 (torch's
    bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def scale_translate_weights(n_in: int, n_out: int, inv_scale: torch.Tensor,
                            translation: torch.Tensor, kernel) -> torch.Tensor:
    """[n, n_in, n_out] float32 weight matrices of jax.image.scale_and_translate
    with antialias on, one per entry of ``inv_scale`` (1 / scale) and
    ``translation`` [n] (the formula of jax._src.image.scale.compute_weight_mat):
    when downsampling the kernel is widened by 1 / scale; the weights are
    renormalized where taps fall outside the input, and zero for samples
    outside it."""
    f32 = torch.float32
    dev = inv_scale.device
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=f32, device=dev)[None, :] + 0.5) * inv_scale[:, None]
              - (translation * inv_scale)[:, None] - 0.5)                  # [n, out]
    src = torch.arange(n_in, dtype=f32, device=dev)
    w = kernel((sample[:, None, :] - src[None, :, None]).abs()
               / kernel_scale[:, None, None])                                # [n, in, out]
    total = w.sum(1, keepdim=True)
    zero = torch.zeros((), dtype=f32, device=dev)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, zero)


@functools.lru_cache(maxsize=16)
def _bicubic_aa_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize(method='bicubic') with its
    default antialias=True; jax.image.resize takes 1 / scale of a Python
    float, rounded to float32 once. Always a real CPU tensor, computed
    outside any tracing mode: a trace (torch.export) that first meets a
    size must not leave a fake tensor in the cache for later eager calls."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        inv = torch.tensor([1.0 / (n_out / n_in)], dtype=torch.float32)
        return scale_translate_weights(n_in, n_out, inv, torch.zeros(1), keys_cubic_kernel)[0]


def resize_bicubic(x: torch.Tensor, out_hw) -> torch.Tensor:
    """jax.image.resize(x, ..., 'bicubic') on NHWC float32 (antialiased when
    downsampling; not torch's bicubic, whose a is -0.75 and which does not
    widen the kernel), as two products."""
    (h_in, w_in), (h_out, w_out) = x.shape[1:3], out_hw
    y = x
    if h_in != h_out:
        m = _bicubic_aa_matrix(h_in, h_out).to(x.device, x.dtype)
        y = torch.einsum("io,biwc->bowc", m, y)
    if w_in != w_out:
        m = _bicubic_aa_matrix(w_in, w_out).to(x.device, x.dtype)
        y = torch.einsum("io,bhic->bhoc", m, y)
    return y
