"""Attention + o-projection + residual with a frozen o-projection
(counterpart of nextgen_uia_tpu/ops/fused_attn_o.py::fused_attn_o_residual,
pre-norm, ``post_ln=None``):

    out = x + concat_h(softmax(q k^T / sqrt(dh) + bias) v) @ Wo + bo

Backward gives dq, dk, dv and d(x) = g; Wo and bo are frozen, as in the JAX
kernel's custom VJP. ``fused_attn_o_residual`` is differentiable in q, k, v
and x: on a CUDA tensor its forward and backward launch the hand-written
kernels of csrc/fused_attn_o.cu (counted in ``fused_attn_o_residual.launches``
and ``fused_attn_o_residual_backward.launches``); on a CPU tensor they run
the plain versions below. The backward recomputes the probabilities from the
saved q, k, v.

The kernels run the flash-attention kernels (K7, ops/flash_attention.py)
and, in bf16, the Hopper GEMM core, through the layouts ``_layout`` gives
(q, k, v, o, doh and the gradients head-major, the head concat row-major
[B*N, D]), with keys >= n_real folded into the float32 key bias
(``_key_bias``) and the o-projection's weight transposed once per call
(``_kernel_weights``); the CPU tests compose the plain versions through the same
helpers. A bf16 call needs head dim 64; float32 takes 1..64; the width is a
multiple of 64.

With ``post_ln`` (BERT's post-norm layout) the output is LayerNormed:

    out = LN(x + concat_h(softmax(q k^T / sqrt(dh) + bias) v) @ Wo + bo)

with the pre-LN sum in float32 until the LayerNorm. On a CUDA tensor
``fused_attn_o_residual_postln`` launches its forward kernel (counted in
``fused_attn_o_residual_postln.launches``). Its backward (dq, dk, dv, dx) is
autograd through the plain version recomputed from the saved inputs, as the
JAX kernel's ``_bwd_rule`` differentiates its XLA recomposition: plain
PyTorch on the card, no kernel of its own.
"""

from __future__ import annotations

import math

import torch

from . import build
from ._frozen import _cat, check_frozen, layernorm_parts, plain_backward
from .flash_attention import NEG_INF


def _weights(o, dt):
    """(Wo [D, D] as stored in dt, bo [D] float32)."""
    return (o.w.detach().to(dt).contiguous(),
            o.b.detach().to(torch.float32).contiguous())


def _kernel_weights(o, dt):
    """(Wo^T [D, D] in dt, bo [D] float32) as the forward kernel takes them:
    its o-product reads the weight as [cols, K]."""
    return _cat([o.w.T], dt), o.b.detach().to(torch.float32).contiguous()


def _layout(b, n, heads, dh):
    """The element strides (batch, head, token; the head dim contiguous)
    through which the kernels address their operands: q, k, v, o, doh and
    dq, dk, dv as dense head-major [B, H, N, dh], and the forward's head
    concat as row-major [B*N, D] (head h of token n of image b at row
    b*N + n, columns h*dh..). Returns (head-major strides, concat strides),
    as the wrappers pass them to csrc/fused_attn_o.cu."""
    d = heads * dh
    return (heads * n * dh, n * dh, dh), (n * d, dh, d)


def _key_bias(bias, b, n, n_real, device):
    """The float32 [B, N] key bias the attention kernels take: the caller's
    bias (or zeros) plus -1e30 on keys >= n_real, the JAX kernel's padding
    mask; None when there is neither."""
    if bias is None and n_real >= n:
        return None
    kb = (torch.zeros(b, n, device=device) if bias is None
          else bias.detach().to(device=device, dtype=torch.float32).clone())
    kb[:, n_real:] += NEG_INF
    return kb.contiguous()


def _probs(q, k, bias, n_real):
    """float32 softmax(q k^T / sqrt(dh)), keys >= n_real masked, bias added."""
    f32 = torch.float32
    n = q.shape[2]
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    col = torch.arange(n, device=q.device)
    s = torch.where(col >= n_real, torch.full_like(s, -1e30), s)
    if bias is not None:
        s = s + bias.to(f32)[:, None, None, :]
    return torch.softmax(s, dim=-1)


def fused_attn_o_residual_plain(q, k, v, x, o, *, heads: int, bias=None,
                                n_real: int | None = None, post_ln=None,
                                ln_eps: float = 1e-12):
    """Plain PyTorch version, differentiable by autograd: float32 scores,
    softmax and products; the probabilities and the head concat rounded to
    x.dtype, the sum (with ``post_ln``: its LayerNorm, float32 statistics)
    rounded once (the kernel's rounding points)."""
    b, h, n, dh = q.shape
    dt, f32 = x.dtype, torch.float32
    p = _probs(q, k, bias, n if n_real is None else n_real).to(dt)
    cat = (p.to(f32) @ v.to(f32)).transpose(1, 2).reshape(b, n, h * dh).to(dt)
    y = cat.to(f32) @ o.w.to(dt).to(f32) + o.b.to(f32) + x.to(f32)
    if post_ln is not None:
        y = layernorm_parts(y, ln_eps)[0] * post_ln.scale + post_ln.bias
    return y.to(dt)


def fused_attn_o_residual_backward_plain(q, k, v, wo, g, *, bias=None,
                                         n_real: int | None = None):
    """Plain (dq, dk, dv) of the JAX kernel's ``_bwd_kernel``: doh = g @ Wo^T
    rounded to q.dtype; P recomputed in float32; dv = round(P)^T doh,
    dp = doh v^T, ds = round(P * (dp - rowsum(dp * P)) / sqrt(dh)),
    dq = ds k, dk = ds^T q, each rounded to q.dtype."""
    b, h, n, dh = q.shape
    dt, f32 = q.dtype, torch.float32
    doh = (g.to(dt).to(f32) @ wo.to(dt).to(f32).T).to(dt)
    doh = doh.reshape(b, n, h, dh).transpose(1, 2).to(f32)
    p = _probs(q, k, bias, n if n_real is None else n_real)
    dv = p.to(dt).to(f32).transpose(-1, -2) @ doh
    dp = doh @ v.to(f32).transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dh)).to(dt).to(f32)
    dq = ds @ k.to(f32)
    dk = ds.transpose(-1, -2) @ q.to(f32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda(q, x, bias, n_real):
    b, h, n, dh = q.shape
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if (h * dh) % 64:
        problems.append(f"width {h * dh} with {h} heads (width % 64 == 0)")
    if (x.dtype == torch.bfloat16 and dh != 64) or not 1 <= dh <= 64:
        problems.append(f"head dim {dh} (bfloat16: 64; float32: 1..64)")
    if not 0 < n_real <= n:
        problems.append(f"n_real {n_real}")
    if bias is not None and (tuple(bias.shape) != (b, n) or bias.device != x.device):
        problems.append(f"bias {tuple(bias.shape)} on {bias.device}")
    if problems:
        raise ValueError(f"fused_attn_o_residual CUDA kernel does not take q {tuple(q.shape)}: "
                         + "; ".join(problems))


def _check_postln_cuda(q, x, bias, n_real):
    b, h, n, dh = q.shape
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if (h * dh) % 64 or dh % 4 or not 32 <= dh <= 64:
        problems.append(f"width {h * dh} with {h} heads (width % 64 == 0, head dim 32..64)")
    if not 1 <= n <= 256:
        problems.append(f"{n} tokens (1..256)")
    if not 0 < n_real <= n:
        problems.append(f"n_real {n_real}")
    if bias is not None and (tuple(bias.shape) != (b, n) or bias.device != x.device):
        problems.append(f"bias {tuple(bias.shape)} on {bias.device}")
    if problems:
        raise ValueError("fused_attn_o_residual_postln CUDA kernel does not take: "
                         + "; ".join(problems))


def _bias_arg(bias):
    return None if bias is None else bias.detach().to(torch.float32).contiguous()


def _forward_cuda(q, k, v, x, wo_t, bo, bias, n_real):
    b, h, n, dh = q.shape
    _check_cuda(q, x, bias, n_real)
    dt, d, dev = x.dtype, h * dh, x.device
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    x = x.contiguous()
    strides, cat_strides = _layout(b, n, h, dh)
    cat = torch.empty(b * n, d, device=dev, dtype=dt)
    out = torch.empty(b, n, d, device=dev, dtype=dt)
    kb = _key_bias(bias, b, n, n_real, dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_attn_o_fwd(
            build.ptr(q, "q"), build.ptr(k, "k"), build.ptr(v, "v"), build.ptr(x, "x"),
            build.ptr(kb), build.ptr(wo_t), build.ptr(bo), build.ptr(cat), build.ptr(out),
            build.DTYPE_CODES[dt], b, n, h, dh, *strides, *cat_strides, 1.0 / math.sqrt(dh),
            build.stream(dev)), "fused_attn_o_residual")
    fused_attn_o_residual.launches += 1
    return out


def _postln_cuda(q, k, v, x, wo, bo, gamma, beta, bias, n_real, eps):
    b, h, n, dh = q.shape
    _check_postln_cuda(q, x, bias, n_real)
    dt, d = x.dtype, h * dh
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    x = x.contiguous()
    cat = torch.empty(b * n, d, device=x.device, dtype=dt)
    y32 = torch.empty(b * n, d, device=x.device, dtype=torch.float32)
    out = torch.empty(b, n, d, device=x.device, dtype=dt)
    kb = _bias_arg(bias)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_attn_o_postln_fwd(
            build.ptr(q, "q"), build.ptr(k, "k"), build.ptr(v, "v"), build.ptr(x, "x"),
            build.ptr(kb), build.ptr(wo), build.ptr(bo), build.ptr(gamma), build.ptr(beta),
            build.ptr(cat), build.ptr(y32), build.ptr(out), build.DTYPE_CODES[dt], b, n, h, dh,
            n_real, 1.0 / math.sqrt(dh), eps, build.stream(x.device)),
            "fused_attn_o_residual_postln")
    fused_attn_o_residual_postln.launches += 1
    return out


def fused_attn_o_residual_postln(q, k, v, x, o, ln, *, heads: int, bias=None,
                                 n_real: int | None = None, eps: float = 1e-12):
    """LN(x + Wo(attention(q, k, v)) + bo), the post-norm epilogue; the
    kernel on a CUDA tensor (its backward autograd through the plain
    version), the plain version on a CPU tensor."""
    n_real = q.shape[2] if n_real is None else n_real
    if x.device.type == "cpu":
        return fused_attn_o_residual_plain(q, k, v, x, o, heads=heads, bias=bias,
                                           n_real=n_real, post_ln=ln, ln_eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_o_residual_postln: unsupported device {x.device}")
    wo, bo = _weights(o, x.dtype)
    gamma, beta = (t.detach().to(torch.float32).contiguous() for t in (ln.scale, ln.bias))
    return plain_backward(
        lambda *t: _postln_cuda(*t, wo, bo, gamma, beta, bias, n_real, eps),
        lambda *t: fused_attn_o_residual_plain(*t, o, heads=heads, bias=bias, n_real=n_real,
                                               post_ln=ln, ln_eps=eps), q, k, v, x)


def fused_attn_o_residual_backward(q, k, v, wo, g, *, bias=None, n_real: int | None = None):
    """(dq, dk, dv) for the output gradient g: on a CUDA tensor the
    backward kernels of csrc/fused_attn_o.cu (counted in
    ``fused_attn_o_residual_backward.launches``), on a CPU tensor
    ``fused_attn_o_residual_backward_plain``."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else n_real
    if q.device.type == "cpu":
        return fused_attn_o_residual_backward_plain(q, k, v, wo, g, bias=bias, n_real=n_real)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attn_o_residual: unsupported device {q.device}")
    dt, dev = q.dtype, q.device
    _check_cuda(q, q, bias, n_real)
    q, k, v = (t.contiguous() for t in (q, k, v))
    g, wo = g.to(dt).contiguous(), wo.to(dt).contiguous()
    strides, _ = _layout(b, n, h, dh)
    o, doh, dq, dk, dv = (torch.empty_like(q) for _ in range(5))
    lse, delta = (torch.empty(b, h, n, device=dev, dtype=torch.float32) for _ in range(2))
    kb = _key_bias(bias, b, n, n_real, dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_attn_o_bwd(
            build.ptr(q, "q"), build.ptr(k, "k"), build.ptr(v, "v"), build.ptr(kb),
            build.ptr(wo), build.ptr(g, "g"), build.ptr(o), build.ptr(doh), build.ptr(lse),
            build.ptr(delta), build.ptr(dq), build.ptr(dk), build.ptr(dv),
            build.DTYPE_CODES[dt], b, n, h, dh, *strides, 1.0 / math.sqrt(dh),
            build.stream(dev)), "fused_attn_o_residual backward")
    fused_attn_o_residual_backward.launches += 1
    return dq, dk, dv


class _FusedAttnO(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, x, o, heads, bias, n_real):
        ctx.save_for_backward(q, k, v)
        ctx.o, ctx.bias, ctx.n_real = o, bias, n_real
        if x.device.type == "cpu":
            return fused_attn_o_residual_plain(q, k, v, x, o, heads=heads, bias=bias,
                                               n_real=n_real)
        if x.device.type != "cuda":
            raise ValueError(f"fused_attn_o_residual: unsupported device {x.device}")
        return _forward_cuda(q, k, v, x, *_kernel_weights(o, x.dtype), bias, n_real)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        wo, _ = _weights(ctx.o, q.dtype)
        dq, dk, dv = fused_attn_o_residual_backward(q, k, v, wo, g, bias=ctx.bias,
                                                    n_real=ctx.n_real)
        return dq, dk, dv, g, None, None, None, None


def fused_attn_o_residual(q, k, v, x, o, *, heads: int, bias=None,
                          n_real: int | None = None, post_ln=None, ln_eps: float = 1e-12):
    """(q, k, v [B, H, N, dh], x [B, N, D]) -> x + Wo(attention(q, k, v)) + bo,
    LayerNormed with ``post_ln`` (``fused_attn_o_residual_postln``).

    bias: optional additive [B, N] key bias (constant: no gradient); keys at
    or beyond ``n_real`` are masked. Differentiable in q, k, v and x; the
    o-projection (and the LayerNorm) are frozen (raises if one requires
    grad).
    """
    if q.shape[1] != heads:
        raise ValueError(f"fused_attn_o_residual: q has {q.shape[1]} heads, not {heads}")
    check_frozen("fused_attn_o_residual", o.w, o.b,
                 *(() if post_ln is None else (post_ln.scale, post_ln.bias)))
    n_real = q.shape[2] if n_real is None else n_real
    if post_ln is not None:
        return fused_attn_o_residual_postln(q, k, v, x, o, post_ln, heads=heads, bias=bias,
                                            n_real=n_real, eps=ln_eps)
    return _FusedAttnO.apply(q, k, v, x, o, heads, bias, n_real)


fused_attn_o_residual.launches = 0
fused_attn_o_residual_postln.launches = 0
fused_attn_o_residual_backward.launches = 0
