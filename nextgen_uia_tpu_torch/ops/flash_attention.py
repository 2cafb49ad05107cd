"""Attention for any sequence length, forward and backward (counterpart of
nextgen_uia_tpu/ops/flash_attention.py::flash_attention):

    o = softmax(q k^T / sqrt(dh) + bias[b, key], causal) v

float32 scores and softmax, the probabilities rounded to the input type
before the product with v, the output in the input type. ``layout``
'bnhd' takes q, k, v [B, N, H, dh], 'bhnd' [B, H, N, dh]; the output and
the gradients have the input's layout. On a CUDA tensor the hand-written
kernels of csrc/flash_attention.cu run (counted in
``flash_attention.launches`` and ``flash_attention_backward.launches``),
reading strided views (a packed q|k|v projection, either layout) without a
copy; the forward saves each row's log-sum-exp for the backward kernel. On
a CPU tensor ``flash_attention_plain`` and ``flash_attention_backward_plain``
run. The backward follows the JAX kernel's rounding points; the key bias
gets a gradient when ``bias_grad`` (the JAX default), else it is a
constant.
"""

from __future__ import annotations

import math

import torch

from . import build
from .registry import register

NEG_INF = -1e30


def _to_bhnd(t, layout):
    return t.transpose(1, 2) if layout == "bnhd" else t


def _scores(q, k, bias, causal):
    """float32 scaled scores [B, H, N, N] of [B, H, N, dh] q and k, masked as
    the JAX kernel masks: the bias added, then -1e30 above the diagonal when
    causal."""
    f32, n = torch.float32, q.shape[2]
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias.to(f32)[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=q.device)
        s = torch.where(pos[None, :] > pos[:, None], torch.full_like(s, NEG_INF), s)
    return s


def _probs(q, k, bias, causal):
    return torch.softmax(_scores(q, k, bias, causal), dim=-1)


def flash_attention_lse_plain(q, k, *, bias=None, causal: bool = False, layout: str = "bnhd"):
    """Each row's float32 log-sum-exp [B, H, N] of its masked, scaled scores
    (natural log): the plain version of the state the forward kernel saves
    for the backward."""
    return torch.logsumexp(_scores(_to_bhnd(q, layout), _to_bhnd(k, layout), bias, causal), -1)


def flash_attention_plain(q, k, v, *, bias=None, causal: bool = False, layout: str = "bnhd",
                          bias_grad: bool = True):
    """Plain PyTorch version, differentiable by autograd (in the bias only
    with ``bias_grad``): the JAX kernel's masking, float32 softmax, P
    rounded to q.dtype before P v."""
    dt, f32 = q.dtype, torch.float32
    if bias is not None and not bias_grad:
        bias = bias.detach()
    q, k, v = (_to_bhnd(t, layout) for t in (q, k, v))
    p = _probs(q, k, bias, causal).to(dt)
    o = (p.to(f32) @ v.to(f32)).to(dt)
    return o.transpose(1, 2) if layout == "bnhd" else o


def flash_attention_backward_plain(q, k, v, bias, g, *, causal: bool = False,
                                   layout: str = "bnhd"):
    """The JAX ``_bwd_kernel`` in PyTorch: P recomputed in float32,
    dv = round(P)^T g, dp = g v^T, ds_raw = P (dp - rowsum(dp P)),
    ds = round(ds_raw * scale), dq = ds k, dk = ds^T q, each product
    accumulated in float32 and rounded to q.dtype once. Returns (dq, dk, dv)
    in the input's layout and dbias [B, N] float32 (the sum of ds_raw over
    heads and queries; None without a bias)."""
    dt, f32 = q.dtype, torch.float32
    q, k, v, g = (_to_bhnd(t, layout) for t in (q, k, v, g))
    p = _probs(q, k, bias, causal)
    g32 = g.to(f32)
    dv = p.to(dt).to(f32).transpose(-1, -2) @ g32
    dp = g32 @ v.to(f32).transpose(-1, -2)
    ds_raw = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds_raw * (1.0 / math.sqrt(q.shape[-1]))).to(dt).to(f32)
    dq, dk = ds @ k.to(f32), ds.transpose(-1, -2) @ q.to(f32)
    grads = [t.to(dt) for t in (dq, dk, dv)]
    if layout == "bnhd":
        grads = [t.transpose(1, 2) for t in grads]
    return (*grads, None if bias is None else ds_raw.sum((1, 2)))


def _strides(t, layout):
    """(batch, head, token) element strides of a [.., dh] view, head dim
    contiguous."""
    if t.stride(-1) != 1:
        raise ValueError("flash_attention CUDA kernel needs the head dim contiguous")
    sb, s1, s2 = t.stride(0), t.stride(1), t.stride(2)
    return (sb, s1, s2) if layout == "bhnd" else (sb, s2, s1)


def _check_cuda(q, k, v, bias, layout):
    problems = []
    b, n, h, dh = q.shape if layout == "bnhd" else (q.shape[0], q.shape[2], q.shape[1],
                                                     q.shape[3])
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        problems.append(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (one of float32, bfloat16)")
    if k.shape != q.shape or v.shape != q.shape:
        problems.append(f"shapes {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if q.dtype == torch.bfloat16:
        if dh != 64:
            problems.append(f"head dim {dh} (bfloat16: 64)")
        if any(s % 8 for t in (q, k, v) for s in _strides(t, layout)):
            problems.append("bfloat16 rows not 16-byte aligned")
    elif not 1 <= dh <= 64:
        problems.append(f"head dim {dh} (float32: 1..64)")
    if len({_strides(t, layout) for t in (q, k, v)}) != 1:
        problems.append("q, k and v have different strides")
    if bias is not None and (tuple(bias.shape) != (b, n) or bias.device != q.device):
        problems.append(f"bias {tuple(bias.shape)} on {bias.device} (want [B, N])")
    if problems:
        raise ValueError("flash_attention CUDA kernel does not take: " + "; ".join(problems))
    return b, n, h, dh


def _check_aligned(*ts):
    """The bf16 kernels' 16-byte vector copies: every operand's address, a
    launch-time fact a trace does not see."""
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention CUDA kernel does not take: bfloat16 operands not "
                         "16-byte aligned")


def _key_bias(bias):
    return None if bias is None else bias.detach().to(torch.float32).contiguous()


def _bhn(q, layout):
    return (q.shape[0], q.shape[2], q.shape[1]) if layout == "bnhd" else tuple(q.shape[:3])


def _forward_cuda(q, k, v, bias, causal, layout, with_lse):
    """(out, lse [B, H, N] float32 or None) from the forward kernel, through
    the registered op ``nextgen_uia::flash_fwd``."""
    _check_cuda(q, k, v, bias, layout)
    out, lse = FLASH_FWD(q, k, v, _key_bias(bias), causal, layout, with_lse)
    return out, lse if with_lse else None


def _flash_launch(q, k, v, bias, causal, layout, with_lse):
    """The registered op: one launch of the forward kernel, counted in
    ``flash_attention.launches``; lse is empty unless ``with_lse``."""
    _check_aligned(q, k, v)
    b, n, h, dh = _check_cuda(q, k, v, bias, layout)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, h, n if with_lse else 0, device=q.device, dtype=torch.float32)
    sb, sh, sn = _strides(q, layout)
    osb, osh, osn = _strides(out, layout)
    lib = build.library()
    with torch.cuda.device(q.device):
        build.check(lib.nx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), build.ptr(bias),
            build.ptr(lse) if with_lse else None, build.DTYPE_CODES[q.dtype], b, h, n, dh, sb,
            sh, sn, osb, osh, osn, int(causal), 1.0 / math.sqrt(dh), build.stream(q.device)),
            "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _flash_shapes(q, k, v, bias, causal, layout, with_lse):
    b, h, n = _bhn(q, layout)
    return q.new_empty(q.shape), q.new_empty(b, h, n if with_lse else 0, dtype=torch.float32)


FLASH_FWD = register("flash_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? bias, bool causal, "
                     "str layout, bool with_lse) -> (Tensor, Tensor)",
                     _flash_launch, _flash_shapes)


def flash_attention_forward(q, k, v, *, bias=None, causal: bool = False, layout: str = "bnhd"):
    """(out, lse): the forward kernel's output and each row's float32
    log-sum-exp [B, H, N], the saved state ``flash_attention_backward``
    takes. CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: CUDA tensors only, got {q.device}")
    return _forward_cuda(q, k, v, bias, causal, layout, True)


def flash_attention_backward(q, k, v, out, g, lse, *, bias=None, causal: bool = False,
                             layout: str = "bnhd", bias_grad: bool = True):
    """(dq, dk, dv, dbias) for the output gradient g of ``out = attention(q,
    k, v)``: on a CUDA tensor the backward kernels of
    csrc/flash_attention.cu (``out`` and ``lse`` from the forward kernel;
    counted in ``flash_attention_backward.launches``), on a CPU tensor
    ``flash_attention_backward_plain`` (``out`` and ``lse`` unused). dbias
    [B, N] float32 when ``bias_grad`` and a bias is given, else None."""
    if q.device.type == "cpu":
        *grads, dbias = flash_attention_backward_plain(q, k, v, bias, g, causal=causal,
                                                       layout=layout)
        return (*grads, dbias if bias_grad else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, h, dh = _check_cuda(q, k, v, bias, layout)
    _check_aligned(q, k, v)
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
    ostrides = _strides(out, layout)
    if (_strides(g, layout) != ostrides or _strides(dq, layout) != ostrides
            or tuple(lse.shape) != (b, h, n) or lse.dtype != torch.float32
            or any(t.data_ptr() % 16 for t in (out, g))):
        raise ValueError("flash_attention backward: out, g and the gradients need one "
                         "16-byte aligned layout and lse [B, H, N] float32")
    if q.dtype == torch.bfloat16 and any(s % 8 for s in ostrides):
        raise ValueError("flash_attention backward: bfloat16 rows not 16-byte aligned")
    delta = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    dbias = (torch.zeros(b, n, device=q.device, dtype=torch.float32)
             if bias_grad and bias is not None else None)
    sb, sh, sn = _strides(q, layout)
    lib = build.library()
    with torch.cuda.device(q.device):
        build.check(lib.nx_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            build.ptr(lse.contiguous()), build.ptr(_key_bias(bias)), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), build.ptr(dbias), build.ptr(delta),
            build.DTYPE_CODES[q.dtype], b, h, n, dh, sb, sh, sn, *ostrides, int(causal),
            1.0 / math.sqrt(dh), build.stream(q.device)), "flash_attention backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv, dbias


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, layout, bias_grad):
        ctx.causal, ctx.layout = causal, layout
        ctx.bias_grad = bias_grad and bias is not None
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, bias=bias, causal=causal,
                                             layout=layout), None
        else:
            out, lse = _forward_cuda(q, k, v, bias, causal, layout,
                                     any(ctx.needs_input_grad[:4]))
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_backward(
            q, k, v, out, g, lse, bias=bias, causal=ctx.causal, layout=ctx.layout,
            bias_grad=ctx.bias_grad)
        return dq, dk, dv, None if dbias is None else dbias.to(bias.dtype), None, None, None


def flash_attention(q, k, v, *, bias=None, causal: bool = False, layout: str = "bnhd",
                    bias_grad: bool = True):
    """Attention of q, k, v in ``layout`` with an optional additive key bias
    [B, N] and causal masking; differentiable in q, k, v and, when
    ``bias_grad`` (the JAX default), in the bias; pass ``bias_grad=False``
    for a constant mask. The kernels on a CUDA tensor, the plain versions on
    a CPU tensor."""
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r} ('bnhd' or 'bhnd')")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _Flash.apply(q, k, v, bias, causal, layout, bias_grad)


flash_attention.launches = 0
flash_attention_backward.launches = 0
