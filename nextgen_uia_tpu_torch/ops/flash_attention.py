"""Attention forward for any sequence length (counterpart of
nextgen_uia_tpu/ops/flash_attention.py::flash_attention):

    o = softmax(q k^T / sqrt(dh) + bias[b, key], causal) v

float32 scores and softmax, the probabilities rounded to the input type
before the product with v, the output in the input type. ``layout``
'bnhd' takes q, k, v [B, N, H, dh], 'bhnd' [B, H, N, dh]; the output has
the input's layout. On a CUDA tensor the hand-written kernel of
csrc/flash_attention.cu runs (counted in ``flash_attention.launches``),
reading strided views (a packed q|k|v projection, either layout) without a
copy; on a CPU tensor ``flash_attention_plain`` runs and autograd
differentiates it. The backward kernel is not ported: on the card, autograd
reaching it raises.
"""

from __future__ import annotations

import math

import torch

from . import build

NEG_INF = -1e30


def _to_bhnd(t, layout):
    return t.transpose(1, 2) if layout == "bnhd" else t


def flash_attention_plain(q, k, v, *, bias=None, causal: bool = False, layout: str = "bnhd"):
    """Plain PyTorch version, differentiable by autograd: the JAX kernel's
    masking (the bias added to the scores, then -1e30 above the diagonal
    when causal), float32 softmax, P rounded to q.dtype before P v."""
    dt, f32 = q.dtype, torch.float32
    q, k, v = (_to_bhnd(t, layout) for t in (q, k, v))
    n = q.shape[2]
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias.to(f32)[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=q.device)
        s = torch.where(pos[None, :] > pos[:, None], torch.full_like(s, NEG_INF), s)
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.to(f32) @ v.to(f32)).to(dt)
    return o.transpose(1, 2) if layout == "bnhd" else o


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
        strides = [s for t in (q, k, v) for s in _strides(t, layout)]
        if any(s % 8 for s in strides) or any(t.data_ptr() % 16 for t in (q, k, v)):
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


def _forward_cuda(q, k, v, bias, causal, layout):
    b, n, h, dh = _check_cuda(q, k, v, bias, layout)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    kb = None if bias is None else bias.detach().to(torch.float32).contiguous()
    sb, sh, sn = _strides(q, layout)
    osb, osh, osn = _strides(out, layout)
    lib = build.library()
    with torch.cuda.device(q.device):
        build.check(lib.nx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), build.ptr(kb),
            build.DTYPE_CODES[q.dtype], b, h, n, dh, sb, sh, sn, osb, osh, osn, int(causal),
            1.0 / math.sqrt(dh), build.stream(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, layout):
        return _forward_cuda(q, k, v, bias, causal, layout)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention: the backward kernel (K7 backward) is not ported yet; it comes "
            "with the LoRA slice (ROADMAP.md, section B, K7, and section A, item 4)")


def flash_attention(q, k, v, *, bias=None, causal: bool = False, layout: str = "bnhd"):
    """Attention of q, k, v in ``layout`` with an optional additive key bias
    [B, N] (a constant: no gradient) and causal masking; the kernel on a CUDA
    tensor, ``flash_attention_plain`` on a CPU tensor."""
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r} ('bnhd' or 'bhnd')")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias=bias, causal=causal, layout=layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _Flash.apply(q, k, v, bias, causal, layout)


flash_attention.launches = 0
