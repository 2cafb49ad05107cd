"""The attention block with frozen weights: q/k/v projections, attention and
the o-projection as one op, with a dx-only backward (counterpart of
nextgen_uia_tpu/ops/fused_attention.py::fused_attn_block and
``hybrid_attn_block``):

    out = sum_h softmax(q_h k_h^T / sqrt(dh) + bias [+ causal]) v_h Wo_h + bo,
    q, k, v = x Wq + bq, x Wk + bk, x Wv + bv

for already-normed x [B, N, D]. The weights are frozen: the backward gives
dx alone (the JAX custom VJP returns structural zeros for the weights), and
weights that require grad are refused.

``fused_attn_block`` on a CUDA tensor launches the hand-written forward and
backward of csrc/fused_attention.cu (counted in ``fused_attn_block.launches``
and ``fused_attn_block_backward.launches``); on a CPU tensor it runs
``fused_attn_block_plain`` and ``fused_attn_block_backward_plain``. The
kernels keep q|k|v, dq|dk|dv and o|doh in row-major [B*N, 3D] buffers
(``_packed_layout``) and run each bf16 projection as one flat product on
the Hopper GEMM core.
``hybrid_attn_block`` is the composed forward (the q/k/v and o products as
plain matrix products, as the JAX package leaves them to XLA, around the
flash-attention forward, K7) with the same backward.

Rounding points are the JAX kernel's: q, k, v rounded to x's dtype after
their bias, the probabilities in float32 rounded before P v, the head
concat rounded, the output rounded once; in the backward doh and dv stay
float32, ds is rounded before dq and dk, and dq, dk, dv are rounded before
the products that give dx.
"""

from __future__ import annotations

import math

import torch

from . import build
from ._frozen import check_frozen
from .flash_attention import _forward_cuda as _flash_forward_cuda
from .flash_attention import _key_bias, _probs, flash_attention_plain


def _bias(lin, d, device):
    b = lin.b if lin.b is not None else torch.zeros(d, device=device)
    return b.detach().to(torch.float32)


def _weights(p, dt):
    """(wqkv [D, 3D] in dt, bqkv [3D] float32, wo [D, D] in dt, bo [D]
    float32) of an ``Attention``'s frozen projections."""
    d, dev = p.q.w.shape[0], p.q.w.device
    wqkv = torch.cat([p.q.w, p.k.w, p.v.w], dim=1).detach().to(dt).contiguous()
    bqkv = torch.cat([_bias(p.q, d, dev), _bias(p.k, d, dev), _bias(p.v, d, dev)])
    return wqkv, bqkv.contiguous(), p.o.w.detach().to(dt).contiguous(), _bias(p.o, d, dev)


def _cat(ws, dt, dim=0):
    """The detached ``ws`` concatenated along ``dim`` into one new tensor
    of dtype ``dt``: one copy, the cast included."""
    ws = [w.detach() for w in ws]
    shape = list(ws[0].shape)
    shape[dim] = sum(w.shape[dim] for w in ws)
    return torch.cat(ws, dim, out=torch.empty(shape, dtype=dt, device=ws[0].device))


def _packed_layout(b, n, heads, dh):
    """The kernels' layout of q|k|v, of dq|dk|dv and of o|doh: one
    row-major [B*N, 3D] buffer, token n of sequence b on row b*N + n,
    segment t (q, k, v) at columns t*D, head h at t*D + h*dh. Returns (the
    buffer's shape, the element strides (sb, sh, sn, 1) of a segment's
    [B, H, N, dh] view, the segments' offsets), as csrc/fused_attention.cu
    passes them to the attention kernels."""
    d = heads * dh
    return (b * n, 3 * d), (n * 3 * d, dh, 3 * d, 1), (0, d, 2 * d)


def _packed_views(buf, b, n, heads):
    """The three [B, H, N, dh] views of a [B*N, 3D] buffer in
    ``_packed_layout``."""
    dh = buf.shape[1] // (3 * heads)
    _, strides, offsets = _packed_layout(b, n, heads, dh)
    return tuple(buf.as_strided((b, heads, n, dh), strides, buf.storage_offset() + off)
                 for off in offsets)


def _qkv_plain(x, wqkv, bqkv, heads):
    """q, k, v [B, H, N, dh]: float32 products of x and the rounded weights,
    plus the bias, rounded to x's dtype."""
    b, n, d = x.shape
    y = (x.reshape(b * n, d).to(torch.float32) @ wqkv.to(torch.float32) + bqkv).to(x.dtype)
    y = y.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    return y[0], y[1], y[2]


def fused_attn_block_plain(x, p, *, heads: int, bias=None, causal: bool = False):
    """Plain PyTorch version, differentiable by autograd in x: the JAX
    kernel's forward arithmetic and rounding points."""
    b, n, d = x.shape
    dt, f32 = x.dtype, torch.float32
    wqkv, bqkv, wo, bo = _weights(p, dt)
    q, k, v = _qkv_plain(x, wqkv, bqkv, heads)
    probs = _probs(q, k, bias, causal).to(dt)
    cat = (probs.to(f32) @ v.to(f32)).to(dt).transpose(1, 2).reshape(b * n, d)
    return (cat.to(f32) @ wo.to(f32) + bo).to(dt).reshape(b, n, d)


def fused_attn_block_backward_plain(x, p, g, *, heads: int, bias=None, causal: bool = False):
    """Plain dx for the output gradient g, by the formulas of the JAX
    ``_bwd_kernel``: per head, P recomputed in float32, doh = g Wo_h^T and
    dv = P^T doh in float32, dp = round(doh) v^T, ds = round(P (dp -
    rowsum(dp P)) / sqrt(dh)), dq = ds k, dk = ds^T q, then dx = round(dq)
    Wq^T + round(dk) Wk^T + round(dv) Wv^T, rounded to x's dtype once."""
    b, n, d = x.shape
    dt, f32, dh = x.dtype, torch.float32, d // heads
    wqkv, bqkv, wo, _ = _weights(p, dt)
    with torch.no_grad():
        q, k, v = _qkv_plain(x, wqkv, bqkv, heads)
        probs = _probs(q, k, bias, causal)
        doh = g.to(dt).reshape(b * n, d).to(f32) @ wo.to(f32).T
        doh = doh.reshape(b, n, heads, dh).transpose(1, 2)
        dv = probs.transpose(-1, -2) @ doh
        dp = doh.to(dt).to(f32) @ v.to(f32).transpose(-1, -2)
        ds = (probs * (dp - (dp * probs).sum(-1, keepdim=True)) / math.sqrt(dh)).to(dt).to(f32)
        dq, dk = ds @ k.to(f32), ds.transpose(-1, -2) @ q.to(f32)
        dqkv = torch.stack([t.to(dt).to(f32) for t in (dq, dk, dv)])        # [3, B, H, N, dh]
        dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(b * n, 3 * d)
        return (dqkv @ wqkv.to(f32).T).to(dt).reshape(b, n, d)


def _check_cuda(x, heads, bias):
    b, n, d = x.shape
    dh = d // heads
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % heads or d % 64:
        problems.append(f"width {d} with {heads} heads (width % 64 == 0)")
    if (x.dtype == torch.bfloat16 and dh != 64) or not 1 <= dh <= 64:
        problems.append(f"head dim {dh} (bfloat16: 64; float32: 1..64)")
    if bias is not None and (tuple(bias.shape) != (b, n) or bias.device != x.device):
        problems.append(f"bias {tuple(bias.shape)} on {bias.device} (want [B, N])")
    if problems:
        raise ValueError("fused_attn_block CUDA kernel does not take: " + "; ".join(problems))


def _qkv_weights(p, dt, d, device):
    """[Wq|Wk|Wv]^T [3D, D] in dt (one copy) and [bq|bk|bv] [3D] float32."""
    lins = (p.q, p.k, p.v)
    return (_cat([lin.w.T for lin in lins], dt),
            torch.cat([_bias(lin, d, device) for lin in lins]))


def _forward_cuda(x, p, heads, bias, causal):
    _check_cuda(x, heads, bias)
    b, n, d = x.shape
    dt, dh, dev = x.dtype, d // heads, x.device
    x = x.contiguous()
    wqkv_t, bqkv = _qkv_weights(p, dt, d, dev)
    wo_t, bo = _cat([p.o.w.T], dt), _bias(p.o, d, dev)
    shape, _, _ = _packed_layout(b, n, heads, dh)
    qkv = torch.empty(shape, device=dev, dtype=dt)
    cat, out = torch.empty(b * n, d, device=dev, dtype=dt), torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_fused_attn_fwd(
            build.ptr(x, "x"), build.ptr(wqkv_t), build.ptr(bqkv), build.ptr(wo_t), build.ptr(bo),
            build.ptr(_key_bias(bias)), build.ptr(qkv), build.ptr(cat), build.ptr(out),
            build.DTYPE_CODES[dt], b, n, heads, dh, int(causal), 1.0 / math.sqrt(dh),
            build.stream(dev)), "fused_attn_block")
    fused_attn_block.launches += 1
    return out


def fused_attn_block_backward(x, p, g, *, heads: int, bias=None, causal: bool = False):
    """dx for the output gradient g: on a CUDA tensor the backward kernels of
    csrc/fused_attention.cu (counted in
    ``fused_attn_block_backward.launches``), on a CPU tensor
    ``fused_attn_block_backward_plain``."""
    if x.device.type == "cpu":
        return fused_attn_block_backward_plain(x, p, g, heads=heads, bias=bias, causal=causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_block: unsupported device {x.device}")
    _check_cuda(x, heads, bias)
    b, n, d = x.shape
    dt, f32, dh, dev = x.dtype, torch.float32, d // heads, x.device
    x, g = x.contiguous(), g.to(dt).contiguous()
    wqkv_t, bqkv = _qkv_weights(p, dt, d, dev)
    wqkv = _cat([lin.w for lin in (p.q, p.k, p.v)], dt, dim=1)
    wo = p.o.w.detach().to(dt).contiguous()
    shape, _, _ = _packed_layout(b, n, heads, dh)
    qkv, od, dqkv = (torch.empty(shape, device=dev, dtype=dt) for _ in range(3))
    lse, delta = (torch.empty(b, heads, n, device=dev, dtype=f32) for _ in range(2))
    dx = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_fused_attn_bwd(
            build.ptr(x, "x"), build.ptr(wqkv_t), build.ptr(bqkv), build.ptr(wqkv),
            build.ptr(wo), build.ptr(_key_bias(bias)), build.ptr(g, "g"), build.ptr(qkv),
            build.ptr(od), build.ptr(lse), build.ptr(delta), build.ptr(dqkv), build.ptr(dx),
            build.DTYPE_CODES[dt], b, n, heads, dh, int(causal), 1.0 / math.sqrt(dh),
            build.stream(dev)), "fused_attn_block backward")
    fused_attn_block_backward.launches += 1
    return dx


def _composed(x, p, heads, attention):
    """The hybrid forward: plain q/k/v products in x's dtype, ``attention``
    (q, k, v in [B, N, H, dh]), the plain o-product."""
    b, n, d = x.shape
    dt = x.dtype

    def proj(lin, t):
        y = t @ lin.w.detach().to(dt)
        return y if lin.b is None else y + lin.b.detach().to(dt)

    q, k, v = (proj(lin, x).reshape(b, n, heads, d // heads) for lin in (p.q, p.k, p.v))
    return proj(p.o, attention(q, k, v).reshape(b, n, d))


def _hybrid_forward(x, p, heads, bias, causal):
    """The flash-attention forward: the K7 kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return _composed(x, p, heads, lambda q, k, v: flash_attention_plain(
            q, k, v, bias=bias, causal=causal, layout="bnhd"))
    return _composed(x, p, heads,
                     lambda q, k, v: _flash_forward_cuda(q, k, v, bias, causal, "bnhd", False)[0])


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, heads, bias, causal, hybrid):
        ctx.p, ctx.heads, ctx.bias, ctx.causal = p, heads, bias, causal
        ctx.save_for_backward(x)
        if hybrid:
            return _hybrid_forward(x, p, heads, bias, causal)
        if x.device.type == "cpu":
            return fused_attn_block_plain(x, p, heads=heads, bias=bias, causal=causal)
        return _forward_cuda(x, p, heads, bias, causal)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx = fused_attn_block_backward(x, ctx.p, g, heads=ctx.heads, bias=ctx.bias,
                                       causal=ctx.causal)
        return dx, None, None, None, None, None


def _check(x, p, heads, op):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {x.device}")
    if x.shape[-1] % heads:
        raise ValueError(f"{op}: width {x.shape[-1]} is not a multiple of {heads} heads")
    check_frozen(op, *(t for lin in (p.q, p.k, p.v, p.o) for t in (lin.w, lin.b)))


def fused_attn_block(x, p, *, heads: int, bias=None, causal: bool = False):
    """x [B, N, D] (already normed) -> the o-projected attention output
    [B, N, D], differentiable in x. ``p`` is an ``Attention`` whose q/k/v/o
    are frozen; bias an optional additive [B, N] key bias (a constant);
    ``causal`` masks keys after the query."""
    _check(x, p, heads, "fused_attn_block")
    return _AttnBlock.apply(x, p, heads, bias, causal, False)


def hybrid_attn_block(x, p, *, heads: int, bias=None, causal: bool = False):
    """``fused_attn_block`` with the composed forward (plain products around
    the flash-attention forward) and the same dx backward."""
    _check(x, p, heads, "hybrid_attn_block")
    return _AttnBlock.apply(x, p, heads, bias, causal, True)


def hybrid_attn_block_plain(x, p, *, heads: int, bias=None, causal: bool = False):
    """Plain version of ``hybrid_attn_block``'s forward on any device,
    differentiable by autograd in x."""
    return _composed(x, p, heads, lambda q, k, v: flash_attention_plain(
        q, k, v, bias=bias, causal=causal, layout="bnhd"))


fused_attn_block.launches = 0
fused_attn_block_backward.launches = 0
