"""LayerNorm + q/k/v projection with frozen weights (counterpart of
nextgen_uia_tpu/ops/fused_ln_qkv.py::fused_ln_qkv, pre-norm):

    q, k, v = LN(x) @ W{q,k,v} + b{q,k,v}, head-major [B, H, N, dh]

Backward gives dx only: the LayerNorm and projection weights are frozen, as
in the JAX kernel's custom VJP. ``fused_ln_qkv`` is differentiable in x: on
a CUDA tensor its forward and backward launch the hand-written kernels of
csrc/fused_ln_qkv.cu (counted in ``fused_ln_qkv.launches`` and
``fused_ln_qkv_backward.launches``); on a CPU tensor they run
``fused_ln_qkv_plain`` and ``fused_ln_qkv_backward_plain``. The backward
recomputes from the saved x.

With ``ln=None`` the projections act on the raw x (the JAX kernel's
post-norm variant, which BERT's text tower runs): ``fused_ln_qkv_rawx`` is
differentiable in x, its backward dx = [dq|dk|dv] @ [Wq|Wk|Wv]^T with no
LayerNorm backward; on a CUDA tensor its forward and backward launch their
kernels (counted in ``fused_ln_qkv_rawx.launches`` and
``fused_ln_qkv_rawx_backward.launches``), on a CPU tensor the plain versions
run.
"""

from __future__ import annotations

import torch

from . import build
from .registry import register
from ._frozen import check_frozen, layernorm_parts


def _rawx_weights(attn, dt, transposed=False):
    """(w_qkv [D, 3D] in dt, or with ``transposed`` W_qkv^T [3D, D], and
    b_qkv [3D] float32), detached (frozen)."""
    lins = (attn.q, attn.k, attn.v)
    w = (torch.cat([lin.w.T for lin in lins]) if transposed
         else torch.cat([lin.w for lin in lins], dim=1))
    b = torch.cat([lin.b for lin in lins]).detach().to(torch.float32).contiguous()
    return w.detach().to(dt).contiguous(), b


def _weights(ln, attn, dt, transposed=False):
    """(gamma, beta, w_qkv [D, 3D] in dt, or with ``transposed`` W_qkv^T
    [3D, D] (the forward kernel's), b_qkv [3D]) as the kernels take them;
    float32 vectors, detached (the weights are frozen)."""
    f32 = torch.float32
    return (ln.scale.detach().to(f32).contiguous(), ln.bias.detach().to(f32).contiguous(),
            *_rawx_weights(attn, dt, transposed))


def fused_ln_qkv_plain(x, ln, attn, *, heads: int, eps: float = 1e-5):
    """Plain PyTorch version, differentiable by autograd: float32 LayerNorm
    statistics and products, z and q/k/v rounded to x.dtype (the kernel's
    rounding points); ``ln=None`` projects the raw x."""
    b, n, d = x.shape
    dt, f32 = x.dtype, torch.float32
    if ln is None:
        z = x
    else:
        x32 = x.to(f32)
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        z = ((x32 - mu) * torch.rsqrt(var + eps) * ln.scale + ln.bias).to(dt)
    return tuple((z.to(f32) @ lin.w.to(dt).to(f32) + lin.b.to(f32)).to(dt)
                 .reshape(b, n, heads, d // heads).transpose(1, 2).contiguous()
                 for lin in (attn.q, attn.k, attn.v))


def _head_cat(dq, dk, dv):
    """Head-major [B, H, N, dh] gradients -> token-major [B*N, 3D]."""
    b, h, n, dh = dq.shape
    return torch.cat([t.transpose(1, 2).reshape(b * n, h * dh) for t in (dq, dk, dv)], dim=-1)


def fused_ln_qkv_backward_plain(x, gamma, w_qkv, dq, dk, dv, *, eps: float = 1e-5):
    """Plain dx of the JAX kernel's ``_bwd_kernel``: dz = sum over q/k/v of
    dy @ W^T (dy = heads concatenated, rounded to x.dtype; float32 sums),
    then the LayerNorm backward with statistics recomputed from x.

    x [B, N, D]; gamma [D]; w_qkv [D, 3D]; dq, dk, dv [B, H, N, dh].
    """
    b, n, d = x.shape
    dt, f32 = x.dtype, torch.float32
    dy = _head_cat(dq, dk, dv).reshape(b, n, 3 * d)
    dz = dy.to(dt).to(f32) @ w_qkv.to(dt).to(f32).T
    xhat, rstd = layernorm_parts(x, eps)
    dxhat = dz * gamma.to(f32)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return ((dxhat - m1 - xhat * m2) * rstd).to(dt)


def fused_ln_qkv_rawx_backward_plain(w_qkv, dq, dk, dv, *, dtype):
    """Plain dx of the JAX kernel's ``_bwd_kernel`` with ``has_ln=False``:
    the heads concatenated and rounded to ``dtype`` (x's), dx = sum over
    q/k/v of dy @ W^T (float32 sums), rounded once.

    w_qkv [D, 3D]; dq, dk, dv [B, H, N, dh] -> dx [B, N, D]."""
    b, h, n, dh = dq.shape
    f32 = torch.float32
    dy = _head_cat(dq, dk, dv).to(dtype).to(f32)
    return (dy @ w_qkv.to(dtype).to(f32).T).to(dtype).reshape(b, n, h * dh)


def _check_cuda(x, heads):
    b, n, d = x.shape
    dh = d // heads if d % heads == 0 else 0
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % 64 or not dh or dh % 8:
        problems.append(f"width {d} with {heads} heads (width % 64 == 0, head dim % 8 == 0)")
    if problems:
        raise ValueError("fused_ln_qkv CUDA kernel does not take: " + "; ".join(problems))


def _check_hopper_cuda(x, heads, name):
    """_check_cuda, and in bf16 the Hopper GEMM's limit: each 64-column K
    step (backward) and output box (forward) is one head's, so dh % 64."""
    _check_cuda(x, heads)
    dh = x.shape[-1] // heads
    if x.dtype == torch.bfloat16 and dh % 64:
        raise ValueError(f"{name} bf16 CUDA kernel does not take head dim {dh} "
                         f"(head dim % 64 == 0)")


def _rawx_cuda(x, w_qkv_t, b_qkv, heads):
    b, n, d = x.shape
    _check_hopper_cuda(x, heads, "fused_ln_qkv_rawx")
    dt, dh = x.dtype, d // heads
    q, k, v = (torch.empty(b, heads, n, dh, device=x.device, dtype=dt) for _ in range(3))
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_qkv_rawx_fwd(
            build.ptr(x, "x"), build.ptr(w_qkv_t), build.ptr(b_qkv), build.ptr(q), build.ptr(k),
            build.ptr(v), build.DTYPE_CODES[dt], b, n, heads, dh, build.stream(x.device)),
            "fused_ln_qkv_rawx")
    fused_ln_qkv_rawx.launches += 1
    return q, k, v


def fused_ln_qkv_rawx_backward(w_qkv, dq, dk, dv, *, dtype):
    """dx [B, N, D] (``dtype``, x's) for (dq, dk, dv): on a CUDA tensor the
    backward kernel of csrc/fused_ln_qkv.cu (counted in
    ``fused_ln_qkv_rawx_backward.launches``), on a CPU tensor
    ``fused_ln_qkv_rawx_backward_plain``."""
    if dq.device.type == "cpu":
        return fused_ln_qkv_rawx_backward_plain(w_qkv, dq, dk, dv, dtype=dtype)
    if dq.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_rawx: unsupported device {dq.device}")
    b, h, n, dh = dq.shape
    dx = torch.empty(b, n, h * dh, device=dq.device, dtype=dtype)
    _check_hopper_cuda(dx, h, "fused_ln_qkv_rawx")
    dq, dk, dv = (t.to(dtype).contiguous() for t in (dq, dk, dv))
    w_qkv = w_qkv.to(dtype).contiguous()
    lib = build.library()
    with torch.cuda.device(dq.device):
        build.check(lib.nx_qkv_rawx_bwd(
            build.ptr(w_qkv), build.ptr(dq, "dq"), build.ptr(dk, "dk"), build.ptr(dv, "dv"),
            build.ptr(dx), build.DTYPE_CODES[dtype], b, n, h, dh, build.stream(dq.device)),
            "fused_ln_qkv_rawx backward")
    fused_ln_qkv_rawx_backward.launches += 1
    return dx


class _QkvRawx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn, heads):
        # the frozen weights are built once, in forward, for both passes: the
        # forward kernel reads W^T [3D, D] (K-major, like x), the backward W
        ctx.dtype = x.dtype
        ctx.w_qkv = _rawx_weights(attn, x.dtype)[0] if ctx.needs_input_grad[0] else None
        if x.device.type == "cpu":
            return fused_ln_qkv_plain(x, None, attn, heads=heads)
        if x.device.type != "cuda":
            raise ValueError(f"fused_ln_qkv_rawx: unsupported device {x.device}")
        return _rawx_cuda(x.contiguous(), *_rawx_weights(attn, x.dtype, transposed=True), heads)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        return fused_ln_qkv_rawx_backward(ctx.w_qkv, dq, dk, dv, dtype=ctx.dtype), None, None


def fused_ln_qkv_rawx(x, attn, *, heads: int):
    """x [B, N, D] -> (q, k, v) = x @ W{q,k,v} + b{q,k,v}, head-major, with
    no LayerNorm (post-norm towers); differentiable in x."""
    return _QkvRawx.apply(x, attn, heads)


def _forward_cuda(x, gamma, beta, w_qkv_t, b_qkv, heads, eps):
    _check_hopper_cuda(x, heads, "fused_ln_qkv")
    return LN_QKV(x, gamma, beta, w_qkv_t, b_qkv, heads, eps)


def _ln_qkv_launch(x, gamma, beta, w_qkv_t, b_qkv, heads, eps):
    """The registered op ``nextgen_uia::ln_qkv``: one launch, counted in
    ``fused_ln_qkv.launches``."""
    b, n, d = x.shape
    dt, dh = x.dtype, d // heads
    z = torch.empty(b * n, d, device=x.device, dtype=dt)
    q, k, v = (torch.empty(b, heads, n, dh, device=x.device, dtype=dt) for _ in range(3))
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_ln_qkv_fwd(
            build.ptr(x, "x"), build.ptr(gamma), build.ptr(beta), build.ptr(w_qkv_t),
            build.ptr(b_qkv), build.ptr(z), build.ptr(q), build.ptr(k), build.ptr(v),
            build.DTYPE_CODES[dt], b, n, heads, dh, eps, build.stream(x.device)),
            "fused_ln_qkv")
    fused_ln_qkv.launches += 1
    return q, k, v


def _heads_like(x, heads):
    b, n, d = x.shape
    return tuple(x.new_empty(b, heads, n, d // heads) for _ in range(3))


LN_QKV = register("ln_qkv", "(Tensor x, Tensor gamma, Tensor beta, Tensor w_qkv_t, "
                  "Tensor b_qkv, int heads, float eps) -> (Tensor, Tensor, Tensor)",
                  _ln_qkv_launch, lambda x, gamma, beta, w, b, heads, eps: _heads_like(x, heads))


def fused_ln_qkv_backward(x, gamma, w_qkv, dq, dk, dv, *, eps: float = 1e-5):
    """dx for (dq, dk, dv): on a CUDA tensor the backward kernel of
    csrc/fused_ln_qkv.cu (counted in ``fused_ln_qkv_backward.launches``), on
    a CPU tensor ``fused_ln_qkv_backward_plain``."""
    if x.device.type == "cpu":
        return fused_ln_qkv_backward_plain(x, gamma, w_qkv, dq, dk, dv, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv: unsupported device {x.device}")
    b, n, d = x.shape
    heads = dq.shape[1]
    _check_hopper_cuda(x, heads, "fused_ln_qkv")
    dt = x.dtype
    dq, dk, dv = (t.to(dt).contiguous() for t in (dq, dk, dv))
    gamma, w_qkv = gamma.to(torch.float32).contiguous(), w_qkv.to(dt).contiguous()
    dz = torch.empty(b * n, d, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_ln_qkv_bwd(
            build.ptr(x, "x"), build.ptr(gamma), build.ptr(w_qkv), build.ptr(dq),
            build.ptr(dk), build.ptr(dv), build.ptr(dz), build.ptr(dx),
            build.DTYPE_CODES[dt], b, n, heads, d // heads, eps, build.stream(x.device)),
            "fused_ln_qkv backward")
    fused_ln_qkv_backward.launches += 1
    return dx


class _FusedLnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln, attn, heads, eps):
        ctx.save_for_backward(x)
        ctx.ln, ctx.attn, ctx.eps = ln, attn, eps
        if x.device.type == "cpu":
            return fused_ln_qkv_plain(x, ln, attn, heads=heads, eps=eps)
        if x.device.type != "cuda":
            raise ValueError(f"fused_ln_qkv: unsupported device {x.device}")
        return _forward_cuda(x.contiguous(), *_weights(ln, attn, x.dtype, transposed=True),
                             heads, eps)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        (x,) = ctx.saved_tensors
        gamma, _, w_qkv, _ = _weights(ctx.ln, ctx.attn, x.dtype)
        dx = fused_ln_qkv_backward(x.contiguous(), gamma, w_qkv, dq, dk, dv, eps=ctx.eps)
        return dx, None, None, None, None


def fused_ln_qkv(x, ln, attn, *, heads: int, eps: float = 1e-5):
    """x [B, N, D] -> (q, k, v), each [B, H, N, D/H], with the LayerNorm
    fused in (``ln=None``: on the raw x, ``fused_ln_qkv_rawx``);
    differentiable in x only (frozen weights: raises if any of them
    requires grad)."""
    check_frozen("fused_ln_qkv", *(() if ln is None else (ln.scale, ln.bias)),
                 *(t for lin in (attn.q, attn.k, attn.v) for t in (lin.w, lin.b)))
    if ln is None:
        return fused_ln_qkv_rawx(x, attn, heads=heads)
    return _FusedLnQkv.apply(x, ln, attn, heads, eps)


fused_ln_qkv.launches = 0
fused_ln_qkv_rawx.launches = 0
fused_ln_qkv_rawx_backward.launches = 0
fused_ln_qkv_backward.launches = 0
