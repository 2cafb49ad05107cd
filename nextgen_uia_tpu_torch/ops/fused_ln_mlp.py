"""LayerNorm + MLP + residual with frozen weights (counterpart of
nextgen_uia_tpu/ops/fused_ln_mlp.py::fused_ln_mlp_residual):

    out = x + fc2(act(fc1(LN(x))))

Backward gives dx = g + LN_bwd(MLP_bwd(g)) only: the LayerNorm and MLP
weights are frozen, as in the JAX kernel's custom VJP.
``fused_ln_mlp_residual`` is differentiable in x: on a CUDA tensor its
forward and backward launch the hand-written kernels of csrc/fused_ln_mlp.cu
(counted in ``fused_ln_mlp_residual.launches`` and
``fused_ln_mlp_residual_backward.launches``); on a CPU tensor they run the
plain versions below. The backward recomputes fc1 from the saved x. In
bf16 the kernels' products run on the Hopper GEMM core, which reads each
weight as [cols, K]: the forward takes W1^T and W2^T, built once per call
(``_kernel_weights``), the backward W2 and W1 as stored for g W2^T and dpre
W1^T, and W1^T again for the recomputed fc1.

``fused_postnorm_mlp_ln`` is BERT's post-norm feed-forward sublayer
(counterpart of nextgen_uia_tpu/ops/fused_ln_mlp.py::fused_postnorm_mlp_ln):

    out = LN(x + fc2(act(fc1(x))))

with the residual sum in float32 until the LayerNorm. On a CUDA tensor it
launches its forward kernel (counted in ``fused_postnorm_mlp_ln.launches``).
Its backward (dx) is autograd through the plain version recomputed from the
saved x, as the JAX kernel's ``_postnorm_bwd_rule`` differentiates its XLA
recomposition: plain PyTorch on the card, no kernel of its own.
"""

from __future__ import annotations

import torch

from ..nn.layers import ACTIVATIONS
from . import build
from ._frozen import _cat, check_frozen, layernorm_parts, plain_backward


def act_grad(act: str, a):
    """d act / d a: exact erf GELU (Phi(a) + a phi(a)) or quick_gelu."""
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
        return cdf + a * torch.exp(-0.5 * a * a) * 0.3989422804014327
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * a)
        return s + 1.702 * a * s * (1.0 - s)
    raise ValueError(f"unsupported activation {act!r}")


def _weights(ln, mlp, dt):
    f32 = torch.float32
    return (ln.scale.detach().to(f32).contiguous(), ln.bias.detach().to(f32).contiguous(),
            mlp.fc1.w.detach().to(dt).contiguous(), mlp.fc1.b.detach().to(f32).contiguous(),
            mlp.fc2.w.detach().to(dt).contiguous(), mlp.fc2.b.detach().to(f32).contiguous())


def _kernel_weights(ln, mlp, dt):
    """(gamma, beta, W1^T [hidden, D], b1, W2^T [D, hidden], b2) as the
    forward kernel takes them: the products' weights in dt as [cols, K]."""
    f32 = torch.float32
    return (ln.scale.detach().to(f32).contiguous(), ln.bias.detach().to(f32).contiguous(),
            _cat([mlp.fc1.w.T], dt), mlp.fc1.b.detach().to(f32).contiguous(),
            _cat([mlp.fc2.w.T], dt), mlp.fc2.b.detach().to(f32).contiguous())


def _ln(x, gamma, beta, eps):
    xhat, _ = layernorm_parts(x, eps)
    return (xhat * gamma.to(torch.float32) + beta.to(torch.float32)).to(x.dtype)


def fused_ln_mlp_residual_plain(x, ln, mlp, *, act: str = "gelu", eps: float = 1e-5):
    """Plain PyTorch version, differentiable by autograd: float32 LayerNorm
    statistics, products and residual sum; z and h rounded to x.dtype, the
    output rounded once (the kernel's rounding points)."""
    dt, f32 = x.dtype, torch.float32
    z = _ln(x, ln.scale, ln.bias, eps)
    a = z.to(f32) @ mlp.fc1.w.to(dt).to(f32) + mlp.fc1.b.to(f32)
    h = ACTIVATIONS[act](a).to(dt)
    return (x.to(f32) + mlp.fc2.b.to(f32) + h.to(f32) @ mlp.fc2.w.to(dt).to(f32)).to(dt)


def fused_ln_mlp_residual_backward_plain(x, gamma, beta, w1, b1, w2, g, *, act: str = "gelu",
                                         eps: float = 1e-5):
    """Plain dx of the JAX kernel's ``_bwd_kernel``: z = LN(x) rounded to
    x.dtype, a = z @ W1 + b1 (float32), dpre = (g @ W2^T) * act'(a) rounded
    to x.dtype, dz = dpre @ W1^T, dx = g + LN_bwd(dz) with statistics
    recomputed from x."""
    dt, f32 = x.dtype, torch.float32
    z = _ln(x, gamma, beta, eps)
    a = z.to(f32) @ w1.to(dt).to(f32) + b1.to(f32)
    g = g.to(dt)
    dpre = ((g.to(f32) @ w2.to(dt).to(f32).T) * act_grad(act, a)).to(dt)
    dz = dpre.to(f32) @ w1.to(dt).to(f32).T
    xhat, rstd = layernorm_parts(x, eps)
    dxhat = dz * gamma.to(f32)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (g.to(f32) + (dxhat - m1 - xhat * m2) * rstd).to(dt)


def _check_cuda(x, hidden, act):
    d = x.shape[-1]
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % 64 or hidden % 64:
        problems.append(f"width {d}, hidden {hidden} (multiples of 64)")
    if act not in build.ACT_CODES:
        problems.append(f"activation {act!r}")
    if problems:
        raise ValueError(f"fused_ln_mlp_residual CUDA kernel does not take x "
                         f"{tuple(x.shape)} with hidden {hidden}: " + "; ".join(problems))


def _forward_cuda(x, gamma, beta, w1_t, b1, w2_t, b2, act, eps):
    d, hidden = x.shape[-1], w1_t.shape[0]
    _check_cuda(x, hidden, act)
    m, dt = x.numel() // d, x.dtype
    x = x.contiguous()
    z = torch.empty(m, d, device=x.device, dtype=dt)
    h = torch.empty(m, hidden, device=x.device, dtype=dt)
    out = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_ln_mlp_fwd(
            build.ptr(x, "x"), build.ptr(gamma), build.ptr(beta), build.ptr(w1_t),
            build.ptr(b1), build.ptr(w2_t), build.ptr(b2), build.ptr(z), build.ptr(h),
            build.ptr(out), build.DTYPE_CODES[dt], m, d, hidden, build.ACT_CODES[act], eps,
            build.stream(x.device)), "fused_ln_mlp_residual")
    fused_ln_mlp_residual.launches += 1
    return out


def fused_ln_mlp_residual_backward(x, gamma, beta, w1, b1, w2, g, *, act: str = "gelu",
                                   eps: float = 1e-5):
    """dx for the output gradient g: on a CUDA tensor the backward kernels
    of csrc/fused_ln_mlp.cu (counted in
    ``fused_ln_mlp_residual_backward.launches``), on a CPU tensor
    ``fused_ln_mlp_residual_backward_plain``."""
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_backward_plain(x, gamma, beta, w1, b1, w2, g, act=act,
                                                    eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_residual: unsupported device {x.device}")
    d, hidden = x.shape[-1], w1.shape[1]
    _check_cuda(x, hidden, act)
    m, dt, dev = x.numel() // d, x.dtype, x.device
    x, g = x.contiguous(), g.to(dt).contiguous()
    gamma, beta, b1 = (t.to(torch.float32).contiguous() for t in (gamma, beta, b1))
    w1_t, w1, w2 = _cat([w1.T], dt), w1.to(dt).contiguous(), w2.to(dt).contiguous()
    z = torch.empty(m, d, device=dev, dtype=dt)
    a = torch.empty(m, hidden, device=dev, dtype=torch.float32)
    dpre = torch.empty(m, hidden, device=dev, dtype=dt)
    dz = torch.empty(m, d, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_ln_mlp_bwd(
            build.ptr(x, "x"), build.ptr(gamma), build.ptr(beta), build.ptr(w1_t),
            build.ptr(b1), build.ptr(w1), build.ptr(w2), build.ptr(g, "g"), build.ptr(z),
            build.ptr(a), build.ptr(dpre), build.ptr(dz), build.ptr(dx), build.DTYPE_CODES[dt],
            m, d, hidden, build.ACT_CODES[act], eps, build.stream(dev)),
            "fused_ln_mlp_residual backward")
    fused_ln_mlp_residual_backward.launches += 1
    return dx


class _FusedLnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln, mlp, act, eps):
        ctx.save_for_backward(x)
        ctx.ln, ctx.mlp, ctx.act, ctx.eps = ln, mlp, act, eps
        if x.device.type == "cpu":
            return fused_ln_mlp_residual_plain(x, ln, mlp, act=act, eps=eps)
        if x.device.type != "cuda":
            raise ValueError(f"fused_ln_mlp_residual: unsupported device {x.device}")
        return _forward_cuda(x, *_kernel_weights(ln, mlp, x.dtype), act, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gamma, beta, w1, b1, w2, _ = _weights(ctx.ln, ctx.mlp, x.dtype)
        dx = fused_ln_mlp_residual_backward(x, gamma, beta, w1, b1, w2, g, act=ctx.act,
                                            eps=ctx.eps)
        return dx, None, None, None, None


def fused_ln_mlp_residual(x, ln, mlp, *, act: str = "gelu", eps: float = 1e-5):
    """x [..., D] -> x + fc2(act(fc1(LN(x)))); differentiable in x only
    (frozen weights: raises if any of them requires grad)."""
    check_frozen("fused_ln_mlp_residual", ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b,
                 mlp.fc2.w, mlp.fc2.b)
    return _FusedLnMlp.apply(x, ln, mlp, act, eps)


fused_ln_mlp_residual.launches = 0
fused_ln_mlp_residual_backward.launches = 0


def fused_postnorm_mlp_ln_plain(x, mlp, ln, *, act: str = "gelu", eps: float = 1e-12):
    """Plain PyTorch version, differentiable by autograd: float32 products,
    residual sum and LayerNorm statistics; h rounded to x.dtype, the output
    rounded once (the kernel's rounding points)."""
    dt, f32 = x.dtype, torch.float32
    a = x.to(f32) @ mlp.fc1.w.to(dt).to(f32) + mlp.fc1.b.to(f32)
    h = ACTIVATIONS[act](a).to(dt)
    y = x.to(f32) + mlp.fc2.b.to(f32) + h.to(f32) @ mlp.fc2.w.to(dt).to(f32)
    return (layernorm_parts(y, eps)[0] * ln.scale + ln.bias).to(dt)


def _postnorm_cuda(x, w1, b1, w2, b2, gamma, beta, act, eps):
    d, hidden = x.shape[-1], w1.shape[1]
    _check_cuda(x, hidden, act)
    m, dt, dev = x.numel() // d, x.dtype, x.device
    h = torch.empty(m, hidden, device=dev, dtype=dt)
    y32 = torch.empty(m, d, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_postnorm_mlp_ln_fwd(
            build.ptr(x, "x"), build.ptr(w1), build.ptr(b1), build.ptr(w2), build.ptr(b2),
            build.ptr(gamma), build.ptr(beta), build.ptr(h), build.ptr(y32), build.ptr(out),
            build.DTYPE_CODES[dt], m, d, hidden, build.ACT_CODES[act], eps, build.stream(dev)),
            "fused_postnorm_mlp_ln")
    fused_postnorm_mlp_ln.launches += 1
    return out


def fused_postnorm_mlp_ln(x, mlp, ln, *, act: str = "gelu", eps: float = 1e-12):
    """x [..., D] -> LN(x + fc2(act(fc1(x)))) with frozen weights (raises
    if any requires grad); the kernel on a CUDA tensor (its backward
    autograd through the plain version), the plain version on a CPU
    tensor."""
    check_frozen("fused_postnorm_mlp_ln", ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b,
                 mlp.fc2.w, mlp.fc2.b)
    if x.device.type == "cpu":
        return fused_postnorm_mlp_ln_plain(x, mlp, ln, act=act, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_postnorm_mlp_ln: unsupported device {x.device}")
    gamma, beta, w1, b1, w2, b2 = _weights(ln, mlp, x.dtype)
    return plain_backward(
        lambda x_: _postnorm_cuda(x_, w1, b1, w2, b2, gamma, beta, act, eps),
        lambda x_: fused_postnorm_mlp_ln_plain(x_, mlp, ln, act=act, eps=eps), x.contiguous())


fused_postnorm_mlp_ln.launches = 0
