"""MLP with frozen weights, forward and dx backward (counterpart of
nextgen_uia_tpu/ops/fused_mlp.py::fused_mlp):

    out = fc2(act(fc1 x + b1)) + b2

float32 sums, the hidden activation rounded to x.dtype, exact erf GELU or
quick_gelu. The backward gives dx only (the weights are frozen, as in the
JAX kernel's custom VJP): fc1 recomputed from the saved x, dpre = (g @
W2^T) * act'(a) rounded to x.dtype, dx = dpre @ W1^T. ``fused_mlp`` is
differentiable in x: on a CUDA tensor its forward and backward launch the
hand-written kernels of csrc/fused_mlp.cu for any row count (counted in
``fused_mlp.launches`` and ``fused_mlp_backward.launches``); on a CPU tensor
they run ``fused_mlp_plain`` and ``fused_mlp_backward_plain``. In bf16 the
kernels' products run on the Hopper GEMM core, which reads each weight as
[cols, K]: the forward takes W1^T and W2^T, built once per forward
(``_kernel_weights``), the backward W1^T again for the recomputed fc1 and W2,
W1 as stored for g W2^T and dpre W1^T.
"""

from __future__ import annotations

import torch

from ..nn.layers import ACTIVATIONS
from . import build
from ._frozen import _cat, check_frozen
from .fused_ln_mlp import act_grad
from .registry import register


def fused_mlp_plain(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """Plain PyTorch version: float32 products and bias, h rounded to
    x.dtype, the output rounded once (the kernel's rounding points)."""
    dt, f32 = x.dtype, torch.float32
    a = x.to(f32) @ w1.to(dt).to(f32) + b1.to(f32)
    h = ACTIVATIONS[act](a).to(dt)
    return (h.to(f32) @ w2.to(dt).to(f32) + b2.to(f32)).to(dt)


def fused_mlp_backward_plain(x, w1, b1, w2, g, *, act: str = "gelu"):
    """Plain dx of the JAX kernel's ``_bwd_kernel``: a = x @ W1 + b1
    (float32), dpre = (g @ W2^T) * act'(a) with g rounded to x.dtype and
    dpre rounded to x.dtype, dx = dpre @ W1^T (float32 sums, rounded once).

    x, g [..., D]; w1 [D, Hd]; b1 [Hd]; w2 [Hd, D]."""
    dt, f32 = x.dtype, torch.float32
    a = x.to(f32) @ w1.to(dt).to(f32) + b1.to(f32)
    dpre = ((g.to(dt).to(f32) @ w2.to(dt).to(f32).T) * act_grad(act, a)).to(dt)
    return (dpre.to(f32) @ w1.to(dt).to(f32).T).to(dt)


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
        raise ValueError("fused_mlp CUDA kernel does not take: " + "; ".join(problems))


def _kernel_weights(w1, b1, w2, b2, dt):
    """The forward kernel's weights, detached (frozen): W1^T [hidden, D]
    and W2^T [D, hidden] in dt (the core's [cols, K]), the biases
    float32."""
    f32 = torch.float32
    return {"w1_t": _cat([w1.T], dt), "b1": b1.detach().to(f32).contiguous(),
            "w2_t": _cat([w2.T], dt), "b2": b2.detach().to(f32).contiguous()}


def _forward_cuda(x, w, act):
    d = x.shape[-1]
    _check_cuda(x, w["w1_t"].shape[0], act)
    out = MLP(x.contiguous().reshape(x.numel() // d, d), w["w1_t"], w["b1"], w["w2_t"],
              w["b2"], act)
    return out.reshape(x.shape)


def _mlp_launch(x, w1_t, b1, w2_t, b2, act):
    """The registered op ``nextgen_uia::mlp`` on x [M, D]: one launch,
    counted in ``fused_mlp.launches``."""
    m, d = x.shape
    hidden, dt = w1_t.shape[0], x.dtype
    h = torch.empty(m, hidden, device=x.device, dtype=dt)
    out = torch.empty(m, d, device=x.device, dtype=dt)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_mlp_fwd(
            build.ptr(x, "x"), build.ptr(w1_t), build.ptr(b1), build.ptr(w2_t), build.ptr(b2),
            build.ptr(h), build.ptr(out), build.DTYPE_CODES[dt], m, d, hidden,
            build.ACT_CODES[act], build.stream(x.device)), "fused_mlp")
    fused_mlp.launches += 1
    return out


MLP = register("mlp", "(Tensor x, Tensor w1_t, Tensor b1, Tensor w2_t, Tensor b2, str act) "
               "-> Tensor", _mlp_launch, lambda x, *_: torch.empty_like(x))


def fused_mlp_backward(x, w1, b1, w2, g, *, act: str = "gelu", w1_t=None):
    """dx for the output gradient g: on a CUDA tensor the backward kernels
    of csrc/fused_mlp.cu (counted in ``fused_mlp_backward.launches``), on a
    CPU tensor ``fused_mlp_backward_plain``. Weights already in x.dtype
    (w1, w2) and float32 (b1), as ``_FusedMlp`` keeps them, are not copied;
    ``w1_t`` (W1^T in x.dtype, the forward's copy) is built here if not
    given."""
    if x.device.type == "cpu":
        return fused_mlp_backward_plain(x, w1, b1, w2, g, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    d, hidden = x.shape[-1], w1.shape[1]
    _check_cuda(x, hidden, act)
    dt, m, dev = x.dtype, x.numel() // d, x.device
    xm, g = x.contiguous().reshape(m, d), g.to(dt).contiguous().reshape(m, d)
    w1_t = _cat([w1.T], dt) if w1_t is None else w1_t
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1 = b1.to(torch.float32).contiguous()
    a = torch.empty(m, hidden, device=dev, dtype=torch.float32)
    dpre = torch.empty(m, hidden, device=dev, dtype=dt)
    dx = torch.empty(m, d, device=dev, dtype=dt)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_mlp_bwd(
            build.ptr(xm, "x"), build.ptr(w1_t), build.ptr(b1), build.ptr(w1), build.ptr(w2),
            build.ptr(g, "g"), build.ptr(a), build.ptr(dpre), build.ptr(dx),
            build.DTYPE_CODES[dt], m, d, hidden, build.ACT_CODES[act], build.stream(dev)),
            "fused_mlp backward")
    fused_mlp_backward.launches += 1
    return dx.reshape(x.shape)


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x)
        ctx.act = act
        if x.device.type == "cpu":
            ctx.weights, ctx.w1_t = (w1, b1, w2), None
            return fused_mlp_plain(x, w1, b1, w2, b2, act=act)
        if x.device.type != "cuda":
            raise ValueError(f"fused_mlp: unsupported device {x.device}")
        # W1^T and W2^T built once, in forward; W1^T kept for the backward's
        # recomputed fc1, W1 and W2 as stored for its other two products
        w = _kernel_weights(w1, b1, w2, b2, x.dtype)
        ctx.weights, ctx.w1_t = (w1.detach(), w["b1"], w2.detach()), w["w1_t"]
        return _forward_cuda(x, w, act)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx = fused_mlp_backward(x, *ctx.weights, g, act=ctx.act, w1_t=ctx.w1_t)
        return dx, None, None, None, None, None


def fused_mlp(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """x [..., D] -> fc2(act(fc1 x)) [..., D] with frozen weights (raises if
    any requires grad); differentiable in x. The kernels on a CUDA tensor,
    the plain versions on a CPU tensor."""
    check_frozen("fused_mlp", w1, b1, w2, b2)
    return _FusedMlp.apply(x, w1, b1, w2, b2, act)


fused_mlp.launches = 0
fused_mlp_backward.launches = 0
