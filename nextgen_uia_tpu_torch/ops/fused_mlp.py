"""MLP with frozen weights, forward (counterpart of
nextgen_uia_tpu/ops/fused_mlp.py::fused_mlp):

    out = fc2(act(fc1 x + b1)) + b2

float32 sums, the hidden activation rounded to x.dtype, exact erf GELU or
quick_gelu. On a CUDA tensor the hand-written kernel of csrc/fused_mlp.cu
runs (counted in ``fused_mlp.launches``) for any row count; on a CPU tensor
``fused_mlp_plain`` runs and autograd differentiates it. The backward kernel
is not ported: on the card, autograd reaching it raises.
"""

from __future__ import annotations

import torch

from ..nn.layers import ACTIVATIONS
from . import build
from ._frozen import check_frozen


def fused_mlp_plain(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """Plain PyTorch version: float32 products and bias, h rounded to
    x.dtype, the output rounded once (the kernel's rounding points)."""
    dt, f32 = x.dtype, torch.float32
    a = x.to(f32) @ w1.to(dt).to(f32) + b1.to(f32)
    h = ACTIVATIONS[act](a).to(dt)
    return (h.to(f32) @ w2.to(dt).to(f32) + b2.to(f32)).to(dt)


def _forward_cuda(x, w1, b1, w2, b2, act):
    d, hidden = x.shape[-1], w1.shape[1]
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % 64 or hidden % 64:
        problems.append(f"width {d}, hidden {hidden} (multiples of 64)")
    if act not in build.ACT_CODES:
        problems.append(f"activation {act!r}")
    if problems:
        raise ValueError("fused_mlp CUDA kernel does not take: " + "; ".join(problems))
    dt, m = x.dtype, x.numel() // d
    xm = x.contiguous().reshape(m, d)
    w1, w2 = w1.detach().to(dt).contiguous(), w2.detach().to(dt).contiguous()
    b1, b2 = (t.detach().to(torch.float32).contiguous() for t in (b1, b2))
    h = torch.empty(m, hidden, device=x.device, dtype=dt)
    out = torch.empty(m, d, device=x.device, dtype=dt)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_mlp_fwd(
            build.ptr(xm, "x"), build.ptr(w1), build.ptr(b1), build.ptr(w2), build.ptr(b2),
            build.ptr(h), build.ptr(out), build.DTYPE_CODES[dt], m, d, hidden,
            build.ACT_CODES[act], build.stream(x.device)), "fused_mlp")
    fused_mlp.launches += 1
    return out.reshape(x.shape)


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        return _forward_cuda(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "fused_mlp: the backward kernel (K10 backward) is not ported yet; it comes with "
            "the first slice that differentiates it, LoRA (ROADMAP.md, section B, K10, and "
            "section A, item 4)")


def fused_mlp(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """x [..., D] -> fc2(act(fc1 x)) [..., D] with frozen weights (raises if
    any requires grad); the kernel on a CUDA tensor, ``fused_mlp_plain`` on
    a CPU tensor."""
    check_frozen("fused_mlp", w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return _FusedMlp.apply(x, w1, b1, w2, b2, act)


fused_mlp.launches = 0
