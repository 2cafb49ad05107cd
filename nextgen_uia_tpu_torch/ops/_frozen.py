"""Helpers the frozen-weight block kernels share: the weight contract, the
weights as the kernels read them, the forward-only contract, the backward
by plain recomposition and the LayerNorm backward's recomputed
statistics."""

from __future__ import annotations

import torch


def check_frozen(op: str, *weights) -> None:
    """The split block kernels give no weight gradients (as the JAX custom
    VJPs return structural zeros); rather than return silent zeros for a
    weight that trains, refuse it."""
    if any(w is not None and w.requires_grad for w in weights):
        raise NotImplementedError(
            f"{op}: its weights are frozen (the kernel gives no weight gradients); "
            "training them needs the eager (mlp_impl='xla') block path, which is not "
            "ported yet (ROADMAP.md, section A, item 3)")


def _cat(ws, dt, dim=0):
    """The detached ``ws`` concatenated along ``dim`` into one new tensor
    of dtype ``dt``: one copy, the cast included (``_cat([w.T], dt)`` is w^T,
    as the Hopper GEMM core reads a weight: [cols, K])."""
    ws = [w.detach() for w in ws]
    shape = list(ws[0].shape)
    shape[dim] = sum(w.shape[dim] for w in ws)
    return torch.cat(ws, dim, out=torch.empty(shape, dtype=dt, device=ws[0].device))


def layernorm_parts(x, eps: float):
    """(xhat, rstd) of a LayerNorm over the last axis, float32 statistics."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd, rstd


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, fn, *inputs):
        ctx.name = name
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name}: forward only on the card: the whole-block kernel serves the eval "
            "and frozen-tower forwards (models/clip.py::infer_cfg), a train forward takes the "
            "split kernels (ROADMAP.md, section B: no backward of it is queued)")


def forward_only(name: str, fn, *inputs):
    """``fn(*inputs)``, a kernel launch with no backward: when autograd
    records it, differentiating through it raises rather than returning
    nothing for inputs that need a gradient."""
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad for t in inputs):
        return _ForwardOnly.apply(name, fn, *inputs)
    return fn(*inputs)


class _PlainBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
        return (None, None, *(next(grads) if need else None for need in needs))


def plain_backward(fn, plain, *inputs):
    """``fn(*inputs)``, a kernel launch whose backward is autograd through
    ``plain(*inputs)`` recomputed from the saved inputs: the JAX package
    differentiates these ops (the post-norm epilogues) by the same plain
    recomposition in XLA, outside its kernels."""
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad for t in inputs):
        return _PlainBackward.apply(fn, plain, *inputs)
    return fn(*inputs)
