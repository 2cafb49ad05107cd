"""Helpers the frozen-weight block kernels share: the weight contract and
the LayerNorm backward's recomputed statistics."""

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


def layernorm_parts(x, eps: float):
    """(xhat, rstd) of a LayerNorm over the last axis, float32 statistics."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd, rstd
