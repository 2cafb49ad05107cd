"""Plain pieces the references share: the precision a product's operands are
rounded to, and AdamW after clipping to a global norm with a cosine rate
per update. Plain PyTorch; nothing of the port."""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def exact(t):
    return t


def _round(t, dtype, top):
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = amax / top
    r = (t.detach() / scale).to(dtype).to(torch.float32) * scale
    return t + (r - t.detach())  # rounded forward, straight-through gradient


def lower_precision(t):
    """fp8 e4m3 with a per-tensor scale: the step below bf16."""
    return _round(t, torch.float8_e4m3fn, 448.0)


def bf16_precision(t):
    """bf16: the step below float32."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


class _Bf16Both(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_both(t):
    """bf16 values forward and a bf16 gradient backward: a tensor that a
    program holds in bf16 both ways."""
    return _Bf16Both.apply(t)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def cosine_lr(opt: dict, k: int) -> float:
    t = min(max(k, 0), opt["total_updates"])
    alpha = opt["lr_min"] / opt["lr"]
    return opt["lr"] * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / opt["total_updates"]))
                        + alpha)


def adamw_steps(loss_of, theta: dict, opt: dict, steps: int, start: dict | None = None):
    """``steps`` updates of AdamW (decoupled decay, bias-corrected moments)
    after clipping the gradient to the global norm ``grad_clip`` (0: off).
    ``loss_of(t, theta)`` is step t's loss. ``start`` resumes from a state
    part-way through training: {'m', 'v': each tensor's moments, 'step':
    the updates the moments hold, 'applied': the schedule's count}.
    Returns (losses, the first clipped gradient, each tensor's change)."""
    start = start or {}
    base = {k: v.detach().clone() for k, v in theta.items()}
    m = {k: start["m"][k].clone() if "m" in start else torch.zeros_like(v)
         for k, v in theta.items()}
    v2 = {k: start["v"][k].clone() if "v" in start else torch.zeros_like(v)
          for k, v in theta.items()}
    step0, applied0 = int(start.get("step", 0)), int(start.get("applied", 0))
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, first = [], None
    for t in range(steps):
        params = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
        loss = loss_of(t, params)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        if opt["grad_clip"] > 0:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            coef = min(1.0, opt["grad_clip"] / max(float(norm), 1e-12))
            grads = {k: g * coef for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = cosine_lr(opt, applied0 + t)
        n = step0 + t + 1
        with torch.no_grad():
            for k in theta:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** n)
                vh = v2[k] / (1 - b2 ** n)
                p = theta[k].detach() * (1 - lr * opt["weight_decay"])
                theta[k] = p - lr * mh / (vh.sqrt() + opt["eps"])
        losses.append(float(loss.detach()))
    return losses, first, {k: theta[k] - base[k] for k in theta}
