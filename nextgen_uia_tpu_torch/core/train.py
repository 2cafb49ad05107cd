"""The train step and its helpers (counterpart of nextgen_uia_tpu/core/train.py).

Reference training semantics, as the JAX engine reproduces them:
  - AdamW (betas 0.9/0.95 by default, eps 1e-8, decoupled weight decay on
    every trainable tensor) with a cosine learning rate per *applied* update
    from lr to lr_min over the run: optax's ``adamw(cosine_decay_schedule)``,
    which ``torch.optim.AdamW`` equals when its rate is set to
    ``cosine_lr_value(cfg, k)`` before update k;
  - gradient accumulation over ``accum_steps`` microbatches: a microbatch
    whose loss is not finite is skipped (its gradients dropped), the kept
    ones' gradients are summed and divided by their count, then clipped to
    the global norm ``grad_clip`` (0: off);
  - an update whose microbatches were all skipped changes neither the
    parameters nor the optimizer state nor the schedule count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-4
    lr_min: float = 1e-8
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    total_updates: int = 1000


def cosine_lr_value(cfg: TrainConfig, count: int) -> float:
    """The cosine schedule at 0-indexed applied update ``count`` (optax's
    ``cosine_decay_schedule(lr, total_updates, alpha=lr_min / lr)``)."""
    steps = max(cfg.total_updates, 1)
    t = min(max(count, 0), steps)
    alpha = cfg.lr_min / cfg.lr if cfg.lr > 0 else 0.0
    return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / steps)) + alpha)


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over ``params`` (an iterable of trainable tensors); the train
    step sets its rate from the schedule before each update."""
    return torch.optim.AdamW(list(params), lr=cosine_lr_value(cfg, 0),
                             betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


class TrainStep:
    """One optimizer update over a stacked batch (``make_train_step``).

    ``loss_fn(microbatch, gen) -> scalar loss`` runs the forward of the
    trainable parameters the optimizer holds; ``step(batch, gen)`` takes
    batch leaves shaped [accum_steps, microbatch, ...]
    (``stack_microbatches``) and returns {'loss': the mean loss of the kept
    microbatches (0.0 when none was kept), 'skipped': how many were not
    finite, 'grad_norm': the global norm before clipping}. Each
    microbatch's gradients are flattened into one float32 buffer and added
    to the running sum where its loss is finite, on the device; the host
    reads the kept count and the loss sum once per update, after every
    backward is queued. After a call each parameter's ``grad`` holds the
    update's gradient (averaged and clipped). ``applied`` counts the updates
    taken (the schedule's count), and is part of the resumable state.
    """

    def __init__(self, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                 cfg: TrainConfig, *, accum_steps: int = 1, grad_clip: float = 0.0):
        self.loss_fn, self.optimizer, self.cfg = loss_fn, optimizer, cfg
        self.accum_steps, self.grad_clip = accum_steps, grad_clip
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.applied = 0

    def __call__(self, batch: dict, gen=None) -> dict:
        lead = {v.shape[0] for v in batch.values()}
        if lead != {self.accum_steps}:
            raise ValueError(f"batch leaves lead with {lead}, want accum_steps "
                             f"{self.accum_steps} (stack_microbatches)")
        params = self.params
        dev = params[0].device
        sizes = [p.numel() for p in params]
        zeros = torch.zeros(max(sizes), device=dev)  # stands in for unreached tensors
        total = torch.zeros(sum(sizes), device=dev)
        loss_sum = torch.zeros((), device=dev)
        kept = torch.zeros((), device=dev)
        for i in range(self.accum_steps):
            for p in params:
                p.grad = None
            loss = self.loss_fn({k: v[i] for k, v in batch.items()}, gen)
            loss.backward()
            ok = torch.isfinite(loss.detach())
            flat = torch.cat([zeros[:n] if p.grad is None else p.grad.reshape(-1).float()
                              for p, n in zip(params, sizes)])
            total += torch.where(ok, flat, torch.zeros_like(flat))
            loss_sum += torch.where(ok, loss.detach().float(), torch.zeros_like(loss_sum))
            kept += ok.float()
        total /= torch.clamp(kept, min=1.0)
        grad_norm = torch.linalg.vector_norm(total)
        if self.grad_clip > 0:
            total *= torch.clamp(self.grad_clip / torch.clamp(grad_norm, min=1e-12), max=1.0)
        n_kept, loss_total, norm = torch.stack([kept, loss_sum, grad_norm]).tolist()
        n_kept = int(n_kept)
        for p, g in zip(params, torch.split(total, sizes)):
            p.grad = g.view_as(p).to(p.dtype)
        if n_kept:
            for group in self.optimizer.param_groups:
                group["lr"] = cosine_lr_value(self.cfg, self.applied)
            self.optimizer.step()
            self.applied += 1
        return {"loss": loss_total / max(n_kept, 1), "skipped": self.accum_steps - n_kept,
                "grad_norm": norm}

    def state(self, names) -> dict:
        """Flat path -> array of the resumable state: the trainable
        parameters (``names`` gives each one's path, in optimizer order),
        AdamW's moments and step counts, and the applied-update count."""
        out = {"count": np.asarray(self.applied, np.int64)}
        for name, p in zip(names, self.params):
            out[f"params/{name}"] = p.detach().cpu().numpy()
            for k, v in self.optimizer.state.get(p, {}).items():
                out[f"opt/{name}/{k}"] = (v.detach().cpu().numpy() if torch.is_tensor(v)
                                          else np.asarray(v))
        return out

    @torch.no_grad()
    def load_state(self, flat: dict, names) -> None:
        """Inverse of ``state``; every parameter's entry must be present."""
        self.applied = int(flat["count"])
        for name, p in zip(names, self.params):
            p.copy_(torch.from_numpy(np.asarray(flat[f"params/{name}"])))
            st = {}
            for k in ("step", "exp_avg", "exp_avg_sq"):
                key = f"opt/{name}/{k}"
                if key in flat:
                    v = torch.from_numpy(np.asarray(flat[key]))
                    st[k] = v.to(torch.float32) if k == "step" else v.to(p.device, p.dtype)
            if st:
                self.optimizer.state[p] = st


def stack_microbatches(batch: dict, accum_steps: int) -> dict:
    """Reshape batch leaves [B, ...] -> [accum, B // accum, ...]."""
    def r(x):
        micro = x.shape[0] // accum_steps
        return x[: accum_steps * micro].reshape(accum_steps, micro, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def pad_eval_batch(batch: dict, multiple: int):
    """Host-side: pad array leaves' leading dim up to a multiple of
    ``multiple`` by repeating the last row (finite values keep softmax
    well-behaved); non-array leaves pass through. Returns (batch, n_real);
    slice every output back to n_real."""

    def is_arr(v):
        return hasattr(v, "shape") and hasattr(v, "dtype") and getattr(v, "ndim", 0) >= 1

    n = next(v.shape[0] for v in batch.values() if is_arr(v))
    if multiple <= 1 or n % multiple == 0:
        return batch, n
    pad = multiple - n % multiple
    out = {}
    for k, v in batch.items():
        if is_arr(v):
            a = np.asarray(v)
            out[k] = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        else:
            out[k] = v
    return out, n


class EarlyStopper:
    """Best-metric tracking + patience early stop."""

    def __init__(self, patience: int, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best = None
        self.best_step = -1
        self.counter = 0

    def update(self, value: float, step: int) -> bool:
        """Returns True when this is a new best."""
        better = (self.best is None
                  or (self.mode == "min" and value < self.best)
                  or (self.mode == "max" and value > self.best))
        if better:
            self.best = value
            self.best_step = step
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience


def stopper_meta(stopper: EarlyStopper) -> dict:
    """The early-stop fields every resumable checkpoint carries."""
    return {"best": stopper.best, "best_epoch": stopper.best_step,
            "patience_counter": stopper.counter}


def restore_stopper(stopper: EarlyStopper, meta: dict) -> None:
    stopper.best = meta.get("best")
    stopper.best_step = int(meta.get("best_epoch", -1))
    stopper.counter = int(meta.get("patience_counter", 0))


class GracefulShutdown:
    """SIGTERM/SIGINT handler for the train loop: the first signal only sets
    ``requested`` (the loop finishes its update, saves the full train state
    and exits so ``--resume`` continues where it stopped) and restores the
    previous handlers, so a second signal behaves as before. install() is a
    no-op off the main thread."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        import logging

        self.requested = True
        logging.warning(f"signal {signum} received: finishing the current update, then "
                        "checkpointing for --resume (signal again to force the previous "
                        "behavior)")
        self.uninstall()

    def install(self):
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self
        for s in (signal.SIGTERM, signal.SIGINT):
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self):
        import signal

        prev, self._prev = self._prev, {}
        for s, h in prev.items():
            signal.signal(s, h)
