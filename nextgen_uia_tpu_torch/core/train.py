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

import contextlib
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
        total, loss_sum, kept = self._accumulate(batch, gen)
        total /= torch.clamp(kept, min=1.0)
        return self._update(total, loss_sum / torch.clamp(kept, min=1.0), kept,
                            self.accum_steps - kept)

    def _accumulate(self, batch: dict, gen):
        """(the kept microbatches' summed gradients as one float32 buffer,
        their summed loss, their count), on the device."""
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
        return total, loss_sum, kept

    def _update(self, total, loss, kept, skipped) -> dict:
        """Clip the averaged gradient buffer ``total``, hand it to the
        parameters and take the update unless ``kept`` is 0; the host reads
        the scalars once."""
        params = self.params
        grad_norm = torch.linalg.vector_norm(total)
        if self.grad_clip > 0:
            total *= torch.clamp(self.grad_clip / torch.clamp(grad_norm, min=1e-12), max=1.0)
        n_kept, loss, norm, skipped = torch.stack(
            [kept, loss, grad_norm, torch.as_tensor(skipped, device=kept.device).float()]
        ).tolist()
        for p, g in zip(params, torch.split(total, [p.numel() for p in params])):
            p.grad = g.view_as(p).to(p.dtype)
        if n_kept:
            for group in self.optimizer.param_groups:
                group["lr"] = cosine_lr_value(self.cfg, self.applied)
            self.optimizer.step()
            self.applied += 1
        return {"loss": loss, "skipped": int(skipped), "grad_norm": norm}

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


class FrozenShards:
    """The frozen tensors sharded over the mesh's 'model' axis (the JAX
    package's ``shard_params`` + ``gather_from_specs``): between steps each
    one holds this rank's slice (``mesh.shard``); ``gathered()`` makes them
    whole (one ``all_gather_into_tensor`` each over the data index's
    subgroup) for the body of a ``with``, and puts the slices back after.
    They get no gradient, so nothing is reduce-scattered."""

    def __init__(self, frozen: dict, mesh):
        from .mesh import param_pspecs, shard

        self.mesh = mesh
        specs = param_pspecs(frozen, mesh)
        self.items = [(p, specs[path]) for path, p in frozen.items() if specs[path]]
        with torch.no_grad():
            for p, spec in self.items:
                p.data = shard(p.data, spec, mesh)

    @contextlib.contextmanager
    def gathered(self):
        from .mesh import gather, shard

        with torch.no_grad():
            for p, spec in self.items:
                p.data = gather(p.data, spec, self.mesh)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, spec in self.items:
                    p.data = shard(p.data, spec, self.mesh)


def _dp(mesh, fsdp: bool):
    """(width, this rank's index) of the data-parallel split: every rank
    when the frozen tower is model-sharded (the batch splits over both
    axes), else the 'data' axis (the 'model' ranks of a data index
    compute the same slice)."""
    return (mesh.world, mesh.rank) if fsdp else (mesh.n_data, mesh.data_index)


def local_slice(x, width: int, index: int, dim: int = 0):
    """The ``index``-th of ``width`` contiguous equal slices of x along
    ``dim``."""
    n = x.shape[dim]
    if n % width:
        raise ValueError(f"batch of {n} does not split over a data-parallel width of {width}")
    return x.narrow(dim, index * (n // width), n // width)


def rank_generator(gen, index: int):
    """A generator for this data-parallel rank (the JAX package's
    ``fold_in(rng, shard_idx)``): seeded from one draw of the caller's
    ``gen``, which every rank advances alike, and the rank's index."""
    if gen is None:
        return None
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=gen.device).manual_seed((seed * 1000003 + index) % 2 ** 63)


class ShardedTrainStep(TrainStep):
    """One update over several processes (``make_sharded_train_step``, the
    counterpart of the JAX package's shard_map step): each rank takes its
    contiguous slice of every microbatch ([accum, global_micro, ...] ->
    [accum, global_micro / width, ...]), draws its randomness from
    ``rank_generator``, accumulates its kept microbatches' gradients in the
    flat float32 buffer and divides by its kept count; then one
    ``all_reduce`` SUM over every rank, divided by the world, averages the
    gradients and the loss (pmean), one ``all_reduce`` MAX takes the kept
    and skipped counts (pmax: the update is skipped only when every rank
    kept nothing), and each rank clips and applies the same update. With
    ``frozen`` (FrozenShards) the frozen tower is gathered whole once per
    step and the batch splits over every rank; ``bn`` (a module) has its
    floating buffers, BatchNorm's running statistics, averaged after the
    step (pmean of the aux)."""

    def __init__(self, loss_fn, optimizer, cfg, mesh, *, accum_steps: int = 1,
                 grad_clip: float = 0.0, frozen: FrozenShards | None = None, bn=None):
        super().__init__(loss_fn, optimizer, cfg, accum_steps=accum_steps, grad_clip=grad_clip)
        self.mesh, self.frozen, self.bn = mesh, frozen, bn
        self.width, self.index = _dp(mesh, frozen is not None and mesh.n_model > 1)

    def __call__(self, batch: dict, gen=None) -> dict:
        import torch.distributed as dist

        batch = {k: local_slice(v, self.width, self.index, 1) for k, v in batch.items()}
        gen = rank_generator(gen, self.index)
        with self.frozen.gathered() if self.frozen is not None else contextlib.nullcontext():
            total, loss_sum, kept = self._accumulate(batch, gen)
        denom = torch.clamp(kept, min=1.0)
        buf = torch.cat([total / denom, (loss_sum / denom).reshape(1)])
        counts = torch.stack([kept, self.accum_steps - kept])
        if self.mesh.distributed:
            dist.all_reduce(buf)
            buf /= self.mesh.world
            dist.all_reduce(counts, op=dist.ReduceOp.MAX)
            if self.bn is not None:
                for b in self.bn.buffers():
                    if b.is_floating_point():
                        dist.all_reduce(b)
                        b /= self.mesh.world
        return self._update(buf[:-1], buf[-1], counts[0], counts[1])


def make_sharded_train_step(loss_fn, optimizer, cfg, mesh, *, accum_steps: int = 1,
                            grad_clip: float = 0.0, frozen=None, bn=None) -> ShardedTrainStep:
    """The data-parallel step over ``mesh``'s processes (ShardedTrainStep),
    with the flat path -> tensor dict ``frozen`` sharded over 'model' when
    the mesh has a model axis (``FrozenShards``, in place)."""
    shards = FrozenShards(frozen, mesh) if frozen and mesh.n_model > 1 else None
    return ShardedTrainStep(loss_fn, optimizer, cfg, mesh, accum_steps=accum_steps,
                            grad_clip=grad_clip, frozen=shards, bn=bn)


def make_step_for_mesh(loss_fn, optimizer, cfg, mesh=None, *, accum_steps: int = 1,
                       grad_clip: float = 0.0, frozen=None, bn=None):
    """The plain TrainStep when one process takes part (no model-sharded
    frozen tower), else ``make_sharded_train_step``. ``frozen`` (flat path
    -> tensor) shards the frozen tower over 'model' when the mesh's model
    axis is > 1; the batch then splits over every rank."""
    fsdp = mesh is not None and mesh.n_model > 1 and bool(frozen)
    if mesh is None or (mesh.n_data <= 1 and not fsdp):
        return TrainStep(loss_fn, optimizer, cfg, accum_steps=accum_steps, grad_clip=grad_clip)
    return make_sharded_train_step(loss_fn, optimizer, cfg, mesh, accum_steps=accum_steps,
                                   grad_clip=grad_clip, frozen=frozen if fsdp else None,
                                   bn=bn)


def dp_width(mesh, frozen=None) -> int:
    """The data-parallel width batches are split over (and eval batches
    padded to a multiple of): every rank under a model-sharded frozen
    tower, else the 'data' axis."""
    return 1 if mesh is None else _dp(mesh, frozen is not None and mesh.n_model > 1)[0]


def _gather_rows(t, mesh):
    import torch.distributed as dist

    out = torch.empty((mesh.world * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous())
    return out


def make_sharded_apply(fn, mesh=None, *, frozen: FrozenShards | None = None):
    """Data-parallel evaluation and serving (the eval-side counterpart of
    the sharded step): ``apply(params, *batch)`` runs ``fn`` on this
    rank's contiguous slice of every tensor of ``batch`` (their leading dim
    a multiple of ``apply.dp_width``: pad ragged batches with
    ``pad_eval_batch`` and slice outputs back; other arguments pass
    through), then gathers every output leaf (a tensor or a
    tuple of them, batch-leading) from every rank in rank order. With
    ``frozen`` the model-sharded frozen tower is gathered whole around the
    call. On one process it is ``fn``."""
    width, index = _dp(mesh, frozen is not None) if mesh is not None else (1, 0)

    def apply(params, *batch, **kw):
        if width <= 1 and not (mesh is not None and mesh.distributed):
            return fn(params, *batch, **kw)
        local = [local_slice(t, width, index) if torch.is_tensor(t) else t for t in batch]
        with frozen.gathered() if frozen is not None else contextlib.nullcontext():
            out = fn(params, *local, **kw)
        if width <= 1:
            return out
        # every rank's slice, in rank order; the 'model' replicas of a data
        # index (no frozen sharding) hold the same rows, so keep one of each
        step = mesh.world // width
        pick = (lambda t: _gather_rows(t, mesh).reshape(width, step, *t.shape)[:, 0]
                .reshape(width * t.shape[0], *t.shape[1:]))
        return tuple(map(pick, out)) if isinstance(out, tuple) else pick(out)

    apply.dp_width = width
    return apply


def scale_gradient(x, s: float):
    """Identity on the forward pass; multiplies the gradient by ``s``: a
    rank's loss computed from features gathered over every rank sees only
    its own samples' part of the gradient, which the step's mean over the
    ranks then divides by their number; pre-scaling by it makes the mean
    the whole batch's gradient."""
    return x * s + (x * (1.0 - s)).detach()


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        # the transpose of a tiled all-gather is a psum-scatter: every
        # rank's gradient of the gathered rows summed, this rank's rows kept
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return local_slice(g, ctx.mesh.world, ctx.mesh.rank), None


def all_gather_batch(x, mesh):
    """x [n, ...] of every rank concatenated in rank order, [world * n,
    ...], differentiable (the JAX package's tiled ``all_gather`` over the
    data-parallel axes); x itself on one process."""
    if mesh is None or not mesh.distributed:
        return x
    return _GatherBatch.apply(x, mesh)


def pad_rows(x, multiple: int):
    """On the device: x's leading dim padded up to a multiple of
    ``multiple`` by repeating its last row (``pad_eval_batch`` for a tensor)."""
    pad = -x.shape[0] % multiple
    return x if not pad else torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


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
