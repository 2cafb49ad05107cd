"""Supervised train/eval loop on one device (counterpart of
nextgen_uia_tpu/tasks/supervised.py::run_supervised), parameterized by a
model bundle: AdamW + per-update cosine, validate every ``val_interval``
epochs (the test split also evaluated mid-training), best-by-metric
component checkpoint, early stop, full-state ``--resume`` and SIGTERM
preemption, final test with overlays/ROC + results.csv + timestamped backup.

A bundle provides:
  task            'cls' | 'seg'
  params          the model (nn.ModuleDict of backbone and head)
  trainable_pred  path predicate for the trainable subset
  forward_train(params, batch, gen) -> (logits, augmented masks NCHW int or None)
  forward_eval(params, images_u8)   -> logits
  bn_state        BatchNorm running statistics (a module of buffers) or None
Logits are [B, C] (cls) or [B, C, H, W] (seg). Where the JAX engine threads
the BatchNorm state through the step (forward_train returns it), the port's
train forward updates ``bn_state``'s buffers in place; it is saved beside
the trainable parameters (``bn/...`` in best_model.npz and the resumable
state, the JAX package's names) and the eval forward reads it.
"""

from __future__ import annotations

import argparse
import logging
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import mesh as M
from ..core import train as T
from ..core.experiment import TBWriter, archive_log, backup_folder, save_results_csv
from ..core.partition import flatten_with_paths, partition
from ..data import datasets as D
from ..data import pipeline as P
from ..data.augment import augment_batch
from ..losses import dice_ce_loss, focal_loss
from ..metrics.segmentation import ClsAccumulator, SegAccumulator, one_hot_argmax
from ..ops import KERNELS
from ..utils.viz import plot_roc, roc_figure, visualize_seg


def preprocess(images_u8, masks_u8, args, *, train: bool, gen=None, ops=KERNELS,
               in_channels: int = 3):
    """uint8 [B, H, W] -> float NHWC in [0, 1], augmented on the device in
    train mode when ``args.strong_augs``/``args.weak_augs`` ask for it (from
    the generator ``gen``), the grayscale channel repeated to 3 when
    ``in_channels`` is 3 (kept single otherwise). Returns (x, masks NCHW
    int64 or None)."""
    x = (images_u8.to(torch.float32) / 255.0)[..., None]
    m = None if masks_u8 is None else masks_u8.to(torch.float32)[..., None]
    if train and (args.strong_augs or args.weak_augs):
        if gen is None:
            raise ValueError("augmentation needs a generator on the batch's device")
        with torch.profiler.record_function("augment"):  # a host-time range for profiles
            x, m = augment_batch(gen, x, m, strong=args.strong_augs, weak=args.weak_augs,
                                 out_size=args.img_size, ops=ops)
    if in_channels == 3:
        x = x.expand(-1, -1, -1, 3)
    if m is not None:
        m = m.permute(0, 3, 1, 2).long()
    return x, m


@dataclass
class Bundle:
    task: str
    params: torch.nn.Module
    trainable_pred: Callable[[str], bool]
    forward_train: Callable
    forward_eval: Callable
    bn_state: torch.nn.Module | None = None


def add_fewshot_flags(p):
    """The few-shot trainers' flags: ``--shots_per_class`` (unset: sample
    ``--train_ratio`` of the train split, 10% by default, as the reference
    does) and ``--stratified`` (per class, on by default)."""
    p.add_argument("--shots_per_class", type=int, default=None)
    p.add_argument("--train_ratio", type=float, default=0.1)
    p.add_argument("--stratified", default=True, action=argparse.BooleanOptionalAction)


def apply_fewshot(args, datasets, task: str):
    """Replace the train split by its few-shot subset (``D.sample_few_shot``
    from ``np.random.default_rng(args.seed)``; classes from labels.csv for
    cls) and clamp the batch to the subset's size, as the JAX package does."""
    labels = D.read_labels(args.data_root, args.dataset) if task == "cls" else None
    sampled = D.sample_few_shot(datasets["train"].names, labels or {},
                                rng=np.random.default_rng(args.seed),
                                shots_per_class=args.shots_per_class,
                                train_ratio=args.train_ratio, stratified=args.stratified)
    datasets["train"].names = sampled
    logging.info(f"Few-shot training subset: {len(sampled)} samples")
    args.batch_size = min(args.batch_size, max(len(sampled), 1))


def np_criterion_for(task: str):
    loss = focal_loss if task == "cls" else dice_ce_loss
    return lambda lo, la: float(loss(torch.from_numpy(np.asarray(lo)),
                                     torch.from_numpy(np.asarray(la))))


def to_nchw01(images_u8):
    """Grayscale uint8 [B,H,W] -> NCHW float [0,1] (overlay/TB-grid layout)."""
    return images_u8.astype(np.float32)[:, None, :, :] / 255.0


def finish_cls(args, acc, stats, run_path, fig_name):
    logits, labels = acc.all()
    df_stats = {k: stats[k] for k in ("acc", "rec", "pre", "f1", "auc")}
    logging.info("  ".join(f"{k}={v * 100:.2f}" for k, v in df_stats.items()))
    folder = backup_folder(run_path, "acc", stats["acc"] * 100)
    save_results_csv(df_stats, os.path.join(folder, "results.csv"))
    try:
        plot_roc(logits, labels, os.path.join(folder, f"{fig_name}.png"))
    except ImportError:  # matplotlib is optional: the figure is the only loss
        logging.warning("matplotlib is not installed: no ROC figure")
    archive_log(run_path, folder)
    return folder


def finish_seg(args, stats, names, vis, run_path):
    logging.info(" ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    folder = backup_folder(run_path, "iou", stats["iou_mean"] * 100)
    save_results_csv(stats, os.path.join(folder, "results.csv"), scale100=())
    viz_path = os.path.join(folder, "viz")
    rest = list(names)
    for images_u8, gt, logits in vis:
        visualize_seg(to_nchw01(images_u8), gt, one_hot_argmax(logits), rest[:len(images_u8)],
                      viz_path)
        rest = rest[len(images_u8):]
    archive_log(run_path, folder)
    return folder


def run_supervised(args, bundle: Bundle, datasets, run_path: str, tag: str,
                   device: torch.device, mesh=None):
    """Train (unless ``--test``) and test. ``mesh`` (core/mesh.py) spreads
    both over its processes: each takes its slice of every batch
    (``make_step_for_mesh``; the frozen tower sharded over 'model' when
    ``n_model`` > 1), eval batches are padded to the data-parallel width,
    run per rank and gathered, and rank 0 alone writes logs, checkpoints,
    figures and results."""
    task, params, bn = bundle.task, bundle.params, bundle.bn_state
    trainable, frozen = partition(params, bundle.trainable_pred)
    names = list(trainable)
    main = mesh is None or mesh.is_main
    fsdp = mesh is not None and mesh.n_model > 1
    width = T.dp_width(mesh, frozen if fsdp else None)
    if width > 1 and args.batch_size % width:
        raise ValueError(f"batch_size {args.batch_size} must be divisible by the "
                         f"data-parallel width {width}")
    shards = []  # the train step's model-sharded frozen tower, once it exists

    def bn_flat():
        return {} if bn is None else {f"bn/{k}": v for k, v in flatten_with_paths(bn)}

    def loss_fn(mb, gen):
        logits, masks = bundle.forward_train(params, mb, gen)
        return focal_loss(logits, mb["label"]) if task == "cls" else dice_ce_loss(logits, masks)

    @torch.no_grad()
    def evaluate(split, max_vis_batches=None):
        """max_vis_batches caps how many (image, gt, logits) batches are kept
        host-side: val rounds need at most one, the final test all."""
        accum = (ClsAccumulator if task == "cls" else SegAccumulator)(
            criterion=np_criterion_for(task))
        names_out, vis = [], []
        apply = T.make_sharded_apply(bundle.forward_eval, mesh,
                                     frozen=shards[0] if shards else None)

        def padded():
            for b in P.batches(datasets[split], args.batch_size, shuffle=False,
                               drop_last=False, workers=args.num_workers):
                b, n_real = T.pad_eval_batch(b, apply.dp_width)
                b["n_real"] = n_real
                yield b

        for batch in P.prefetch_to_device(padded(), device=device):
            n = batch["n_real"]
            logits = apply(params, batch["image"]).float().cpu().numpy()[:n]
            if task == "cls":
                accum.update(logits, batch["label"].cpu().numpy()[:n])
            else:
                gt = batch["mask"].cpu().numpy()[:n, None, :, :]
                accum.update(logits, gt)
                names_out.extend(batch["name"][:n])
                if max_vis_batches is None or len(vis) < max_vis_batches:
                    vis.append((batch["image"].cpu().numpy()[:n], gt, logits))
        return accum, names_out, vis

    best_path = os.path.join(run_path if not args.test else
                             os.path.join("runs", args.exp, args.dataset, "train"),
                             "best_model.npz")

    if not args.test:
        n_train = len(datasets["train"])
        steps_per_epoch = max(n_train // args.batch_size, 1)
        tcfg = T.TrainConfig(lr=args.lr, lr_min=args.lr_min, weight_decay=args.weight_decay,
                             beta1=args.beta1, beta2=args.beta2,
                             total_updates=steps_per_epoch * args.epochs)
        step = T.make_step_for_mesh(loss_fn, T.make_optimizer(trainable.values(), tcfg), tcfg,
                                    mesh, frozen=frozen if fsdp else None, bn=bn)
        if getattr(step, "frozen", None) is not None:
            shards.append(step.frozen)
        if width > 1:
            logging.info(f"Data-parallel training over {width} processes"
                         + (f" (frozen tower sharded over model={mesh.n_model})" if fsdp
                            else ""))
        stopper = T.EarlyStopper(args.patience, mode="max")
        writer = TBWriter(os.path.join(run_path, "log") if main else None)
        key_metric = "acc" if task == "cls" else "dice_mean"
        # the dropout stream: torch's, seeded like the JAX package's key
        gen = torch.Generator(device=device).manual_seed(args.seed + 123)
        drop_last = n_train > args.batch_size

        last_path = os.path.join(run_path, "last_state.npz")
        start_epoch, skip_updates = 0, 0
        if args.resume and os.path.exists(last_path):
            flat, meta = ckpt.load_train_state(last_path)
            step.load_state({k[len("train/"):]: v for k, v in flat.items()
                             if k.startswith("train/")}, names)
            if bn is not None:
                ckpt.merge_flat(flat, torch.nn.ModuleDict({"bn": bn}), source=last_path)
            start_epoch = int(meta.get("epoch", 0))
            skip_updates = int(meta.get("updates_into_epoch", 0))
            T.restore_stopper(stopper, meta)
            logging.info(f"Resumed from {last_path} at epoch {start_epoch} "
                         f"({step.applied} updates applied)")

        def save_last(epoch_, updates_into_epoch_):
            if not main:
                return
            flat = {f"train/{k}": v for k, v in step.state(names).items()}
            flat.update({k: v.detach().cpu().numpy() for k, v in bn_flat().items()})
            ckpt.save_train_state(last_path, flat, extra={
                "epoch": epoch_, "updates_into_epoch": updates_into_epoch_,
                "applied_updates": step.applied, **T.stopper_meta(stopper)})

        shutdown = T.GracefulShutdown().install()
        try:
            for epoch in range(start_epoch, args.epochs):
                epoch_loss, nb = 0.0, 0

                def microbatched(skip_batches=0):
                    for batch in P.batches(datasets["train"], args.batch_size, shuffle=True,
                                           drop_last=drop_last, seed=args.seed + epoch,
                                           workers=args.num_workers,
                                           skip_batches=skip_batches):
                        yield T.stack_microbatches(
                            {kk: v for kk, v in batch.items() if kk != "name"}, 1)

                # mid-epoch resume: skip at the index level (no decode cost)
                skip = skip_updates if epoch == start_epoch else 0
                updates_this_epoch = skip
                if skip:
                    logging.info(f"Mid-epoch resume: skipping {skip} already-applied "
                                 f"updates of epoch {epoch + 1}")
                for mb in P.prefetch_to_device(microbatched(skip), device=device):
                    m = step(mb, gen)
                    epoch_loss += m["loss"]
                    nb += 1
                    updates_this_epoch += 1
                    if shutdown.requested:
                        break
                if shutdown.requested:
                    save_last(epoch, updates_this_epoch)
                    logging.warning(f"Preempted at epoch {epoch + 1} after "
                                    f"{updates_this_epoch} updates; train state saved to "
                                    f"{last_path} - rerun with --resume to continue")
                    break
                if nb:
                    writer.scalar("train/loss", epoch_loss / nb, epoch + 1)
                # lr of the last update taken this epoch
                writer.scalar("train/lr", T.cosine_lr_value(tcfg, step.applied - 1), epoch + 1)

                if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
                    accum, _, vis = evaluate("val", max_vis_batches=1 if writer.enabled else 0)
                    stats = accum.compute()
                    val_metric = stats[key_metric]
                    for sk, sv in stats.items():
                        if np.isscalar(sv) or getattr(sv, "ndim", 1) == 0:
                            writer.scalar(f"val/{sk}", float(sv), epoch + 1)
                    if task == "seg" and vis and writer.enabled:
                        images_u8, gt, logits = vis[0]
                        n = min(4, len(images_u8))
                        writer.images("val/input_images", to_nchw01(images_u8[:n]), epoch + 1)
                        writer.images("val/label_images", gt[:n].astype(np.float32), epoch + 1)
                        writer.images("val/pred_images",
                                      np.argmax(logits[:n], axis=1)[:, None].astype(np.float32),
                                      epoch + 1)
                    elif task == "cls" and writer.enabled:
                        try:
                            import matplotlib.pyplot as plt
                        except ImportError:
                            plt = None
                        if plt is not None:
                            fig, _ = roc_figure(*accum.all())
                            writer.figure("val/roc_curve", fig, epoch + 1)
                            plt.close(fig)
                    logging.info(f"Epoch {epoch + 1}: loss={epoch_loss / max(nb, 1):.4f} "
                                 f"val {key_metric}={val_metric:.4f}")
                    if stopper.update(val_metric, epoch) and main:
                        n = ckpt.save_flat(best_path,
                                           {**{f"params/{k}": v for k, v in trainable.items()},
                                            **bn_flat()})
                        logging.info(f"Best model saved ({n} tensors) at epoch {epoch + 1}")
                    taccum, _, _ = evaluate("test")
                    logging.info(f"  [test during training] {key_metric}="
                                 f"{taccum.compute()[key_metric]:.4f}")
                    if stopper.should_stop:
                        logging.info(f"Early stopping at epoch {epoch + 1}")
                # saved before any early-stop break, so last_state reflects this epoch
                save_last(epoch + 1, 0)
                if stopper.should_stop:
                    break
        finally:
            shutdown.uninstall()
        writer.close()
        if shutdown.requested:
            return {"preempted": True}

    M.barrier(mesh)  # rank 0's best_model.npz is written before any rank reads it
    if os.path.exists(best_path):
        tree = {"params": params, **({"bn": bn} if bn is not None else {})}
        _, n = ckpt.load_into(best_path, torch.nn.ModuleDict(tree))
        logging.info(f"Loaded {n} tensors from {best_path}")

    accum, names_out, vis = evaluate("test")
    stats = accum.compute()
    if not main:
        return stats
    if task == "cls":
        finish_cls(args, accum, stats, run_path, f"roc_curve_{tag}")
    else:
        finish_seg(args, stats, names_out, vis, run_path)
    return stats
