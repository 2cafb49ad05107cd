"""Contrastive fine-tuning and image-text retrieval of the CLIP families on
one device (counterpart of nextgen_uia_tpu/tasks/clip_finetune.py).

Methods ``full`` (the default: the towers' own weights train, the last
``--tune_layers`` ViT blocks, or all of the image tower with the default
``all``, the text tower too with ``--tune_text_encoder``, ``logit_scale``
never; the rate clamped to 1e-6 when above 1e-5; both towers at
``mlp_impl='xla'``, so every block runs LayerNorm and the MLP as plain
products around the flash-attention kernel, forward and backward, and no
frozen-weight kernel runs), ``lora`` (LoRA pairs in every vision block,
trained with the q/k/v/o biases of the blocks that hold them) and ``mona``
(MONA adapters); AdamW(0.9, 0.95) with weight decay 0.01 and a cosine rate
per applied update over ceil(steps / accum) * epochs updates, float32
master weights cast per use; gradient accumulation (default 4) with the
non-finite skip and a global-norm clip of 1.0; InfoNCE at the fixed
``--temperature``; the text tower's caption features cached once (or
encoded in the step with ``--no-cache_text_features``, under no_grad,
trimmed to 32-token buckets); validation each epoch through the
forward-only route; the best-by-validation-loss checkpoint holding the
adapter tensors (the whole model under ``full``); early stop; ``--resume``
from the full train state and SIGTERM preemption; ``--chain_zero_shot``
then evaluates the best adapter (or, under ``full``, the best model as
``--backbone_ckpt``) zero-shot on each dataset it names, in the same
process.

A frozen text tower runs forward only: the CLIP text transformer
(openai, metaclip, unimedclip; context 77) through the whole-block kernel
with the causal mask, BiomedCLIP's PubMedBERT (context 256) through its
post-norm kernels (models/bert.py); under ``full`` both take their plain
``mlp_impl='xla'`` routes (the flash-attention kernel, plain products).
With ``--tune_text_encoder`` the text is encoded in the step, never cached,
under autograd with its own dropout stream (the JAX step splits its key
for it): under ``full`` the tower trains; with ``--method lora`` LoRA
pairs sit in BERT's q/k/v/o of the first ``--lora_layers`` layers and
train with those attentions' biases (the LoRA layers' MLP runs the fused
MLP kernel's backward, the layers above them K5 raw-x's); with ``--method
mona`` (and ``lora`` for the OpenAI layout, whose text tower holds no LoRA)
the tower stays frozen and runs its composed route in the step (the CLIP
text blocks: the causal flash-attention kernel and the fused-MLP kernel,
forward only); the validation text goes through the forward-only route.
BiomedCLIP takes the PubMedBERT tokenizer where its HuggingFace files are
cached, else the folded CLIP-BPE fallback, which a full-size run refuses
unless NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1.

``retrieval_main`` encodes an image-caption CSV through both towers,
forward only, and reports Recall@K in both directions, MedR, MeanR and rSum.

Under ``torchrun``, ``--n_data``/``--n_model`` spread both over the
launch's processes (core/mesh.py): each rank takes its slice of every
microbatch, InfoNCE sees the whole batch through the features gathered
from every rank (``T.all_gather_batch`` after ``T.scale_gradient``), the
frozen tower is sharded over 'model' when ``--n_model`` > 1, and rank 0
writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import math
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import mesh as M
from ..core import train as T
from ..core.experiment import TBWriter, model_summary, save_results_csv
from ..core.partition import by_keywords, partition, path_str
from ..data import datasets as D
from ..data import pipeline as P
from ..losses import info_nce
from ..models import clip as clip_mod
from ..ops import KERNELS
from .common import (apply_compat_flags, base_parser, build_clip_model, get_text_tokenizer,
                     require_real_tokenizer, seed_everything, setup_logging, setup_run)


def _finetune_parser(family: str):
    # reference CLI defaults: biomedclip 32 epochs + freq_enhanced MONA, the
    # OpenAI-layout families 1000 epochs + noise_aware
    p = base_parser(f"{family}_finetune", batch_size=64,
                    epochs=32 if family == "biomedclip" else 1000, patience=10,
                    mona_variant="freq_enhanced" if family == "biomedclip" else "noise_aware")
    p.add_argument("--method", type=str, default="full", choices=["full", "mona", "lora"])
    p.add_argument("--tune_text_encoder", default=False, action="store_true")
    p.add_argument("--tune_layers", type=str, default="all",
                   choices=["last3", "last6", "last9", "all"])
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--beta1_adam", type=float, default=0.9)
    p.add_argument("--beta2_adam", type=float, default=0.95)
    p.add_argument("--accumulation_steps", type=int, default=4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--uniformity_weight", type=float, default=0,
                   help="accepted for reference CLI parity; never consumed")
    p.add_argument("--trim_text_padding", default=True, action=argparse.BooleanOptionalAction,
                   help="trim in-step text batches to the real max caption length "
                        "(32-token buckets; exact, see trim_token_padding)")
    p.add_argument("--finetune_csvs", type=str, nargs="*", default=None,
                   help="caption CSVs (default: MedPix + PMC-CURD under data_root)")
    p.add_argument("--finetune_img_dirs", type=str, nargs="*", default=None)
    p.add_argument("--cache_text_features", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="encode every caption once with the frozen text tower and reuse "
                        "the features every step (exact: the tower has no dropout)")
    p.add_argument("--chain_zero_shot", type=str, nargs="*", default=None,
                   help="datasets to evaluate zero-shot with the trained adapter after "
                        "fine-tuning, in the same process")
    return p


def lora_trainable_predicate(params: torch.nn.Module):
    """Trainable = every 'lora' tensor plus the q/k/v/o biases of each
    attention that holds LoRA pairs: the reference re-registers only the
    wrapped projections' weights as frozen, so their biases train (they are
    not saved in the adapter checkpoint, which keeps 'lora' names only)."""
    paths = [path_str(k) for k, _ in params.named_parameters()]
    lora_attn = {p.split("/lora/")[0] for p in paths if "/lora/" in p}
    bias_paths = {f"{a}/{proj}/b" for a in lora_attn for proj in ("q", "k", "v", "o")}
    base = by_keywords("lora")
    return lambda path: base(path) or path in bias_paths


def trim_token_padding(tokens: np.ndarray, *, enabled: bool = True,
                       multiple: int = 32) -> np.ndarray:
    """Trim a padded token batch [B, ctx] to the batch's real max length,
    rounded up to ``multiple``. Exact for both text towers: under the causal
    mask (CLIP) or the -1e9 key-padding bias (BERT) no real token reads a
    padding column, and EOT or CLS pooling never reads a padding row. The
    length is the last nonzero position + 1 (the CLIP BPE emits real id 0
    for '!'), so trailing zeros are the only thing cut."""
    if not enabled:
        return tokens
    nz = tokens != 0
    lengths = np.where(nz.any(axis=1), tokens.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
    lmax = int(lengths.max()) if tokens.size else 0
    bucket = max(((lmax + multiple - 1) // multiple) * multiple, multiple)
    return tokens[:, : min(bucket, tokens.shape[1])]


def full_ft_predicate(args, depth: int = 12):
    """Trainable under ``--method full``: the last ``--tune_layers`` ViT
    blocks, the rest of the image tower only with ``all``, the text tower
    only with ``--tune_text_encoder``, never ``logit_scale`` (the loss uses
    the fixed ``--temperature``, so the reference's AdamW never steps it,
    where a trainable one would be weight-decayed)."""
    first = depth - {"last3": 3, "last6": 6, "last9": 9, "all": depth}[args.tune_layers]

    def pred(path: str) -> bool:
        if path.startswith("text") and not args.tune_text_encoder:
            return False
        if path == "logit_scale":
            return False
        if path.startswith("visual/blocks/"):
            return int(path.split("/")[2]) >= first
        if path.startswith("visual/") and args.tune_layers != "all":
            return False
        return True

    return pred


def full_cfg(cfg):
    """``cfg`` with both towers at ``mlp_impl='xla'``: their weights train,
    so no frozen-weight kernel may run."""
    return cfg.replace(vision=dataclasses.replace(cfg.vision, mlp_impl="xla"),
                       text=dataclasses.replace(cfg.text, mlp_impl="xla"))


def make_text_encoder(params, cfg, device, ops=KERNELS):
    """tokens (numpy or tensor) -> float32 features [B, embed] of the text
    tower, forward only (models/clip.py::infer_cfg): the CLIP text blocks
    through the whole-block kernel with the causal mask, BERT's layers
    through its post-norm kernels; under ``mlp_impl='xla'`` through their
    plain routes (the flash-attention kernel, plain products)."""
    ecfg = clip_mod.infer_cfg(cfg, vision=False)

    @torch.no_grad()
    def encode(tokens):
        toks = tokens if torch.is_tensor(tokens) else torch.from_numpy(np.asarray(tokens))
        return clip_mod.encode_text(params, ecfg, toks.to(device), ops=ops).float()

    return encode


def cache_text_features(encode, tokenizer, captions, ctx: int, chunk: int = 256) -> dict:
    """caption -> float32 feature (numpy) for every caption, ``chunk`` at a
    time through ``encode``."""
    cache = {}
    for s in range(0, len(captions), chunk):
        part = captions[s:s + chunk]
        feats = encode(tokenizer(part, ctx)).cpu().numpy()
        cache.update(zip(part, feats))
    return cache


def finetune_main(family: str, argv=None):
    args = _finetune_parser(family).parse_args(argv)
    apply_compat_flags(args)
    mesh = M.make_mesh(args.n_data, args.n_model, device=args.device)
    device, main = mesh.device, mesh.is_main
    gen = seed_everything(args.seed)
    run_path = os.path.join("runs", args.exp)
    setup_logging(run_path, args)
    if args.method == "full" and args.lr > 1e-5:
        args.lr = 1e-6
        logging.info(f"Adjusted learning rate to {args.lr} for full fine-tuning")

    adapter = args.method if args.method in ("mona", "lora") else None
    cfg, params = build_clip_model(args, family, adapter=adapter, gen=gen)
    if args.method == "full":
        cfg = full_cfg(cfg)
    tokenizer = get_text_tokenizer(args, family)
    require_real_tokenizer(args, tokenizer, family)
    if args.method == "mona":
        pred = by_keywords("mona")
    elif args.method == "lora":
        pred = lora_trainable_predicate(params)
    else:
        pred = full_ft_predicate(args, depth=cfg.vision.depth)
    trainable, frozen = partition(params, pred)
    names = list(trainable)
    logging.info(model_summary({"model": params}, trainable_pred=pred))

    csvs, img_dirs = args.finetune_csvs, args.finetune_img_dirs
    if not csvs:
        base = os.path.join(args.data_root, "finetune")
        csvs = [os.path.join(base, "medpix_dataset", "medpix_dataset.csv"),
                os.path.join(base, "pmc_curd_dataset", "pmc_curd_dataset.csv")]
        img_dirs = [os.path.join(base, "medpix_dataset", "images"),
                    os.path.join(base, "pmc_curd_dataset", "images")]
        csvs = [c for c in csvs if os.path.exists(c)]
    train_rows, val_rows = D.load_finetune_rows(csvs, img_dirs, seed=args.seed)
    train_ds = D.FinetuneDataset(train_rows, args.img_size)
    val_ds = D.FinetuneDataset(val_rows, args.img_size)
    logging.info(f"Train samples: {len(train_ds)}, Val samples: {len(val_ds)}")

    ctx = cfg.text.context_length
    accum = args.accumulation_steps
    # with the frozen tower sharded over 'model' the batch splits over every
    # rank: the data-parallel width is the whole grid
    fsdp = mesh.n_model > 1
    width = T.dp_width(mesh, frozen if fsdp else None)
    if width > 1 and (args.batch_size // accum) % width:
        raise ValueError(f"microbatch size {args.batch_size // accum} (batch_size / "
                         f"accumulation_steps) must be divisible by the data-parallel width "
                         f"{width}")
    steps = max(len(train_ds) // args.batch_size, 1)
    total_updates = math.ceil(steps / accum) * args.epochs
    logging.info(f"Updates per epoch: {math.ceil(steps / accum)}; total: {total_updates}")
    tcfg = T.TrainConfig(lr=args.lr, lr_min=args.lr_min, weight_decay=args.weight_decay,
                         beta1=args.beta1_adam, beta2=args.beta2_adam,
                         total_updates=total_updates)
    params.to(device)
    eval_cfg = clip_mod.infer_cfg(cfg)
    encode_text = make_text_encoder(params, cfg, device)
    use_text_cache = args.cache_text_features and not args.tune_text_encoder
    text_cache = {}
    if use_text_cache:
        captions = sorted({c for rows in (train_rows, val_rows) for _, c in rows})
        text_cache = cache_text_features(encode_text, tokenizer, captions, ctx)
        logging.info(f"Cached text features for {len(captions)} captions")

    def text_features(batch):
        return batch["txt_feat"] if use_text_cache else encode_text(batch["tokens"])

    # the text tower's own dropout stream under --tune_text_encoder
    text_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    def loss_fn(mb, g):
        x = mb["image"].to(torch.float32) / 255.0
        img_feats, _ = clip_mod.encode_image(params, cfg, x, gen=g)
        if args.tune_text_encoder:
            txt_feats = clip_mod.encode_text(params, cfg, mb["tokens"], gen=text_gen)
        else:
            txt_feats = text_features(mb)
        if width > 1:
            # global-batch negatives: every rank's features gathered, so
            # InfoNCE sees the whole microbatch at any width; scale_gradient
            # undoes the step's mean over the ranks (each rank's gradient is
            # only its own samples' part of the shared loss)
            img_feats = T.all_gather_batch(T.scale_gradient(img_feats, float(width)), mesh)
            txt_feats = T.all_gather_batch(T.scale_gradient(txt_feats, float(width)), mesh)
        return info_nce(img_feats, txt_feats, temperature=args.temperature)

    step = T.make_step_for_mesh(loss_fn, T.make_optimizer(trainable.values(), tcfg), tcfg,
                                mesh, accum_steps=accum, grad_clip=args.grad_clip,
                                frozen=frozen if fsdp else None)
    shards = getattr(step, "frozen", None)
    # validation encodes the images data-parallel over the same grid, then
    # takes the exact InfoNCE over the whole batch
    encode_val = T.make_sharded_apply(
        lambda p, x: clip_mod.encode_image(p, eval_cfg, x.to(torch.float32) / 255.0)[0], mesh,
        frozen=shards)

    @torch.no_grad()
    def val_loss(batch):
        images = batch["image"]
        img_feats = encode_val(params, T.pad_rows(images, encode_val.dp_width))[:len(images)]
        with shards.gathered() if shards is not None else contextlib.nullcontext():
            txt = text_features(batch)
        return float(info_nce(img_feats, txt, temperature=args.temperature))

    def tokenized_batches(ds, shuffle, drop_last, seed, skip_batches=0):
        for b in P.batches(ds, args.batch_size, shuffle=shuffle, drop_last=drop_last,
                           seed=seed, workers=args.num_workers, skip_batches=skip_batches):
            if use_text_cache:
                b["txt_feat"] = np.stack([text_cache[c] for c in b["caption"]])
            else:
                b["tokens"] = trim_token_padding(np.asarray(tokenizer(b["caption"], ctx)),
                                                 enabled=args.trim_text_padding)
            del b["caption"]
            yield b

    writer = TBWriter(os.path.join(run_path, "log") if main else None)
    stopper = T.EarlyStopper(args.patience, mode="min")
    best_path = os.path.join(run_path, "best_model.npz")
    last_path = os.path.join(run_path, "last_state.npz")
    # the adapter tensors, or under full the whole model
    ckpt_keywords = None if args.method == "full" else [args.method]
    # the dropout stream: torch's, seeded like the JAX package's key
    drop_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    update_count, start_epoch, skip_updates = 0, 0, 0
    if args.resume and os.path.exists(last_path):
        flat, meta = ckpt.load_train_state(last_path)
        step.load_state(flat, names)
        start_epoch = int(meta.get("epoch", 0))
        skip_updates = int(meta.get("updates_into_epoch", 0))
        update_count = int(meta.get("update_count", 0))
        T.restore_stopper(stopper, meta)
        logging.info(f"Resumed from {last_path} at epoch {start_epoch} "
                     f"({step.applied} updates applied)")

    def save_last(epoch_, updates_into_epoch_):
        if not main:
            return
        ckpt.save_train_state(last_path, step.state(names), extra={
            "epoch": epoch_, "updates_into_epoch": updates_into_epoch_,
            "update_count": update_count, "applied_count": step.applied,
            **T.stopper_meta(stopper)})

    shutdown = T.GracefulShutdown().install()
    try:
        for epoch in range(start_epoch, args.epochs):
            epoch_loss, nb = 0.0, 0
            # mid-epoch resume: the epoch's batch order is seeded, so skipping
            # at the index level replays exactly the batches not yet consumed
            skip = skip_updates if epoch == start_epoch else 0
            updates_this_epoch = skip
            if skip:
                logging.info(f"Mid-epoch resume: skipping {skip} already-applied updates of "
                             f"epoch {epoch + 1}")
            batches = (T.stack_microbatches(b, accum) for b in tokenized_batches(
                train_ds, True, True, args.seed + epoch, skip_batches=skip))
            for mb in P.prefetch_to_device(batches, device=device):
                m = step(mb, drop_gen)
                update_count += 1
                updates_this_epoch += 1
                epoch_loss += m["loss"]
                nb += 1
                writer.scalar("train/loss_per_update", m["loss"], update_count)
                writer.scalar("train/lr", T.cosine_lr_value(tcfg, step.applied - 1),
                              update_count)
                if m["skipped"]:
                    logging.warning(f"{m['skipped']} non-finite microbatches skipped at "
                                    f"update {update_count}")
                if shutdown.requested:
                    break
            if shutdown.requested:
                save_last(epoch, updates_this_epoch)
                logging.warning(f"Preempted at epoch {epoch + 1} after {updates_this_epoch} "
                                f"updates; train state saved to {last_path} - rerun with "
                                "--resume to continue")
                break

            val_losses = [val_loss(b) for b in P.prefetch_to_device(
                tokenized_batches(val_ds, False, False, None), device=device)]
            val_losses = [v for v in val_losses if np.isfinite(v)]
            avg_val = float(np.mean(val_losses)) if val_losses else float("inf")
            if not val_losses:
                logging.warning("All validation losses non-finite this epoch")
            writer.scalar("val/loss_per_epoch", avg_val, epoch + 1)
            if nb:
                writer.scalar("train/loss_per_epoch", epoch_loss / nb, epoch + 1)
            train_str = f"{epoch_loss / nb:.4f}" if nb else "n/a (resumed at boundary)"
            best = stopper.best if stopper.best is not None else float("inf")
            logging.info(f"Epoch {epoch + 1}: Train={train_str}, Val={avg_val:.4f}, "
                         f"Best={best:.4f}")
            if stopper.update(avg_val, epoch) and main:
                n = ckpt.save(best_path, params, keyword_filter=ckpt_keywords)
                logging.info(f"Best model saved ({n} tensors) at epoch {epoch + 1} with "
                             f"validation loss {stopper.best:.4f}")
            save_last(epoch + 1, 0)
            if stopper.should_stop:
                logging.info(f"Early stopping at epoch {epoch + 1}")
                break
    finally:
        shutdown.uninstall()
    writer.close()
    if shutdown.requested:
        return {"preempted": True, "best_val_loss": stopper.best,
                "best_epoch": stopper.best_step}
    logging.info(f"Training completed. Best val loss {stopper.best:.4f} at epoch "
                 f"{stopper.best_step + 1}")
    M.barrier(mesh)  # rank 0's best_model.npz is written before any rank reads it
    if args.chain_zero_shot:
        chain_zero_shot(args, family, best_path)
    return {"best_val_loss": stopper.best, "best_epoch": stopper.best_step}


def chain_zero_shot(args, family: str, best_path: str):
    """Zero-shot evaluation of the best adapter (under ``full``, the best
    model as ``--backbone_ckpt``) on each dataset of ``--chain_zero_shot``,
    with the JAX package's argument list (and this run's ``--device``)."""
    from .clip_tasks import zero_shot_main

    weight_flag = {"mona": "--mona_weights", "lora": "--lora_weights",
                   "full": "--backbone_ckpt"}[args.method]
    for ds in args.chain_zero_shot:
        logging.info(f"Chaining zero-shot evaluation on {ds}")
        zs_argv = ["--exp", f"{args.exp}_zero_shot", "--dataset", ds,
                   "--data_root", args.data_root, "--img_size", str(args.img_size),
                   "--seed", str(args.seed), "--device", args.device, weight_flag, best_path]
        if args.method == "mona":
            zs_argv += ["--mona_variant", args.mona_variant]
        if args.backbone_ckpt and args.method != "full":
            zs_argv += ["--backbone_ckpt", args.backbone_ckpt]
        if args.debug_tiny:
            zs_argv += ["--debug_tiny"]
        zero_shot_main(family, zs_argv)


def retrieval_metrics(sim: np.ndarray, k_values=(1, 2, 5, 10)):
    """sim [N_img, N_txt] with the true pairs on the diagonal -> image-to-text
    and text-to-image Recall@K for each K (in percent), MedR and MeanR, and
    rSum, the sum of all 2 * len(K) recalls. A tie ranks by index (numpy's
    argsort of -sim)."""
    k_values = tuple(int(k) for k in k_values)

    def directed(s):
        order = np.argsort(-s, axis=1)
        ranks = np.empty(s.shape[0])
        for i in range(s.shape[0]):
            ranks[i] = np.nonzero(order[i] == i)[0][0]
        out = {f"r{k}": float(np.mean(ranks < k) * 100) for k in k_values}
        out["medr"] = float(np.median(ranks) + 1)
        out["meanr"] = float(np.mean(ranks) + 1)
        return out

    i2t = directed(sim)
    t2i = directed(sim.T)
    rsum = sum(i2t[f"r{k}"] for k in k_values) + sum(t2i[f"r{k}"] for k in k_values)
    return {"i2t": i2t, "t2i": t2i, "rsum": rsum}


def make_pair_features(cfg):
    """(params, images_u8 [B, H, W, 3], tokens [B, ctx]) -> (image, text)
    float32 L2-normalised features, forward only: both towers' blocks
    through the whole-block kernel (``infer_cfg``)."""
    ecfg = clip_mod.infer_cfg(cfg)

    @torch.inference_mode()
    def features(params, images_u8, tokens, ops=KERNELS):
        img, _ = clip_mod.encode_image(params, ecfg, images_u8.to(torch.float32) / 255.0,
                                       ops=ops)
        txt = clip_mod.encode_text(params, ecfg, tokens, ops=ops)
        return clip_mod.normalize(img), clip_mod.normalize(txt)

    return features


def retrieval_main(family: str, argv=None):
    """Image-text retrieval over a CSV of (image file, caption) pairs
    (reference CLI defaults: batch 128, seed 42); results.csv holds the
    recalls, MedR, MeanR and rSum."""
    p = base_parser(f"{family}_retrieval", batch_size=128, seed=42)
    p.add_argument("--csv", type=str, required=False, default=None,
                   help="CSV with filename,Caption columns (e.g. ROCO-v2 test)")
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--caption_key", type=str, default="Caption")
    p.add_argument("--img_key", type=str, default="filename")
    p.add_argument("--k_values", type=int, nargs="+", default=[1, 2, 5, 10],
                   help="K values for the Recall@K metrics")
    p.add_argument("--model_name", type=str, default=None,
                   help="accepted for parity; the family fixes the model")
    p.add_argument("--split", type=str, default="test",
                   help="accepted for parity; the CSV given via --csv is the evaluated split")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="accepted for parity; unused (no dataset download)")
    p.add_argument("--output_dir", type=str, default=None,
                   help="directory for results.csv (default: the run path)")
    p.add_argument("--max_samples", type=int, default=None,
                   help="cap the number of evaluated pairs")
    p.add_argument("--save_features", default=False, action="store_true",
                   help="also save the image and text features as features.npz")
    args = p.parse_args(argv)
    apply_compat_flags(args)
    # encoding spreads over every process of the launch, data-parallel
    mesh = M.make_mesh(args.n_data, args.n_model, device=args.device)
    device = mesh.device
    gen = seed_everything(args.seed)
    run_path = setup_run(args, "test")

    adapter = "lora" if args.lora_weights else ("mona" if args.mona_weights else None)
    cfg, params = build_clip_model(args, family, adapter=adapter, gen=gen)
    tokenizer = get_text_tokenizer(args, family)
    require_real_tokenizer(args, tokenizer, family)

    import pandas as pd

    rows = []
    for _, r in pd.read_csv(args.csv).iterrows():
        path = os.path.join(args.img_dir or ".", os.path.basename(str(r[args.img_key])))
        if os.path.exists(path):
            rows.append((path, D.clean_caption(r[args.caption_key])))
    if args.max_samples is not None:
        rows = rows[: args.max_samples]
    ds = D.FinetuneDataset(rows, args.img_size)
    logging.info(f"Retrieval set: {len(ds)} pairs")

    ctx = cfg.text.context_length
    params.to(device)
    features = T.make_sharded_apply(make_pair_features(cfg), mesh)

    def tokenized():
        for b in P.batches(ds, args.batch_size, shuffle=False, drop_last=False,
                           workers=args.num_workers):
            b, n_real = T.pad_eval_batch({"image": b["image"], "tokens": np.asarray(
                tokenizer(b["caption"], ctx))}, features.dp_width)
            b["n_real"] = n_real
            yield b

    all_img, all_txt = [], []
    for batch in P.prefetch_to_device(tokenized(), device=device):
        n = batch["n_real"]
        fi, ft = features(params, batch["image"], batch["tokens"])
        all_img.append(fi[:n].cpu().numpy())
        all_txt.append(ft[:n].cpu().numpy())

    img_feats, txt_feats = np.concatenate(all_img), np.concatenate(all_txt)
    m = retrieval_metrics(img_feats @ txt_feats.T, k_values=args.k_values)
    flat = {f"i2t_{k}": v for k, v in m["i2t"].items()}
    flat.update({f"t2i_{k}": v for k, v in m["t2i"].items()})
    flat["rsum"] = m["rsum"]
    logging.info("  ".join(f"{k}={v:.2f}" for k, v in flat.items()))
    if not mesh.is_main:
        return flat
    out_dir = args.output_dir or run_path
    os.makedirs(out_dir, exist_ok=True)
    save_results_csv(flat, os.path.join(out_dir, "results.csv"), scale100=())
    if args.save_features:
        np.savez(os.path.join(out_dir, "features.npz"), image_features=img_feats,
                 text_features=txt_feats)
    return flat
