"""Batch inference CLI (counterpart of nextgen_uia_tpu/tasks/serve.py): for
the CLIP families ``--task zero_shot`` (the default: the dataset's prompt
ensemble, no head weights) and the supervised ``--task cls`` / ``--task
seg`` (with MONA or LoRA weights), and the supervised-engine bundles of the
DINOv2, CLIPSeg and baselines families (served through the same
``forward_eval`` the trainer evaluates with, the BatchNorm statistics
loaded from ``bn/`` beside the parameters; CLIPSeg's only task is seg, the
baselines' cls is the ResNet and seg the UNet).

Point it at a directory (or a .txt list) of images; it decodes them to
uint8 grayscale batches, stages them on the device, runs the model forward
and writes predictions.csv (zero_shot, cls; the prompt classes name the
zero-shot columns) or <index>_<stem>_mask.png plus index.csv (seg). The
model is assembled exactly as the JAX package assembles it
(``--backbone_ckpt``, ``--mona_weights``, ``--lora_weights``,
``--head_weights``, ``--decoder_ckpt``, the same ``.npz`` files), on one
device given by ``--device``. A block with LoRA serves through the composed
route: the whole-block kernel does not take it.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import train as T
from ..data import pipeline as P
from ..models import clip as clip_mod
from ..ops import KERNELS
from . import other_tasks as OT
from . import prompts as PR
from .clip_tasks import (_build_supervised, _make_forward, build_text_features,
                         make_zero_shot_logits_fn)
from .common import (apply_compat_flags, base_parser, build_clip_model, get_text_tokenizer,
                     not_ported, require_real_tokenizer, resolve_device, seed_everything,
                     setup_logging)

# supervised-engine families: (family, task) -> (dataset-free bundle factory,
# the flag adder its parser needs)
BUNDLE_FAMILIES = {
    ("dino", "cls"): (OT.build_dino_cls_bundle, OT.add_dino_flags),
    ("dino", "seg"): (OT.build_dino_seg_bundle, OT.add_dino_flags),
    ("clipseg", "seg"): (OT.build_clipseg_bundle, OT.add_clipseg_flags),
    ("baselines", "cls"): (OT.build_baseline_cls_bundle, OT.add_baseline_cls_flags),
    ("baselines", "seg"): (OT.build_baseline_seg_bundle, OT.add_baseline_seg_flags),
}

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def collect_images(spec: str) -> list[str]:
    """A directory (recursive, sorted) or a .txt file of paths."""
    if os.path.isdir(spec):
        out = []
        for root, _, files in os.walk(spec):
            out.extend(os.path.join(root, f) for f in files
                       if f.lower().endswith(IMG_EXTS))
        return sorted(out)
    if spec.endswith(".txt"):
        with open(spec) as f:
            return [ln.strip() for ln in f if ln.strip()]
    raise SystemExit(f"--images must be a directory or a .txt list: {spec}")


def _batches(paths, batch_size, img_size, workers):
    """Decoded uint8 grayscale batches [B, H, W] in path order. An
    unreadable file decodes to zeros and is reported in the per-image ``ok``
    mask (status=decode_error in the output csv)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data.datasets import load_image

    def safe_load(p):
        try:
            return load_image(p, img_size), True
        except Exception as e:  # noqa: BLE001 - any decode failure
            logging.warning(f"decode failed for {p}: {e}")
            return np.zeros((img_size, img_size), np.uint8), False

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as ex:
        for s in range(0, len(paths), batch_size):
            part = paths[s:s + batch_size]
            loaded = list(ex.map(safe_load, part))
            yield part, np.stack([im for im, _ in loaded]), [ok for _, ok in loaded]


def make_infer(forward, params, device):
    """The per-batch serving function: uint8 images [B, H, W] on ``device``
    -> logits, forward-only."""

    @torch.inference_mode()
    def infer(images_u8, ops=KERNELS):
        return forward(params, images_u8.to(device), ops)

    return infer


def predict_main(family: str = "biomedclip", argv=None):
    import argparse

    is_clip = family in clip_mod.FAMILIES
    if not is_clip and not any(f == family for f, _ in BUNDLE_FAMILIES):
        raise ValueError(f"no predict CLI serves the {family!r} family (the CLIP families "
                         f"{sorted(clip_mod.FAMILIES)}, or "
                         f"{sorted({f for f, _ in BUNDLE_FAMILIES})})")
    default_task = "zero_shot" if is_clip else ("seg" if family == "clipseg" else "cls")
    tasks = (["zero_shot", "cls", "seg"] if is_clip
             else sorted(t for f, t in BUNDLE_FAMILIES if f == family))
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--task", type=str, default=default_task)
    task = pre.parse_known_args(argv)[0].task
    if task not in tasks:
        raise SystemExit(f"{family} predict supports --task {tasks}, not {task!r}")

    p = base_parser(f"{family}_predict", batch_size=32)
    p.add_argument("--task", type=str, default=default_task, choices=tasks)
    if family == "dino":
        OT.add_dino_flags(p, seg=task == "seg")
    elif not is_clip:
        BUNDLE_FAMILIES[(family, task)][1](p)
    p.add_argument("--images", type=str, required=True,
                   help="directory of images or a .txt list of paths")
    p.add_argument("--out", type=str, default=None,
                   help="output directory (default runs/serve/<exp>)")
    p.add_argument("--class_names", type=str, default=None,
                   help="comma-separated class names for csv headers (default: the "
                        "zero-shot prompt classes, or the class indices)")
    p.add_argument("--export", type=str, default=None,
                   help="not ported (ROADMAP.md, section A, item 14)")
    args = p.parse_args(argv)
    apply_compat_flags(args)
    if args.export:
        raise not_ported("--export", "section A, item 14")
    if args.n_model != 1 or (args.n_data or 1) != 1:
        raise not_ported("--n_model/--n_data (multi-device serving)", "section A, item 14")
    device = resolve_device(args.device)
    gen = seed_everything(args.seed)

    out_dir = args.out or os.path.join("runs", "serve", args.exp)
    os.makedirs(out_dir, exist_ok=True)
    setup_logging(out_dir, args)
    paths = collect_images(args.images)
    if not paths:
        raise SystemExit(f"no images found under {args.images}")
    logging.info(f"Serving {len(paths)} images -> {out_dir} on {device}")

    if args.task == "zero_shot":
        adapter = "lora" if args.lora_weights else ("mona" if args.mona_weights else None)
        cfg, params = build_clip_model(args, family, adapter=adapter, gen=gen)
        tokenizer = get_text_tokenizer(args, family)
        require_real_tokenizer(args, tokenizer, f"{family} predict")
        params.to(device)
        classes = list(PR.LESION_TYPES)
        text_feats = build_text_features(params, cfg, tokenizer,
                                         PR.prompt_ensemble_for(args.dataset), classes=classes)
        logits_fn = make_zero_shot_logits_fn(cfg, text_feats, classes=classes)
        infer = make_infer(lambda p, x, ops: logits_fn(p, x, ops)[0], params, device)
        _run_cls(paths, args, infer, device, _names(args, classes), out_dir)
        return {"n_images": len(paths), "out": out_dir}
    if is_clip:
        cfg, hcfg, params = _build_supervised(args, family, args.task, gen)
        forward = _make_forward(cfg, hcfg, train=False)
    else:
        bundle = BUNDLE_FAMILIES[(family, task)][0](args, gen)
        params, forward = bundle.params, bundle.forward_eval
        if args.head_weights:
            tree = {"params": params}
            if bundle.bn_state is not None:
                tree["bn"] = bundle.bn_state.to(device)
            _, n = ckpt.load_into(args.head_weights, torch.nn.ModuleDict(tree))
            logging.info(f"Loaded {n} tensors from {args.head_weights}")
        elif bundle.bn_state is not None:
            bundle.bn_state.to(device)
    if not args.head_weights:
        logging.warning("serving a supervised head without --head_weights: head is RANDOM")
    infer = make_infer(forward, params.to(device), device)
    if args.task == "cls":
        names = _names(args, [str(i) for i in range(args.num_classes)])
        _run_cls(paths, args, infer, device, names, out_dir)
    else:
        _run_seg(paths, args, infer, device, out_dir)
    return {"n_images": len(paths), "out": out_dir}


def _names(args, default):
    if not args.class_names:
        return list(default)
    names = [c.strip() for c in args.class_names.split(",") if c.strip()]
    if len(names) != len(default):
        raise SystemExit(f"--class_names has {len(names)} entries but the "
                         f"model predicts {len(default)} classes {default}")
    return names


def iter_padded(batches, batch_size, infer, device):
    """Serve decoded batches: yield (paths_chunk, ok_mask, outputs sliced to
    the real batch) for each (paths, uint8 images [B, H, W], ok) of
    ``batches``. A ragged tail batch is padded to ``batch_size`` by
    repeating its last row, so every forward sees one shape."""
    def padded():
        for part, imgs, ok in batches:
            b, n_real = T.pad_eval_batch({"image": imgs}, batch_size)
            b["n_real"], b["paths"], b["ok"] = n_real, part, ok
            yield b

    for batch in P.prefetch_to_device(padded(), device=device):
        out = infer(batch["image"])
        yield batch["paths"], batch["ok"], out[: batch["n_real"]].float().cpu().numpy()


def _iter_files(paths, args, infer, device):
    batches = _batches(paths, args.batch_size, args.img_size, args.num_workers)
    return iter_padded(batches, args.batch_size, infer, device)


def _run_cls(paths, args, infer, device, names, out_dir):
    csv_path = os.path.join(out_dir, "predictions.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "pred", "status"] + [f"prob_{c}" for c in names])
        for part, ok, logits in _iter_files(paths, args, infer, device):
            probs = _softmax(logits)
            for pth, good, pr in zip(part, ok, probs):
                status = "ok" if good else "decode_error"
                pred = names[int(np.argmax(pr))] if good else ""
                w.writerow([pth, pred, status] + [f"{v:.6f}" if good else "" for v in pr])
    logging.info(f"Wrote {csv_path}")


def _run_seg(paths, args, infer, device, out_dir):
    from PIL import Image

    idx_path = os.path.join(out_dir, "index.csv")
    with open(idx_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "mask", "status", "foreground_frac"])
        i = 0
        for part, ok, logits in _iter_files(paths, args, infer, device):
            # PyramidHead seg logits are [B, C, H, W]; mask = argmax class id
            masks = np.argmax(logits, axis=1).astype(np.uint8)
            for pth, good, m in zip(part, ok, masks):
                stem = os.path.splitext(os.path.basename(pth))[0]
                # global index prefix: recursive walks may repeat basenames
                mp = os.path.join(out_dir, f"{i:05d}_{stem}_mask.png")
                i += 1
                if not good:
                    w.writerow([pth, "", "decode_error", ""])
                    continue
                scale = 255 // max(int(m.max()), 1) if m.max() else 255
                Image.fromarray(m * scale).save(mp)
                w.writerow([pth, mp, "ok", f"{float((m > 0).mean()):.4f}"])
    logging.info(f"Wrote {idx_path}")


def _softmax(x):
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)
