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
from types import SimpleNamespace

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import mesh as M
from ..core import train as T
from ..data import pipeline as P
from ..models import clip as clip_mod
from ..ops import KERNELS
from . import other_tasks as OT
from . import prompts as PR
from .clip_tasks import (_build_supervised, build_text_features, make_forward,
                         make_zero_shot_logits_fn)
from .common import (apply_compat_flags, base_parser, build_clip_model, get_text_tokenizer,
                     require_real_tokenizer, seed_everything, setup_logging)

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

    infer.dp_width = getattr(forward, "dp_width", 1)
    return infer


def predict_args(family: str, argv=None):
    """The predict CLI's parsed arguments for ``family``."""
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
                   help="also write the served forward as NAME (torch.export, weights as "
                        "arguments) + NAME.params.npz (relative to --out)")
    args = p.parse_args(argv)
    apply_compat_flags(args)
    return args


def build_served(family: str, args, device, gen):
    """The served model of ``args`` (predict_args) on ``device``: a
    namespace of ``forward(params, images_u8, ops)``, ``params``, the
    ``export_tree`` of the modules the forward reads (export_program) and,
    for zero-shot, the prompt ``classes``."""
    is_clip = family in clip_mod.FAMILIES
    classes = None
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

        def forward(p_, x, ops=KERNELS):
            return logits_fn(p_, x, ops)[0]

        # the image forward never reads the text tower: the text prototypes
        # are small constants of the program
        export_tree = torch.nn.ModuleDict({"visual": params.visual})
    elif is_clip:
        cfg, hcfg, params = _build_supervised(args, family, args.task, gen)
        forward = make_forward(cfg, hcfg, train=False)
        # the supervised forward reads the vision tower and the head only
        export_tree = torch.nn.ModuleDict({
            "backbone": torch.nn.ModuleDict({"visual": params["backbone"].visual}),
            "head": params["head"]})
    else:
        bundle = BUNDLE_FAMILIES[(family, args.task)][0](args, gen)
        params, forward = bundle.params, bundle.forward_eval
        tree = {"params": params}
        if bundle.bn_state is not None:
            tree["bn"] = bundle.bn_state.to(device)
        if args.head_weights:
            _, n = ckpt.load_into(args.head_weights, torch.nn.ModuleDict(tree))
            logging.info(f"Loaded {n} tensors from {args.head_weights}")
        # BatchNorm's running statistics are arguments of the program, as
        # every weight is, never constants
        export_tree = torch.nn.ModuleDict(tree) if bundle.bn_state is not None else params
    if args.task != "zero_shot" and not args.head_weights:
        logging.warning("serving a supervised head without --head_weights: head is RANDOM")
    params.to(device)
    return SimpleNamespace(forward=forward, params=params, export_tree=export_tree,
                           classes=classes)


def predict_main(family: str = "biomedclip", argv=None):
    args = predict_args(family, argv)
    if args.n_model != 1:
        logging.warning("serving is data-parallel only; --n_model ignored (model-axis "
                        "sharding needs the FSDP-partitioned train-side flow)")
    # default: every process of the group serves data-parallel
    mesh = M.make_mesh(args.n_data, 1, device=args.device)
    device = mesh.device
    gen = seed_everything(args.seed)

    out_dir = args.out or os.path.join("runs", "serve", args.exp)
    os.makedirs(out_dir, exist_ok=True)
    setup_logging(out_dir, args)
    paths = collect_images(args.images)
    if not paths:
        raise SystemExit(f"no images found under {args.images}")
    logging.info(f"Serving {len(paths)} images -> {out_dir} on {device} "
                 f"(data-parallel width {mesh.n_data})")
    served = build_served(family, args, device, gen)
    forward, params = served.forward, served.params
    infer = make_infer(T.make_sharded_apply(forward, mesh), params, device)
    if args.task == "seg":
        _run_seg(paths, args, infer, mesh, out_dir)
    else:
        default = served.classes or [str(i) for i in range(args.num_classes)]
        _run_cls(paths, args, infer, mesh, _names(args, default), out_dir)
    if args.export and mesh.is_main:
        export_program(lambda x: forward(params, x), served.export_tree, args, out_dir, device)
    return {"n_images": len(paths), "out": out_dir}


def _names(args, default):
    if not args.class_names:
        return list(default)
    names = [c.strip() for c in args.class_names.split(",") if c.strip()]
    if len(names) != len(default):
        raise SystemExit(f"--class_names has {len(names)} entries but the "
                         f"model predicts {len(default)} classes {default}")
    return names


def iter_padded(batches, batch_size, infer, device, multiple: int = 1):
    """Serve decoded batches: yield (paths_chunk, ok_mask, outputs sliced to
    the real batch) for each (paths, uint8 images [B, H, W], ok) of
    ``batches``. A ragged tail batch is padded to ``batch_size`` (rounded up
    to a multiple of ``multiple``, the data-parallel width) by repeating its
    last row, so every forward sees one shape."""
    size = -(-batch_size // multiple) * multiple

    def padded():
        for part, imgs, ok in batches:
            b, n_real = T.pad_eval_batch({"image": imgs}, size)
            b["n_real"], b["paths"], b["ok"] = n_real, part, ok
            yield b

    for batch in P.prefetch_to_device(padded(), device=device):
        out = infer(batch["image"])
        yield batch["paths"], batch["ok"], out[: batch["n_real"]].float().cpu().numpy()


def _iter_files(paths, args, infer, mesh):
    batches = _batches(paths, args.batch_size, args.img_size, args.num_workers)
    return iter_padded(batches, args.batch_size, infer, mesh.device, infer.dp_width)


def _run_cls(paths, args, infer, mesh, names, out_dir):
    """predictions.csv, written by rank 0 (every rank serves its slice of
    every batch)."""
    csv_path = os.path.join(out_dir, "predictions.csv")
    rows = []
    for part, ok, logits in _iter_files(paths, args, infer, mesh):
        probs = _softmax(logits)
        for pth, good, pr in zip(part, ok, probs):
            status = "ok" if good else "decode_error"
            pred = names[int(np.argmax(pr))] if good else ""
            rows.append([pth, pred, status] + [f"{v:.6f}" if good else "" for v in pr])
    if mesh.is_main:
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "pred", "status"] + [f"prob_{c}" for c in names])
            w.writerows(rows)
        logging.info(f"Wrote {csv_path}")


def _run_seg(paths, args, infer, mesh, out_dir):
    """<index>_<stem>_mask.png and index.csv, written by rank 0."""
    from PIL import Image

    idx_path = os.path.join(out_dir, "index.csv")
    rows, i = [], 0
    for part, ok, logits in _iter_files(paths, args, infer, mesh):
        # PyramidHead seg logits are [B, C, H, W]; mask = argmax class id
        masks = np.argmax(logits, axis=1).astype(np.uint8)
        for pth, good, m in zip(part, ok, masks):
            stem = os.path.splitext(os.path.basename(pth))[0]
            # global index prefix: recursive walks may repeat basenames
            mp = os.path.join(out_dir, f"{i:05d}_{stem}_mask.png")
            i += 1
            if not good:
                rows.append([pth, "", "decode_error", ""])
                continue
            if mesh.is_main:
                scale = 255 // max(int(m.max()), 1) if m.max() else 255
                Image.fromarray(m * scale).save(mp)
            rows.append([pth, mp, "ok", f"{float((m > 0).mean()):.4f}"])
    if mesh.is_main:
        with open(idx_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "mask", "status", "foreground_frac"])
            w.writerows(rows)
        logging.info(f"Wrote {idx_path}")


def _softmax(x):
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def weight_tree(module: torch.nn.Module):
    """The nested tree of ``module``'s state (parameters and persistent
    buffers, detached): a ModuleList a list, every other module a dict
    keyed by attribute name. Its '/'-joined paths are the checkpoint's."""
    state = module.state_dict()

    def build(mod, prefix):
        node = {}
        for name, child in mod.named_children():
            sub = build(child, f"{prefix}{name}.")
            if sub:
                node[name] = sub
        for name, _ in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if prefix + name in state:
                node[name] = state[prefix + name].detach()
        if isinstance(mod, torch.nn.ModuleList):
            return [node[str(i)] for i in range(len(mod)) if str(i) in node]
        return node

    return build(module, "")


def flatten_tree(tree, prefix: str = "", sep: str = "/") -> dict:
    """The tree's leaves by their ``sep``-joined paths (list items by index)."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten_tree(v, f"{prefix}{k}{sep}", sep))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _Served(torch.nn.Module):
    """The served forward ``fn(images_u8)`` over the modules of ``tree``."""

    def __init__(self, tree: torch.nn.Module, fn):
        super().__init__()
        self.tree, self.fn = tree, fn

    def forward(self, images_u8):
        return self.fn(images_u8)


class _Program(torch.nn.Module):
    """What is exported: ``(weights, images_u8) -> outputs``, the served
    module called with ``weights`` (``weight_tree``'s nesting) in place of
    its own tensors. It holds no tensor of its own: the served module is
    a plain attribute, not a submodule, so no weight is lifted into the
    program."""

    def __init__(self, served: _Served):
        super().__init__()
        object.__setattr__(self, "served", served)

    def forward(self, weights, images_u8):
        flat = flatten_tree(weights, "tree.", ".")
        return torch.func.functional_call(self.served, flat, (images_u8,))


def export_forward(fn, tree: torch.nn.Module, images_u8, weights=None):
    """The ExportedProgram ``(weights, images_u8) -> outputs`` of the served
    forward ``fn(images_u8)`` over the modules of ``tree``, traced
    (non-strict) under ``torch.no_grad`` at ``images_u8``'s shape with
    ``weights`` (default: the tree's own tensors, ``weight_tree``), its
    example inputs cleared. Returns (program, the weights it was traced
    with)."""
    served = _Served(tree, fn)
    if weights is None:
        weights = weight_tree(served)["tree"]
    with torch.no_grad():
        program = torch.export.export(_Program(served), (weights, images_u8), strict=False)
    # torch.export.save would store the example inputs: every weight
    if getattr(program, "_example_inputs", None) is not None:
        program._example_inputs = None
    return program, weights


def export_program(fn, tree: torch.nn.Module, args, out_dir: str, device):
    """Write the served forward through ``torch.export``, weights as
    ARGUMENTS, not constants: the program ``(weights, images_u8[B, H, W]
    uint8) -> outputs`` as ``--export`` (``torch.export.save``, its example
    inputs cleared so the weights do not ride along) and the weights as
    ``<name>.params.npz`` (the checkpoints' '/'-joined format).

    ``fn(images_u8)`` reads the modules of ``tree`` (only what the forward
    reads: BatchNorm's running statistics under ``bn/``), traced on
    ``device`` under ``torch.no_grad``; on a CUDA device the kernels appear
    as the ``nextgen_uia::`` ops (ops/registry.py). Before publishing, the
    weights are written to a temporary file and rebuilt by
    ``load_exported_params`` (a tree that does not round-trip is refused),
    the program loaded back and called on the rebuilt weights and a zero
    batch, which must give finite outputs; both files then move in place
    with ``os.replace``, and on any failure neither is left behind.
    Returns (program path, weights path, program bytes)."""
    shape = (args.batch_size, args.img_size, args.img_size)
    images = torch.zeros(shape, dtype=torch.uint8, device=device)
    weights = weight_tree(tree)
    path = args.export if os.path.isabs(args.export) else os.path.join(out_dir, args.export)
    wpath = path + ".params.npz"
    # probe against temporary files and publish both halves only after it
    # passes: a failed probe must not leave a mismatched pair on disk
    wtmp, ptmp = wpath + ".tmp.npz", path + ".tmp"
    try:
        ckpt.save_flat(wtmp, flatten_tree(weights))
        rebuilt = load_exported_params(wtmp, device=device)
        if (torch.utils._pytree.tree_structure(rebuilt)
                != torch.utils._pytree.tree_structure(weights)):
            raise SystemExit(
                "--export: the weight tree does not round-trip through the loader "
                "(load_exported_params reads dict and list nodes; a dict whose keys are all "
                "digits comes back as a list)")
        program, _ = export_forward(fn, tree, images, weights)
        with open(ptmp, "wb") as f:
            torch.export.save(program, f)
        with open(ptmp, "rb") as f:
            loaded = torch.export.load(f)
        with torch.no_grad():
            out = loaded.module()(rebuilt, images)
        leaves = torch.utils._pytree.tree_leaves(out)
        if not all(torch.isfinite(t.float()).all() for t in leaves):
            raise SystemExit("--export: the exported forward gave non-finite outputs")
    except BaseException:
        for leftover in (wtmp, ptmp):
            if os.path.exists(leftover):
                os.remove(leftover)
        raise
    os.replace(wtmp, wpath)
    os.replace(ptmp, path)
    size = os.path.getsize(path)
    logging.info(f"Exported the forward ({size} bytes) -> {path} (+ weights {wpath})")
    return path, wpath, size


def load_exported_params(npz_path: str, device="cpu"):
    """Rebuild the exported forward's weight tree from its .params.npz, as
    tensors on ``device``: numpy, torch and the path nesting only, no model
    code (integer path components become list indices). A serving process
    then runs ``torch.export.load(path).module()(weights, images_u8)``,
    after ``import nextgen_uia_tpu_torch.ops`` when the program holds the
    CUDA kernels (the ``nextgen_uia::`` ops)."""
    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(arr).to(device)

    def listify(n):
        if not isinstance(n, dict):
            return n
        n = {k: listify(v) for k, v in n.items()}
        if n and all(k.isdigit() for k in n):
            return [n[str(i)] for i in range(len(n))]
        return n

    return listify(root)
