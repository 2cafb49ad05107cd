"""Shared task scaffolding (counterpart of nextgen_uia_tpu/tasks/common.py):
flags, seeding, device choice and model assembly.

The flags keep the JAX package's names and defaults for what the serving,
supervised-training and contrastive fine-tune paths read. ``--device``
selects the torch device here (default ``cuda``); asking for CUDA where
there is none raises, and nothing falls back to the CPU. Every task of the
JAX package is ported; none refuses as unported.

Without converted pretrained weights the backbone initialises randomly from
``--seed`` with a loud warning.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import re
import sys

import numpy as np
import torch

from ..adapters.lora import inject_lora, inject_lora_bert
from ..adapters.mona import inject_mona
from ..core import checkpoint as ckpt
from ..data.tokenizer import ClipTokenizer, load_hf_tokenizer
from ..models import clip as clip_mod
from ..models.bert import BertConfig

MONA_CHOICES = ["baseline", "noise_aware", "freq_enhanced", "hybrid"]
BIOMEDCLIP_HF = "microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224"
UNIMEDCLIP_HF = "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract"


def base_parser(name: str, **defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name, conflict_handler="resolve")
    p.add_argument("--exp", type=str, default=defaults.get("exp", name))
    p.add_argument("--dataset", type=str, default=defaults.get("dataset", "BUSI"))
    p.add_argument("--data_root", type=str,
                   default=os.environ.get("NEXTGEN_UIA_DATA", "../data/NextGen-UIA"))
    p.add_argument("--img_size", type=int, default=defaults.get("img_size", 224))
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--strong_augs", default=defaults.get("strong_augs", False),
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--weak_augs", default=defaults.get("weak_augs", False),
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--seed", type=int, default=defaults.get("seed", 1))
    p.add_argument("--batch_size", type=int, default=defaults.get("batch_size", 32))
    p.add_argument("--epochs", type=int, default=defaults.get("epochs", 200))
    p.add_argument("--lr", type=float, default=defaults.get("lr", 1e-4))
    p.add_argument("--lr_min", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--patience", type=int, default=defaults.get("patience", 15))
    p.add_argument("--val_interval", type=int, default=defaults.get("val_interval", 10))
    p.add_argument("--test", default=False, action="store_true",
                   help="skip training; evaluate an existing checkpoint")
    p.add_argument("--resume", default=False, action="store_true",
                   help="resume from the run dir's last_state.npz")
    p.add_argument("--cache_images", default=True, action=argparse.BooleanOptionalAction,
                   help="cache decoded images in RAM")
    p.add_argument("--mona_weights", type=str, default=None)
    p.add_argument("--mona_variant", type=str,
                   default=defaults.get("mona_variant", "freq_enhanced"),
                   choices=MONA_CHOICES + ["fractional"])
    p.add_argument("--mona_bottleneck", type=int, default=64)
    p.add_argument("--mona_layers", type=int, default=None)
    p.add_argument("--lora_weights", type=str, default=None)
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=32)
    p.add_argument("--lora_dropout", type=float, default=0.1)
    p.add_argument("--lora_layers", type=int, default=None)
    p.add_argument("--reduce_dim", type=int, default=512,
                   help="pyramid-head reduce width")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu); CUDA asked "
                        "for and absent is an error")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference backbone checkpoint path; a converted .npz is used as "
                        "--backbone_ckpt, a torch archive must be converted first")
    p.add_argument("--version", type=str, default=None,
                   help="reference model version string (e.g. ViT-B/16); informational, "
                        "each family pins its architecture")
    p.add_argument("--backbone_ckpt", type=str, default=None,
                   help="converted backbone checkpoint (.npz)")
    p.add_argument("--head_weights", type=str, default=None,
                   help="trained head/component checkpoint to load")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel width under torchrun (default: the world size)")
    p.add_argument("--n_model", type=int, default=1,
                   help="model-parallel width under torchrun (shards the frozen tower)")
    p.add_argument("--debug_tiny", default=False, action="store_true",
                   help="shrink towers for smoke tests (random weights)")
    return p


def apply_compat_flags(args) -> None:
    """Resolve the reference-CLI compat flag ``--ckpt`` against the port's
    surface, as the JAX package's ``apply_compat_flags`` does: a ``.npz``
    becomes ``--backbone_ckpt`` unless that is set; an existing file of any
    other kind is a torch archive, which needs the checkpoint converter
    (``python -m nextgen_uia_tpu_torch.convert``) first. A non-``.npz`` path that does not exist (a reference-style default
    such as ckpt/ViT-B-16.pt) stays informational."""
    ck = getattr(args, "ckpt", None)
    if not ck:
        return
    if ck.endswith(".npz"):
        if not getattr(args, "backbone_ckpt", None):
            args.backbone_ckpt = ck
    elif os.path.exists(ck) and not getattr(args, "backbone_ckpt", None):
        raise SystemExit(
            f"--ckpt {ck} looks like a torch archive. Convert it first:\n"
            f"  python -m nextgen_uia_tpu_torch.convert <kind> {ck} out.npz\n"
            "then pass the .npz via --ckpt or --backbone_ckpt.")


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python, numpy and torch; returns the CPU generator that draws
    the random init."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this host "
                           "(pass --device cpu to run the plain versions on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return device


def setup_run(args, subdir: str) -> str:
    """runs/<exp>/<dataset>/<train|test> with its log file, as the JAX
    package lays a run out."""
    path = os.path.join("runs", args.exp, args.dataset, subdir)
    setup_logging(path, args)
    return path


def setup_logging(log_path: str, args) -> None:
    """Log to <log_path>/log.log and stdout; a process of rank > 0 under
    ``torchrun`` (``RANK``) writes no file and prints warnings only, so rank
    0 alone logs a multi-process run."""
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
    if int(os.environ.get("RANK", "0")) > 0:
        logging.basicConfig(level=logging.WARNING, stream=sys.stdout,
                            format=f"[rank {os.environ['RANK']}] %(message)s")
        return
    os.makedirs(log_path, exist_ok=True)
    logging.basicConfig(filename=os.path.join(log_path, "log.log"), filemode="w",
                        level=logging.INFO, format="[%(asctime)s] %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info(str(args))


def resolve_mona_variant(variant: str) -> str:
    """'fractional' is advertised by the reference CLI but has no
    implementation; accepted for CLI compatibility, then refused."""
    if variant == "fractional":
        raise SystemExit("MONA variant 'fractional' is advertised by the reference CLI "
                         f"but has no implementation. Choose from {MONA_CHOICES}.")
    return variant


def sniff_adapter_kind(path: str):
    """Which adapter family a component checkpoint holds, by its flat key
    paths: ('lora', {'r', 'num_layers'} recovered from the file), ('mona',
    None) or (None, None)."""
    keys = ckpt.peek_keys(path)
    has_lora = [k for k in keys if "/lora/" in k]
    has_mona = any("/mona/" in k for k in keys)
    if has_lora and not has_mona:
        with np.load(path) as data:
            r = int(data[has_lora[0].rsplit("/", 1)[0] + "/a"].shape[1])
        blocks = {int(m.group(1)) for k in has_lora
                  if (m := re.search(r"/(?:blocks|layers)/(\d+)/", k))}
        return "lora", {"r": r, "num_layers": (max(blocks) + 1) if blocks else None}
    if has_mona and not has_lora:
        return "mona", None
    return None, None


def build_clip_model(args, family: str, *, adapter: str | None = None,
                     gen: torch.Generator | None = None):
    """Assemble (cfg, CLIP module on CPU): config, random or converted
    weights, LoRA (with ``--tune_text_encoder`` in BERT's layers too) or
    MONA injection and the optional adapter weight load.

    An adapter checkpoint passed through the other adapter's flag is routed
    by its key paths, and a LoRA checkpoint's rank and layer count override
    ``--lora_r``/``--lora_layers``, as the JAX package does."""
    gen = gen if gen is not None else torch.Generator().manual_seed(args.seed)
    lora_r, lora_layers = args.lora_r, args.lora_layers
    adapter_ckpt = args.mona_weights or args.lora_weights
    if adapter_ckpt and os.path.exists(adapter_ckpt):
        detected, meta = sniff_adapter_kind(adapter_ckpt)
        flag = "mona" if args.mona_weights else "lora"
        if detected is not None and detected != flag:
            logging.info(f"--{flag}_weights {adapter_ckpt} holds {detected.upper()} parameters: "
                         f"routing it to {detected} injection")
            if detected == "lora":
                args.lora_weights, args.mona_weights = adapter_ckpt, None
            else:
                args.mona_weights, args.lora_weights = adapter_ckpt, None
        if detected == "lora":
            if meta["r"] != lora_r:
                logging.info(f"LoRA checkpoint rank r={meta['r']} overrides --lora_r {lora_r}")
                lora_r = meta["r"]
            if meta["num_layers"] is not None and meta["num_layers"] != lora_layers:
                logging.info(f"LoRA checkpoint covers {meta['num_layers']} layers; overriding "
                             f"--lora_layers {lora_layers}")
                lora_layers = meta["num_layers"]
    use_lora = adapter == "lora" or bool(args.lora_weights)
    use_mona = not use_lora and (adapter == "mona" or bool(args.mona_weights))
    variant = resolve_mona_variant(args.mona_variant) if use_mona else "hybrid"
    cfg = clip_mod.clip_config(family, compute_dtype=args.compute_dtype, mona_variant=variant,
                               lora_alpha=float(args.lora_alpha),
                               lora_dropout=float(args.lora_dropout) if use_lora else 0.0)
    if args.debug_tiny:
        cfg = cfg.replace(vision=dataclasses.replace(
            cfg.vision, image_size=args.img_size, width=96, depth=4, heads=4, proj_dim=64))
        tiny = dict(width=96, depth=2, heads=4, embed_dim=64)
        if cfg.text_kind == "bert":
            tiny["intermediate"] = 192
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, **tiny))
    params = clip_mod.clip_init(gen, cfg)

    if args.backbone_ckpt:
        _, n = ckpt.load_into(args.backbone_ckpt, params)
        logging.info(f"Loaded {n} backbone tensors from {args.backbone_ckpt}")
    else:
        logging.warning("No --backbone_ckpt given: backbone weights are RANDOM. Run the "
                        "checkpoint converter (nextgen_uia_tpu_torch.convert) for pretrained "
                        "towers.")
    if use_lora:
        _, n = inject_lora(gen, params.visual, dim=cfg.vision.width, r=lora_r,
                           num_layers=lora_layers)
        logging.info(f"Injected LoRA into {n} blocks (r={lora_r}, alpha={args.lora_alpha})")
        if getattr(args, "tune_text_encoder", False) and cfg.text_kind == "bert":
            # the reference's --tune_text_encoder: LoRA on BERT's q/k/v/o too
            _, n = inject_lora_bert(gen, params.text, dim=cfg.text.width, r=lora_r,
                                    num_layers=lora_layers)
            logging.info(f"Injected LoRA into {n} text-encoder layers")
        if args.lora_weights:
            _, n = _load_adapter(args.lora_weights, params)
            logging.info(f"Loaded {n} LoRA tensors from {args.lora_weights}")
    elif use_mona:
        _, n = inject_mona(gen, params.visual, dim=cfg.vision.width,
                           bottleneck=args.mona_bottleneck, variant=variant,
                           num_layers=args.mona_layers)
        logging.info(f"Injected {variant} MONA into {n} blocks")
        if args.mona_weights:
            _, n = _load_adapter(args.mona_weights, params)
            logging.info(f"Loaded {n} MONA tensors from {args.mona_weights}")
    return cfg, params


def _load_adapter(path: str, params):
    """Load an adapter checkpoint into the CLIP module: rooted at the
    backbone (the fine-tune's best_model.npz), else at params/backbone/ (the
    supervised trainer's best_model.npz, the JAX package's layout of that
    file)."""
    try:
        return ckpt.load_into(path, params)
    except ckpt.NoMatch:
        rooted = torch.nn.ModuleDict({"params": torch.nn.ModuleDict({"backbone": params})})
        return ckpt.load_into(path, rooted)


def get_text_tokenizer(args, family: str):
    """The text tokenizer of a family: the CLIP BPE (context 77) for openai,
    metaclip and any other family; for unimedclip the BiomedBERT tokenizer at context 77 when
    its HuggingFace files are cached, else the CLIP BPE (context 77, not
    marked as a fallback, as the JAX package has it); for biomedclip the
    PubMedBERT tokenizer (context 256) when its HuggingFace files are cached,
    else the CLIP BPE with its ids folded into the BERT vocabulary (1 + id %
    30521, padding 0), marked ``is_fallback``."""
    if family == "unimedclip":
        tok = load_hf_tokenizer(UNIMEDCLIP_HF, context_length=77)
        if tok is not None:
            return tok
        logging.warning("UniMedCLIP BiomedBERT tokenizer unavailable offline; falling back "
                        "to CLIP BPE (ctx 77).")
    if family == "biomedclip":
        tok = load_hf_tokenizer(BIOMEDCLIP_HF, context_length=256)
        if tok is not None:
            return tok
        logging.warning(
            "BiomedCLIP HF tokenizer unavailable offline; falling back to CLIP BPE with ids "
            "folded into the BERT vocab range (context 256). Text-side parity requires the HF "
            "tokenizer files.")
        clip_tok = ClipTokenizer()
        vocab = BertConfig().vocab_size

        def fallback(texts, ctx=256):
            ids = clip_tok(texts, context_length=ctx)
            return np.where(ids > 0, 1 + (ids % (vocab - 1)), 0).astype(np.int32)

        fallback.is_fallback = True
        return fallback
    tok = ClipTokenizer()
    return lambda texts, ctx=77: tok(texts, context_length=ctx)


def require_real_tokenizer(args, tokenizer, what: str):
    """Refuse the folded fallback tokenizer on a run whose results would be
    read as the reference's (no --debug_tiny): its features mean nothing for
    comparison. NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1 lets it through."""
    if not getattr(tokenizer, "is_fallback", False) or getattr(args, "debug_tiny", False):
        return
    if os.environ.get("NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK") == "1":
        logging.warning(f"{what}: running with the FALLBACK tokenizer by explicit override - "
                        "results are NOT reference-parity")
        return
    raise SystemExit(
        f"{what}: the real HF tokenizer is unavailable and this is a parity-relevant run (no "
        "--debug_tiny). Results under the CLIP-BPE fallback are meaningless for comparison "
        "with the reference. Cache the HF tokenizer files locally, pass --debug_tiny for a "
        "smoke run, or set NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1 to proceed anyway.")
