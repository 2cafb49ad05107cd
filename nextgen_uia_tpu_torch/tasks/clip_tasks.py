"""Supervised seg/cls for the CLIP families (counterpart of
nextgen_uia_tpu/tasks/clip_tasks.py): the backbone with its adapters plus a
PyramidHead, the train and eval forwards over decoded uint8 images, and the
supervised trainer's entry point. Zero-shot comes with a later slice
(ROADMAP.md, section A, item 10)."""

from __future__ import annotations

import logging
from types import SimpleNamespace

import torch
from torch import nn

from ..core import checkpoint as ckpt
from ..core.experiment import model_summary
from ..core.partition import by_keywords
from ..data import datasets as D
from ..models import clip as clip_mod
from ..models.heads import PyramidHeadConfig, pyramid_head_apply, pyramid_head_init
from ..ops import KERNELS
from .common import (apply_compat_flags, base_parser, build_clip_model, not_ported,
                     resolve_device, seed_everything, setup_run)
from .supervised import Bundle, preprocess, run_supervised


def extract_layers_for(depth: int):
    """Pyramid taps {3,6,9} for ViT-B; the last three blocks for shrunk towers."""
    return (3, 6, 9) if depth >= 10 else tuple(range(max(depth - 3, 0), depth))


def _build_supervised(args, family: str, task: str, gen: torch.Generator):
    """(cfg, head cfg, ModuleDict{backbone, head}) on the CPU, with
    ``--head_weights`` merged in: first as a supervised-training checkpoint
    rooted at 'params/', then as a bare-rooted one."""
    adapter = "lora" if args.lora_weights else ("mona" if args.mona_weights else None)
    cfg, backbone = build_clip_model(args, family, adapter=adapter, gen=gen)
    hcfg = PyramidHeadConfig(feature_dim=cfg.vision.width, reduce_dim=args.reduce_dim,
                             num_classes=args.num_classes, img_size=args.img_size,
                             task=task)
    head = pyramid_head_init(gen, hcfg)
    params = nn.ModuleDict({"backbone": backbone, "head": head})
    if args.head_weights:
        try:
            _, n = ckpt.load_into(args.head_weights, nn.ModuleDict({"params": params}))
        except ckpt.NoMatch:
            _, n = ckpt.load_into(args.head_weights, params)
        logging.info(f"Loaded {n} tensors from {args.head_weights}")
    return cfg, hcfg, params


def _make_forward(cfg, hcfg, *, train: bool, strong: bool = False, weak: bool = False):
    """The model forward over uint8 images [B, H, W], scaled to [0, 1] and
    the grayscale channel repeated to 3 (tasks/supervised.py::preprocess).

    Eval (``train=False``): (params, images_u8) -> logits, every tower block
    through the forward-only whole-block kernel (``infer_cfg``).
    Train: (params, images_u8, masks_u8 or None, gen) -> (logits, masks
    NCHW int64 or None), the batch first augmented on the device (``strong``
    / ``weak``, at the head's image size), the blocks through the
    differentiable block kernels, the augmentation plan and the dropout
    drawn from the generator ``gen`` (None: no dropout).
    """
    taps = extract_layers_for(cfg.vision.depth)
    augs = SimpleNamespace(strong_augs=strong, weak_augs=weak, img_size=hcfg.img_size)

    if not train:
        ecfg = clip_mod.infer_cfg(cfg)

        def forward(params, images_u8, ops=KERNELS):
            x, _ = preprocess(images_u8, None, augs, train=False)
            _, acts = clip_mod.encode_image(params["backbone"], ecfg, x, extract_layers=taps,
                                            ops=ops)
            return pyramid_head_apply(params["head"], hcfg, acts)

        return forward

    def forward_train(params, images_u8, masks_u8=None, gen=None, ops=KERNELS):
        x, masks = preprocess(images_u8, masks_u8, augs, train=True, gen=gen, ops=ops)
        _, acts = clip_mod.encode_image(params["backbone"], cfg, x, extract_layers=taps,
                                        ops=ops, gen=gen)
        return pyramid_head_apply(params["head"], hcfg, acts, gen=gen), masks

    return forward_train


def supervised_main(family: str, task: str, argv=None):
    """The supervised seg/cls trainer (reference CLI defaults: 200 epochs,
    batch 32, hybrid MONA for biomedclip, strong and weak augmentation on)."""
    if family not in clip_mod.FAMILIES:
        raise not_ported(f"Supervised training of the {family} family",
                         "section A, items 10-13")
    p = base_parser(f"{family}_{task}", epochs=200, batch_size=32, strong_augs=True,
                    weak_augs=True, mona_variant="hybrid")
    args = p.parse_args(argv)
    apply_compat_flags(args)
    if args.n_model != 1 or (args.n_data or 1) != 1:
        raise not_ported("--n_data/--n_model (multi-device training)", "section A, item 14")
    if args.lora_weights:
        raise not_ported("LoRA weights in the supervised trainers", "section A, item 4")
    device = resolve_device(args.device)
    gen = seed_everything(args.seed)

    run_path = setup_run(args, "test" if args.test else "train")
    cfg, hcfg, params = _build_supervised(args, family, task, gen)
    trainable_pred = by_keywords("head", "mona", "lora")
    logging.info(model_summary({"model": params}, trainable_pred=trainable_pred))
    datasets = D.make_datasets(args.data_root, args.dataset, args.img_size,
                               task="seg" if task == "seg" else "cls",
                               cache=args.cache_images)
    params.to(device)
    fwd_train = _make_forward(cfg, hcfg, train=True, strong=args.strong_augs,
                              weak=args.weak_augs)
    fwd_eval = _make_forward(cfg, hcfg, train=False)

    def forward_train(params, batch, gen):
        return fwd_train(params, batch["image"], batch.get("mask"), gen)

    bundle = Bundle(task=task, params=params, trainable_pred=trainable_pred,
                    forward_train=forward_train, forward_eval=fwd_eval)
    return run_supervised(args, bundle, datasets, run_path, f"{family}_{task}", device)
