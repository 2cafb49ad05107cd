"""Supervised seg/cls model for the CLIP families, serving side (counterpart of
nextgen_uia_tpu/tasks/clip_tasks.py): the backbone with its adapters plus a
PyramidHead, and the eval forward over decoded uint8 images. Zero-shot and
training come with later slices (ROADMAP.md, section A)."""

from __future__ import annotations

import logging

import torch
from torch import nn

from ..core import checkpoint as ckpt
from ..models import clip as clip_mod
from ..models.heads import PyramidHeadConfig, pyramid_head_apply, pyramid_head_init
from ..ops import KERNELS
from .common import build_clip_model, not_ported


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


def _make_forward(cfg, hcfg, *, train: bool):
    """Eval forward: (params, images_u8 [B, H, W]) -> logits; images are
    scaled to [0, 1] and the grayscale channel repeated to 3. (The JAX
    package's ``args`` carry only the training augmentation flags.)"""
    if train:
        raise not_ported("The training forward", "section A, items 6-9")

    def forward(params, images_u8, ops=KERNELS):
        x = (images_u8.to(torch.float32) / 255.0)[..., None].expand(-1, -1, -1, 3)
        _, acts = clip_mod.encode_image(params["backbone"], cfg, x,
                                        extract_layers=extract_layers_for(cfg.vision.depth),
                                        ops=ops)
        return pyramid_head_apply(params["head"], hcfg, acts)

    return forward
