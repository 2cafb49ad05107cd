"""Trainers for the supervised engine's other families (counterpart of
nextgen_uia_tpu/tasks/other_tasks.py), and the bundles the predict CLI
serves. Ported:

  - CLIPSeg: the frozen OpenAI ViT-B/16 image and text towers, forward only
    through the whole-block kernel (``infer_cfg``), the dataset's dense
    prompt as the FiLM conditioning, and the trainable FiLM decoder
    (models/heads.py); its single-channel output stacked as ``[-s, s]``
    into 2-class logits, DiceCE, decoder-only checkpoints.
  - DINOv2: a frozen DINOv2 encoder with the 4-layer classification head,
    or the linear or UNet decoder (``--decoder_type``), with the few-shot
    subset when asked (``fewshot=True``).
  - The baselines: a ResNet (``--version``) classifier, from a converted
    torchvision checkpoint when given (``--backbone_ckpt``), and the UNet
    segmenter (``--init_channels``, one input channel by default), every
    parameter trained, float32, their BatchNorm statistics the bundle's
    ``bn_state``; the few-shot subset when asked.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
from torch import nn

from ..core import checkpoint as ckpt
from ..core import mesh as M
from ..core.experiment import model_summary
from ..core.partition import by_keywords
from ..data import datasets as D
from ..models import clip as clip_mod
from ..models import dinov2 as DV
from ..models.heads import ClipSegDecoderConfig, clipseg_decoder_apply, clipseg_decoder_init
from ..models.resnet import SPECS as RESNET_SPECS
from ..models.resnet import resnet_apply, resnet_init
from ..models.unet import unet_apply, unet_init
from ..ops import KERNELS
from . import prompts as PR
from .clip_tasks import extract_layers_for
from .common import (apply_compat_flags, base_parser, build_clip_model, get_text_tokenizer,
                     seed_everything, setup_run)
from .supervised import (Bundle, add_fewshot_flags, apply_fewshot, preprocess,
                         run_supervised)


def _bundle_main(name: str, task: str, argv, build, add_flags, *, fewshot: bool = False,
                 **defaults):
    """A supervised-engine trainer (on the processes of the launch, as
    run_supervised spreads it; one device outside torchrun): the family's parser
    (strong and weak augmentation on, ``defaults`` for the rest), its bundle
    from ``build(args, gen)``, the few-shot subset when asked, then
    run_supervised tagged ``name``."""
    p = base_parser(name, strong_augs=True, weak_augs=True, **defaults)
    add_flags(p)
    if fewshot:
        add_fewshot_flags(p)
    args = p.parse_args(argv)
    apply_compat_flags(args)
    mesh = M.make_mesh(args.n_data, args.n_model, device=args.device)
    device = mesh.device
    gen = seed_everything(args.seed)
    run_path = setup_run(args, "test" if args.test else "train")
    bundle = build(args, gen)
    bundle.params.to(device)
    if bundle.bn_state is not None:
        bundle.bn_state.to(device)
    datasets = D.make_datasets(args.data_root, args.dataset, args.img_size, task=task,
                               cache=args.cache_images)
    if fewshot:
        apply_fewshot(args, datasets, task)
    return run_supervised(args, bundle, datasets, run_path, name, device, mesh)


# ---------------------------------------------------------------------------
# CLIPSeg
# ---------------------------------------------------------------------------


def add_clipseg_flags(p):
    p.add_argument("--version", type=str, default="ViT-B/16")
    p.add_argument("--ckpt", type=str, default="ckpt/ViT-B-16.pt")
    p.add_argument("--reduce_dim", type=int, default=64,
                   help="decoder reduce dim (CIDAS/clipseg-rd64-refined uses 64)")
    p.add_argument("--decoder_ckpt", type=str, default=None,
                   help="converted CLIPSeg decoder .npz (convert clipseg_decoder) or a "
                        "trainer's best_model.npz")


def clipseg_segmentation_main(argv=None):
    """The CLIPSeg trainer (reference CLI defaults: 1000 epochs, batch 32,
    strong and weak augmentation on)."""
    return _bundle_main("clipseg_segmentation", "seg", argv, build_clipseg_bundle,
                        add_clipseg_flags, epochs=1000, batch_size=32)


def _clipseg_decoder_config(args, cfg) -> ClipSegDecoderConfig:
    return ClipSegDecoderConfig(hidden_size=cfg.vision.width, reduce_dim=args.reduce_dim,
                                cond_dim=cfg.text.embed_dim,
                                extract_layers=extract_layers_for(cfg.vision.depth),
                                patch_size=cfg.vision.patch_size)


def build_clipseg_bundle(args, gen: torch.Generator) -> Bundle:
    """The OpenAI CLIP towers and the FiLM decoder with its forwards,
    dataset-free (the trainer and the predict CLI share it).
    ``--decoder_ckpt`` takes the converter's decoder-rooted file or a
    trainer's best_model.npz (rooted at 'params/head/')."""
    cfg, backbone = build_clip_model(args, "openai", gen=gen)
    decoder = clipseg_decoder_init(gen, _clipseg_decoder_config(args, cfg))
    params = nn.ModuleDict({"backbone": backbone, "head": decoder})
    if args.decoder_ckpt:
        try:
            _, n = ckpt.load_into(args.decoder_ckpt, decoder)
        except ckpt.NoMatch:
            _, n = ckpt.load_into(args.decoder_ckpt,
                                  nn.ModuleDict({"params": nn.ModuleDict({"head": decoder})}))
        logging.info(f"Loaded {n} decoder tensors from {args.decoder_ckpt}")
    logging.info(model_summary({"model": params}, trainable_pred=by_keywords("head")))
    forward_train, forward_eval = clipseg_forwards(args, cfg)
    return Bundle(task="seg", params=params, trainable_pred=by_keywords("head"),
                  forward_train=forward_train, forward_eval=forward_eval)


def clipseg_forwards(args, cfg):
    """(forward_train, forward_eval) of CLIPSeg over a bundle's params, the
    towers at ``cfg`` (its compute dtype too)."""
    dcfg = _clipseg_decoder_config(args, cfg)
    tokenizer = get_text_tokenizer(args, "openai")
    prompt = torch.from_numpy(np.asarray(tokenizer([PR.clipseg_prompt_for(args.dataset)])))
    # the towers never train: forward only, through the whole-block kernel
    icfg = clip_mod.infer_cfg(cfg)

    def model_logits(params, x, ops):
        with torch.no_grad():
            _, acts = clip_mod.encode_image(params["backbone"], icfg, x,
                                            extract_layers=dcfg.extract_layers, ops=ops)
            cond = clip_mod.encode_text(params["backbone"], icfg, prompt.to(x.device), ops=ops)
        single = clipseg_decoder_apply(params["head"], dcfg, acts,
                                       cond.expand(x.shape[0], -1), ops=ops)
        # 1 channel -> 2-class logits by negation (clipseg_adapter.py:92-96)
        return torch.stack([-single, single], dim=1)

    def forward_train(params, batch, gen, ops=KERNELS):
        x, m = preprocess(batch["image"], batch.get("mask"), args, train=True, gen=gen, ops=ops)
        return model_logits(params, x, ops), m

    def forward_eval(params, images_u8, ops=KERNELS):
        x, _ = preprocess(images_u8, None, args, train=False)
        return model_logits(params, x, ops)

    return forward_train, forward_eval


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------


def _dino_compute_dtype(args):
    """--compute_dtype for the frozen encoder; the trainable heads stay
    float32."""
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else None


def _build_dino(args, gen: torch.Generator):
    """(cfg, encoder on the CPU): the arch's config (``--debug_tiny``:
    width 64, depth 5, 4 heads), seeded random or ``--backbone_ckpt``
    weights (rooted at 'encoder/' or bare)."""
    if getattr(args, "lora_weights", None):
        # the JAX dino trainers accept the flag and never read it
        logging.warning("--lora_weights has no effect on DINOv2 (no LoRA in its encoder)")
    cfg = DV.dinov2_config(getattr(args, "dino_arch", None) or "vit_base")
    if args.debug_tiny:
        cfg = dataclasses.replace(cfg, width=64, depth=5, heads=4)
    encoder = DV.dinov2_init(gen, cfg)
    if args.backbone_ckpt:
        try:
            _, n = ckpt.load_into(args.backbone_ckpt, nn.ModuleDict({"encoder": encoder}))
        except ckpt.NoMatch:
            _, n = ckpt.load_into(args.backbone_ckpt, encoder)
        logging.info(f"Loaded {n} DINOv2 tensors from {args.backbone_ckpt}")
    else:
        logging.warning("No --backbone_ckpt: DINOv2 weights are RANDOM (convert with "
                        "nextgen_uia_tpu_torch.convert dinov2)")
    return cfg, encoder


def add_dino_flags(p, *, seg: bool = False):
    """The dino trainers' flags: 518 px, patch 14, --dino_arch, and for seg
    --decoder_type and --head_dtype."""
    p.set_defaults(patch_size=14, img_size=518)
    p.add_argument("--dino_arch", type=str, default="vit_base", choices=sorted(DV.DINOV2_ARCHS))
    if seg:
        p.add_argument("--decoder_type", type=str, default="unet", choices=["linear", "unet"])
        p.add_argument("--head_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"])


def _features(encoder, cfg, x, n, dt, ops):
    """The frozen encoder's last-n layers, without autograd (the
    counterpart of the JAX trainer's stop_gradient)."""
    with torch.no_grad():
        return DV.get_intermediate_layers(encoder, x, n, cfg, dtype=dt, ops=ops)


def build_dino_cls_bundle(args, gen: torch.Generator) -> Bundle:
    """Frozen DINOv2 encoder + 4-layer cls head (dataset-free: the train
    trainer and the predict CLI share it)."""
    cfg, encoder = _build_dino(args, gen)
    head = DV.ClsHead(gen, cfg.width, num_classes=args.num_classes, layers=4)
    params = nn.ModuleDict({"encoder": encoder, "head": head})
    logging.info(model_summary({"model": params}, trainable_pred=by_keywords("head")))
    dt = _dino_compute_dtype(args)

    def logits_fn(params, x, ops):
        feats = _features(params["encoder"], cfg, x, 4, dt, ops)
        feats = [(p.float(), c.float()) for p, c in feats]
        return DV.cls_head_apply(params["head"], feats, layers=4)

    def forward_train(params, batch, gen, ops=KERNELS):
        x, _ = preprocess(batch["image"], None, args, train=True, gen=gen, ops=ops)
        return logits_fn(params, x, ops), None

    def forward_eval(params, images_u8, ops=KERNELS):
        x, _ = preprocess(images_u8, None, args, train=False)
        return logits_fn(params, x, ops)

    return Bundle(task="cls", params=params, trainable_pred=by_keywords("head"),
                  forward_train=forward_train, forward_eval=forward_eval)


def build_dino_seg_bundle(args, gen: torch.Generator) -> Bundle:
    """Frozen DINOv2 encoder + linear or UNet decoder (dataset-free). The
    UNet's BatchNorm running statistics are the bundle's ``bn_state``."""
    cfg, encoder = _build_dino(args, gen)
    bn = None
    if args.decoder_type == "unet":
        head = DV.UNetDecoder(gen, cfg.width, num_classes=args.num_classes)
        bn = DV.unet_decoder_state(cfg.width, num_classes=args.num_classes)
    else:
        head = DV.LinearDecoder(gen, cfg.width, num_classes=args.num_classes)
    params = nn.ModuleDict({"encoder": encoder, "head": head})
    logging.info(model_summary({"model": params}, trainable_pred=by_keywords("head")))
    n_layers = 5 if args.decoder_type == "unet" else 1
    dt = _dino_compute_dtype(args)
    head_dt = (torch.bfloat16 if args.head_dtype == "bfloat16" and args.decoder_type == "unet"
               else None)

    def logits_fn(params, x, train, ops):
        feats = _features(params["encoder"], cfg, x, n_layers, dt, ops)
        if head_dt is None:
            feats = [(p.float(), c.float()) for p, c in feats]
        if args.decoder_type == "unet":
            return DV.unet_decoder_apply(params["head"], bn, feats, image_size=args.img_size,
                                         patch_size=args.patch_size, train=train,
                                         dtype=head_dt)
        return DV.linear_decoder_apply(params["head"], feats[-1][0], image_size=args.img_size,
                                       patch_size=args.patch_size)

    def forward_train(params, batch, gen, ops=KERNELS):
        x, m = preprocess(batch["image"], batch.get("mask"), args, train=True, gen=gen, ops=ops)
        return logits_fn(params, x, True, ops), m

    def forward_eval(params, images_u8, ops=KERNELS):
        x, _ = preprocess(images_u8, None, args, train=False)
        return logits_fn(params, x, False, ops)

    return Bundle(task="seg", params=params, trainable_pred=by_keywords("head"),
                  forward_train=forward_train, forward_eval=forward_eval, bn_state=bn)


def _dino_main(task: str, argv, fewshot: bool):
    # reference dino CLI defaults: 1000 epochs, batch 24 (dino/classification.py:50-51,
    # dino/segmentation.py:49-50)
    name = "dino_classification" if task == "cls" else "dino_segmentation"
    build = build_dino_cls_bundle if task == "cls" else build_dino_seg_bundle
    return _bundle_main(name, task, argv, build,
                        lambda p: add_dino_flags(p, seg=task == "seg"), fewshot=fewshot,
                        epochs=1000, batch_size=24)


def dino_classification_main(argv=None, *, fewshot: bool = False):
    return _dino_main("cls", argv, fewshot)


def dino_segmentation_main(argv=None, *, fewshot: bool = False):
    return _dino_main("seg", argv, fewshot)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def add_baseline_cls_flags(p):
    p.add_argument("--version", type=str, default="resnet18", choices=sorted(RESNET_SPECS))


def add_baseline_seg_flags(p):
    p.set_defaults(in_channels=1)
    p.add_argument("--init_channels", type=int, default=16)


# reference baselines CLI defaults: 200 epochs, batch 32, augmentation on
def baselines_classification_main(argv=None, *, fewshot: bool = False):
    return _bundle_main("baselines_classification", "cls", argv, build_baseline_cls_bundle,
                        add_baseline_cls_flags, fewshot=fewshot, epochs=200, batch_size=32)


def baselines_segmentation_main(argv=None, *, fewshot: bool = False):
    return _bundle_main("baselines_segmentation", "seg", argv, build_baseline_seg_bundle,
                        add_baseline_seg_flags, fewshot=fewshot, epochs=200, batch_size=32)


def _load_backbone(path: str, model, bn_state):
    """A converted torchvision ResNet (``python -m
    nextgen_uia_tpu_torch.convert resnet*``) or a JAX-written tree, read
    once: the tower by name, a classifier of another width left at init
    (the reference replaces the head for the task's classes), and the
    BatchNorm running statistics from ``__state__/``."""
    flat = ckpt.load_flat(path)
    skip = ()
    fcw = flat.get("fc/w")
    if fcw is not None and tuple(fcw.shape) != tuple(model.fc.w.shape):
        skip = ("fc/",)
        logging.info(f"--backbone_ckpt fc head is {tuple(fcw.shape)}, model wants "
                     f"{tuple(model.fc.w.shape)}: reinitializing fc (reference replaces the "
                     "head)")
    _, n = ckpt.merge_flat(flat, model, source=path, skip=skip)
    ns = 0
    try:
        _, ns = ckpt.merge_flat(flat, nn.ModuleDict({"__state__": bn_state}), source=path)
    except ckpt.NoMatch:
        logging.warning(f"{path} has no __state__/ BN running stats; keeping init statistics")
    logging.info(f"Loaded {n} ResNet tensors (+{ns} BN state) from {path}")


def build_baseline_cls_bundle(args, gen: torch.Generator) -> Bundle:
    """The ResNet baseline classifier, dataset-free (the trainer and the
    predict CLI share it)."""
    model, bn_state = resnet_init(gen, args.version, in_channels=args.in_channels,
                                  num_classes=args.num_classes)
    if args.backbone_ckpt:
        _load_backbone(args.backbone_ckpt, model, bn_state)
    params = nn.ModuleDict({"model": model})
    logging.info(model_summary({"model": params}, trainable_pred=lambda _: True))

    def forward_train(params, batch, gen, ops=KERNELS):
        x, _ = preprocess(batch["image"], None, args, train=True, gen=gen, ops=ops,
                          in_channels=args.in_channels)
        return resnet_apply(params["model"], bn_state, x, args.version, train=True), None

    def forward_eval(params, images_u8, ops=KERNELS):
        x, _ = preprocess(images_u8, None, args, train=False, in_channels=args.in_channels)
        return resnet_apply(params["model"], bn_state, x, args.version)

    return Bundle(task="cls", params=params, trainable_pred=lambda _: True,
                  forward_train=forward_train, forward_eval=forward_eval, bn_state=bn_state)


def build_baseline_seg_bundle(args, gen: torch.Generator) -> Bundle:
    """The UNet baseline segmenter, dataset-free. Its train forward draws
    the augmentation, then the dropout masks, from the step's generator."""
    model, bn_state = unet_init(gen, args.in_channels, args.num_classes,
                                init_channels=args.init_channels)
    params = nn.ModuleDict({"model": model})
    logging.info(model_summary({"model": params}, trainable_pred=lambda _: True))

    def forward_train(params, batch, gen, ops=KERNELS):
        x, m = preprocess(batch["image"], batch.get("mask"), args, train=True, gen=gen, ops=ops,
                          in_channels=args.in_channels)
        return unet_apply(params["model"], bn_state, x, train=True, gen=gen), m

    def forward_eval(params, images_u8, ops=KERNELS):
        x, _ = preprocess(images_u8, None, args, train=False, in_channels=args.in_channels)
        return unet_apply(params["model"], bn_state, x)

    return Bundle(task="seg", params=params, trainable_pred=lambda _: True,
                  forward_train=forward_train, forward_eval=forward_eval, bn_state=bn_state)
