"""Zero-shot classification and supervised seg/cls for the CLIP families
(counterpart of nextgen_uia_tpu/tasks/clip_tasks.py), on one device or
data-parallel over the processes of a ``torchrun`` launch (core/mesh.py).

  - zero-shot: each class's 10-prompt ensemble through the frozen text tower
    (forward only), L2-normalised; the logits are the mean over prompts of
    100 * cos; the prompt-similarity warning above 0.95 and the
    feature-collapse eigenvalue check over every test feature; metrics,
    ROC and results.csv in the acc-tagged backup folder.
  - supervised: the backbone with its adapters (MONA, or LoRA from
    ``--lora_weights``) plus a PyramidHead (the OpenAI family's with its
    hidden cls layer), the train and eval forwards over decoded uint8
    images, and the trainer's entry point, with the few-shot subset of the
    train split when asked (``fewshot=True``).
"""

from __future__ import annotations

import logging
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from ..core import checkpoint as ckpt
from ..core import mesh as M
from ..core import train as T
from ..core.experiment import model_summary
from ..core.partition import by_keywords
from ..data import datasets as D
from ..data import pipeline as P
from ..metrics.segmentation import ClsAccumulator
from ..models import clip as clip_mod
from ..models.heads import PyramidHeadConfig, pyramid_head_apply, pyramid_head_init
from ..ops import KERNELS
from . import prompts as PR
from .clip_finetune import make_text_encoder
from .common import (apply_compat_flags, base_parser, build_clip_model, get_text_tokenizer,
                     require_real_tokenizer, seed_everything, setup_run)
from .supervised import (Bundle, add_fewshot_flags, apply_fewshot, finish_cls, preprocess,
                         run_supervised)


def extract_layers_for(depth: int):
    """Pyramid taps {3,6,9} for ViT-B; the last three blocks for shrunk towers."""
    return (3, 6, 9) if depth >= 10 else tuple(range(max(depth - 3, 0), depth))


def build_text_features(params, cfg, tokenizer, ensemble, *, classes=None, ops=KERNELS):
    """class -> [n_prompts, embed] float32 L2-normalised prompt features on
    the parameters' device: each class's ensemble through the frozen text
    tower, forward only (``clip_finetune.make_text_encoder``)."""
    classes = classes or PR.LESION_TYPES
    encode = make_text_encoder(params, cfg, next(params.parameters()).device, ops=ops)
    return {c: clip_mod.normalize(encode(tokenizer(ensemble[c]))) for c in classes}


def make_zero_shot_logits_fn(cfg, text_feats, *, classes=None):
    """(params, images_u8 [B, H, W] or [B, H, W, 3]) -> ([B, n_cls] logits,
    [B, embed] normalised image features), forward only: the image tower's
    blocks through the whole-block kernel (``infer_cfg``), each logit the
    mean over the class's prompts of 100 * cos."""
    classes = classes or PR.LESION_TYPES
    ecfg = clip_mod.infer_cfg(cfg)

    @torch.inference_mode()
    def image_logits(params, images_u8, ops=KERNELS):
        x = images_u8.to(torch.float32) / 255.0
        if x.dim() == 3:  # grayscale [B, H, W]
            x = x[..., None].expand(-1, -1, -1, 3)
        feats, _ = clip_mod.encode_image(params, ecfg, x, ops=ops)
        feats = clip_mod.normalize(feats)
        cols = [(100.0 * feats @ text_feats[c].T).mean(dim=1) for c in classes]
        return torch.stack(cols, dim=1), feats

    return image_logits


def zero_shot_main(family: str, argv=None):
    """Zero-shot classification over the train, val and test splits together
    (reference CLI defaults: batch 32, freq_enhanced MONA for biomedclip,
    noise_aware for the others)."""
    p = base_parser(f"{family}_zero_shot", batch_size=32,
                    mona_variant="freq_enhanced" if family == "biomedclip" else "noise_aware")
    args = p.parse_args(argv)
    apply_compat_flags(args)
    # evaluation spreads over every process of the launch, data-parallel
    mesh = M.make_mesh(args.n_data, args.n_model, device=args.device)
    device = mesh.device
    gen = seed_everything(args.seed)
    run_path = setup_run(args, "test")
    args.test_snapshot_path = run_path

    adapter = "lora" if args.lora_weights else ("mona" if args.mona_weights else None)
    cfg, params = build_clip_model(args, family, adapter=adapter, gen=gen)
    tokenizer = get_text_tokenizer(args, family)
    require_real_tokenizer(args, tokenizer, family)
    params.to(device)

    text_feats = build_text_features(params, cfg, tokenizer,
                                     PR.prompt_ensemble_for(args.dataset))
    proto = {c: text_feats[c].mean(dim=0) for c in PR.LESION_TYPES}
    proto_sim = float(proto["benign"] @ proto["malignant"])
    if proto_sim > 0.95:
        logging.warning(f"Text prompts very similar: {proto_sim:.4f}")

    datasets = D.make_datasets(args.data_root, args.dataset, args.img_size, task="cls",
                               zero_shot=True, cache=args.cache_images)
    image_logits = T.make_sharded_apply(make_zero_shot_logits_fn(cfg, text_feats), mesh)
    acc = ClsAccumulator(criterion=cross_entropy_np)
    collected = []

    def padded():
        for b in P.batches(datasets["test"], args.batch_size, shuffle=False, drop_last=False,
                           workers=args.num_workers):
            b, n_real = T.pad_eval_batch(b, image_logits.dp_width)
            b["n_real"] = n_real
            yield b

    for batch in P.prefetch_to_device(padded(), device=device):
        n = batch["n_real"]
        logits, feats = image_logits(params, batch["image"])
        acc.update(logits[:n].cpu().numpy(), batch["label"][:n].cpu().numpy())
        collected.append(feats[:n].cpu().numpy())  # every test feature, for the check below

    feats = np.concatenate(collected, axis=0)
    if len(feats) > 10:  # feature collapse: one direction holding the covariance
        cov = feats.T @ feats / len(feats)
        eig = np.abs(np.linalg.eigvalsh(cov))[::-1]
        ratio = eig[0] / max(eig.sum(), 1e-12)
        if ratio > 0.95:
            logging.warning(f"Features may be collapsed (ratio={ratio:.4f})")

    stats = acc.compute()
    if mesh.is_main:
        finish_cls(args, acc, stats, run_path, f"roc_curve_{family}_zero_shot")
    return stats


def cross_entropy_np(logits, labels):
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-np.mean(logp[np.arange(len(labels)), labels.astype(int)]))


def _build_supervised(args, family: str, task: str, gen: torch.Generator):
    """(cfg, head cfg, ModuleDict{backbone, head}) on the CPU, with
    ``--head_weights`` merged in: first as a supervised-training checkpoint
    rooted at 'params/', then as a bare-rooted one."""
    adapter = "lora" if args.lora_weights else ("mona" if args.mona_weights else None)
    cfg, backbone = build_clip_model(args, family, adapter=adapter, gen=gen)
    hcfg = PyramidHeadConfig(feature_dim=cfg.vision.width, reduce_dim=args.reduce_dim,
                             num_classes=args.num_classes, img_size=args.img_size,
                             task=task, cls_hidden=family == "openai")
    head = pyramid_head_init(gen, hcfg)
    params = nn.ModuleDict({"backbone": backbone, "head": head})
    if args.head_weights:
        try:
            _, n = ckpt.load_into(args.head_weights, nn.ModuleDict({"params": params}))
        except ckpt.NoMatch:
            _, n = ckpt.load_into(args.head_weights, params)
        logging.info(f"Loaded {n} tensors from {args.head_weights}")
    return cfg, hcfg, params


def make_forward(cfg, hcfg, *, train: bool, strong: bool = False, weak: bool = False):
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


def supervised_main(family: str, task: str, argv=None, *, fewshot: bool = False):
    """The supervised seg/cls trainer (reference CLI defaults: batch 32,
    strong and weak augmentation on; biomedclip 200 epochs and hybrid MONA,
    the others 1000 epochs and noise_aware, except freq_enhanced for openai
    cls). ``fewshot``: the few-shot flags, and training on the sampled
    subset."""
    defaults = dict(epochs=200 if family == "biomedclip" else 1000, batch_size=32,
                    strong_augs=True, weak_augs=True,
                    mona_variant="hybrid" if family == "biomedclip" else "noise_aware")
    if family == "openai" and task == "cls":
        defaults["mona_variant"] = "freq_enhanced"  # the reference's clip/classification.py
    p = base_parser(f"{family}_{task}", **defaults)
    if fewshot:
        add_fewshot_flags(p)
    args = p.parse_args(argv)
    apply_compat_flags(args)
    mesh = M.make_mesh(args.n_data, args.n_model, device=args.device)
    device = mesh.device
    gen = seed_everything(args.seed)

    run_path = setup_run(args, "test" if args.test else "train")
    cfg, hcfg, params = _build_supervised(args, family, task, gen)
    trainable_pred = by_keywords("head", "mona", "lora")
    logging.info(model_summary({"model": params}, trainable_pred=trainable_pred))
    datasets = D.make_datasets(args.data_root, args.dataset, args.img_size,
                               task="seg" if task == "seg" else "cls",
                               cache=args.cache_images)
    if fewshot:
        apply_fewshot(args, datasets, task)
    params.to(device)
    fwd_train = make_forward(cfg, hcfg, train=True, strong=args.strong_augs,
                             weak=args.weak_augs)
    fwd_eval = make_forward(cfg, hcfg, train=False)

    def forward_train(params, batch, gen):
        return fwd_train(params, batch["image"], batch.get("mask"), gen)

    bundle = Bundle(task=task, params=params, trainable_pred=trainable_pred,
                    forward_train=forward_train, forward_eval=fwd_eval)
    return run_supervised(args, bundle, datasets, run_path, f"{family}_{task}", device, mesh)
