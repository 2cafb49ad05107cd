"""Benchmarks of the PyTorch/CUDA port, images per second: the BiomedCLIP
MONA contrastive fine-tune step (the headline), and the JAX bench's three
other modes, the supervised seg step, zero-shot serving and the input
pipeline.

    python -m nextgen_uia_tpu_torch.bench
    NEXTGEN_UIA_BENCH_SUPERVISED=1 python -m nextgen_uia_tpu_torch.bench
    NEXTGEN_UIA_BENCH_EVAL=1 python -m nextgen_uia_tpu_torch.bench
    NEXTGEN_UIA_BENCH_INPUT=1 python -m nextgen_uia_tpu_torch.bench

Every mode times the step the JAX package's root ``bench.py`` times in the
mode of the same name, on the model ``flagship`` builds here (the JAX
``__graft_entry__``'s configuration with seeded random weights: BiomedCLIP's
ViT-B/16 image tower with hybrid MONA in all 12 blocks), its frozen weights
rounded to bf16 values once (the JAX bench casts them to bf16; the port
keeps their float32 storage and casts them to the compute dtype where they
are used).

- Fine-tune (default; the JAX ``main``): InfoNCE (temperature 0.07) against
  text features cached once from seeded token ids in [1, 30000) at context
  256 through the frozen PubMedBERT tower, AdamW (lr 1e-4, cosine over 1000
  updates, weight decay 0.01, betas 0.9/0.95, clip 1.0), batch 64 as ONE
  microbatch of seeded [1, 64, 224, 224, 3] images, bf16 compute.
- Supervised (``_SUPERVISED=1``; ``supervised_bench``): seeded uint8 [1, 32,
  224, 224] images and masks (> 0.7 of a seeded uniform), augmented on the
  device (strong and weak, unless ``_AUGS=0``), the channel repeated to 3,
  the tower's taps {3, 6, 9} into the PyramidHead (reduce 512, 2 classes,
  seg), DiceCE, AdamW over head, MONA and LoRA: the seg trainer's forward
  (``tasks/clip_tasks.py::make_forward``).
- Eval (``_EVAL=1``; ``eval_bench``): the zero-shot path
  (``tasks/clip_tasks.py::make_zero_shot_logits_fn``, forward only) over
  seeded uint8 [B, 224, 224, 3] images, against seeded random L2-normalised
  [10, proj_dim] prompt features per class.
- Input (``_INPUT=1``; ``input_pipeline_bench``): 1024 seeded 256 x 256
  grayscale PNGs (``Knobs.images``, the JAX mode's ``n_images``) in a
  temporary directory, decoded by ``data/datasets.py::decode_image`` (the
  C++ loader unless NEXTGEN_UIA_NATIVE_LOADER=0 or it is not built, else
  PIL; the JSON line names the decoders that ran) and repeated to 3
  channels, batched by ``data/pipeline.py::batches`` and fed through
  ``prefetch_to_device`` to the fine-tune step with seeded random text
  features: two epochs host-only, then two epochs end to end, the rate on
  the host clock (host time included by definition).

Knobs (environment, as the JAX bench's): NEXTGEN_UIA_BENCH_BATCH (64),
_STEPS (30 per window), _WARMUP (3), _DEPTH (12; the text tower runs
max(depth // 2, 1) layers when it is cut), _IMG (224; the input mode
decodes at it), _DTYPE (bfloat16), _TEXT=1 (the text tower in the step),
_TEXT_LEN=<n> (in-step captions of 0.6n..n tokens, trimmed to 32-token
buckets), _SUP_BATCH (32) and _AUGS (1) for the supervised mode,
_EVAL_BATCH (default _BATCH) for the eval mode, _WORKERS (8) for the
input mode; ``main(device, knobs)`` takes a ``Knobs`` in their place. NEXTGEN_UIA_FUSED_MONA=1 runs MONA through the
fused route (ops/fused_mona.py, K12).

Two windows of STEPS steps after WARMUP, timed with CUDA events on the card
(the host clock on the CPU); the better window is reported, for one device.
Prints one JSON line with the JAX mode's keys: {"metric", "value", "unit",
"vs_baseline"}, against the JAX bench's estimates of the reference's A100
throughput (600 img/s training, 2000 eval), and the mode's own ("batch",
"augs"; the input mode's host-only rate, decoder, workers and image count);
a line on stderr names the device and the milliseconds per step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from torch import nn

from .adapters.mona import inject_mona, mona_fused_opted_in
from .core import train as T
from .core.partition import by_keywords, partition
from .data import datasets as D
from .data import pipeline as P
from .losses import dice_ce_loss, info_nce
from .models import clip as clip_mod
from .models.heads import PyramidHeadConfig, pyramid_head_init
from .ops import KERNELS
from .tasks import prompts as PR
from .tasks.clip_finetune import make_text_encoder, trim_token_padding
from .tasks.clip_tasks import make_forward, make_zero_shot_logits_fn

A100_EST_IMG_S = 600.0
A100_EVAL_EST_IMG_S = 2000.0
METRIC = "BUSI Mona fine-tune images/sec/chip"
SUPERVISED_METRIC = "BUSI supervised seg train images/sec/chip"
EVAL_METRIC = "BUSI zero-shot eval images/sec/chip"
INPUT_METRIC = "input-pipeline e2e images/sec (2 epochs, real files)"
INPUT_EPOCHS, INPUT_PNG = 2, 256


@dataclasses.dataclass(frozen=True)
class Knobs:
    batch: int = 64
    steps: int = 30
    warmup: int = 3
    depth: int = 12
    img: int = 224
    dtype: str = "bfloat16"
    text: bool = False
    text_len: int = 0
    sup_batch: int = 32
    augs: bool = True
    eval_batch: int = 64
    workers: int = 8
    images: int = 1024

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ.get
        batch = env("NEXTGEN_UIA_BENCH_BATCH", "64")
        return cls(batch=int(batch),
                   steps=int(env("NEXTGEN_UIA_BENCH_STEPS", "30")),
                   warmup=int(env("NEXTGEN_UIA_BENCH_WARMUP", "3")),
                   depth=int(env("NEXTGEN_UIA_BENCH_DEPTH", "12")),
                   img=int(env("NEXTGEN_UIA_BENCH_IMG", "224")),
                   dtype=env("NEXTGEN_UIA_BENCH_DTYPE", "bfloat16"),
                   text=env("NEXTGEN_UIA_BENCH_TEXT") == "1",
                   text_len=int(env("NEXTGEN_UIA_BENCH_TEXT_LEN", "0")),
                   sup_batch=int(env("NEXTGEN_UIA_BENCH_SUP_BATCH", "32")),
                   augs=env("NEXTGEN_UIA_BENCH_AUGS", "1") == "1",
                   eval_batch=int(env("NEXTGEN_UIA_BENCH_EVAL_BATCH", batch)),
                   workers=int(env("NEXTGEN_UIA_BENCH_WORKERS", "8")))


def flagship(depth: int = 12, *, image_size: int = 224, compute_dtype: str = "bfloat16"):
    """(cfg, CLIP module on the CPU): BiomedCLIP with hybrid MONA in every
    block, seeded random weights. A depth cut shrinks the text tower to
    max(depth // 2, 1) layers; an image-size change alone keeps it."""
    cfg = clip_mod.clip_config("biomedclip", compute_dtype=compute_dtype, mona_variant="hybrid")
    if image_size != 224:
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, image_size=image_size))
    if depth != 12:
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, depth=depth),
                          text=dataclasses.replace(cfg.text, depth=max(depth // 2, 1)))
    params = clip_mod.clip_init(torch.Generator().manual_seed(0), cfg)
    inject_mona(torch.Generator().manual_seed(1), params.visual, dim=cfg.vision.width,
                variant="hybrid")
    return cfg, params


def _round_to_bf16(tensors):
    with torch.no_grad():
        for p in tensors:
            p.copy_(p.to(torch.bfloat16).float())


def _adamw(trainable, loss_fn, lr: float = 1e-4):
    tcfg = T.TrainConfig(lr=lr, total_updates=1000)
    return T.TrainStep(loss_fn, T.make_optimizer(trainable.values(), tcfg), tcfg, grad_clip=1.0)


@dataclasses.dataclass
class Bench:
    """One built fine-tune bench: the model on its device, the batch, and the
    loss."""
    knobs: Knobs
    device: torch.device
    cfg: clip_mod.CLIPConfig
    params: clip_mod.CLIP
    trainable: dict
    batch: dict

    def loss_fn(self, ops=KERNELS):
        encode = make_text_encoder(self.params, self.cfg, self.device, ops=ops)

        def fn(mb, gen):
            x = mb["image"]
            if x.dtype == torch.uint8:  # decoded files (the input mode)
                x = x.to(torch.float32) / 255.0
            img, _ = clip_mod.encode_image(self.params, self.cfg, x, ops=ops, gen=gen)
            txt = encode(mb["tokens"]) if self.knobs.text else mb["txt_feat"]
            return info_nce(img, txt)
        return fn

    def train_step(self, ops=KERNELS, lr: float = 1e-4):
        return _adamw(self.trainable, self.loss_fn(ops), lr)


def build(device, knobs: Knobs, *, txt_feat=None) -> Bench:
    """The model, its frozen weights rounded to bf16, the seeded batch and
    (unless the text runs in the step, or ``txt_feat`` [1, B, embed] is
    given) the text features cached once."""
    device = torch.device(device)
    cfg, params = flagship(knobs.depth, image_size=knobs.img, compute_dtype=knobs.dtype)
    trainable, frozen = partition(params, by_keywords("mona"))
    _round_to_bf16(frozen.values())
    params.to(device)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((1, knobs.batch, knobs.img, knobs.img, 3), generator=gen)
    tokens = torch.randint(1, 30000, (knobs.batch, 256), generator=torch.Generator().manual_seed(2))
    batch = {"image": images.to(device)}
    if txt_feat is not None:
        batch["txt_feat"] = txt_feat.to(device)
    elif knobs.text:
        if knobs.text_len:
            t = tokens.numpy().copy()
            lengths = np.random.default_rng(0).integers(
                max(int(0.6 * knobs.text_len), 8), knobs.text_len + 1, knobs.batch)
            for i, n in enumerate(lengths):
                t[i, n:] = 0
            tokens = torch.from_numpy(trim_token_padding(t))
        batch["tokens"] = tokens[None].to(device)
    else:
        batch["txt_feat"] = make_text_encoder(params, cfg, device)(tokens)[None]
    return Bench(knobs, device, cfg, params, trainable, batch)


@dataclasses.dataclass
class SupervisedBench:
    """The supervised seg bench: backbone and PyramidHead on the device, the
    seeded uint8 batch [1, B, IMG, IMG] of images and masks."""
    knobs: Knobs
    device: torch.device
    cfg: clip_mod.CLIPConfig
    hcfg: PyramidHeadConfig
    params: nn.ModuleDict
    trainable: dict
    batch: dict

    def loss_fn(self, ops=KERNELS, augs: bool | None = None):
        """(microbatch, gen) -> DiceCE of the seg trainer's forward; ``gen``
        draws the augmentation plan and the dropout (None: no dropout, and
        augmentation must be off)."""
        augs = self.knobs.augs if augs is None else augs
        forward = make_forward(self.cfg, self.hcfg, train=True, strong=augs, weak=augs)

        def fn(mb, gen):
            logits, m = forward(self.params, mb["image"], mb["mask"], gen, ops=ops)
            return dice_ce_loss(logits, m)
        return fn

    def train_step(self, ops=KERNELS, lr: float = 1e-4):
        return _adamw(self.trainable, self.loss_fn(ops), lr)


def build_supervised(device, knobs: Knobs) -> SupervisedBench:
    device = torch.device(device)
    cfg, backbone = flagship(knobs.depth, image_size=knobs.img, compute_dtype=knobs.dtype)
    hcfg = PyramidHeadConfig(feature_dim=cfg.vision.width, reduce_dim=512, num_classes=2,
                             img_size=knobs.img, task="seg", cls_hidden=False)
    params = nn.ModuleDict({"backbone": backbone,
                            "head": pyramid_head_init(torch.Generator().manual_seed(7), hcfg)})
    trainable, frozen = partition(params, by_keywords("head", "mona", "lora"))
    _round_to_bf16(frozen.values())
    params.to(device)
    shape = (1, knobs.sup_batch, knobs.img, knobs.img)
    images = torch.randint(0, 255, shape, generator=torch.Generator().manual_seed(1),
                           dtype=torch.uint8)
    masks = (torch.rand(shape, generator=torch.Generator().manual_seed(2)) > 0.7).to(torch.uint8)
    return SupervisedBench(knobs, device, cfg, hcfg, params, trainable,
                           {"image": images.to(device), "mask": masks.to(device)})


@dataclasses.dataclass
class EvalBench:
    """The zero-shot bench: the model on the device, seeded prompt features
    and the seeded uint8 batch [B, IMG, IMG, 3]."""
    knobs: Knobs
    device: torch.device
    cfg: clip_mod.CLIPConfig
    params: clip_mod.CLIP
    text_feats: dict
    images: torch.Tensor


def build_eval(device, knobs: Knobs) -> EvalBench:
    device = torch.device(device)
    cfg, params = flagship(knobs.depth, image_size=knobs.img, compute_dtype=knobs.dtype)
    _, frozen = partition(params, by_keywords("mona"))
    _round_to_bf16(frozen.values())
    params.to(device)
    text_feats = {}
    for i, c in enumerate(PR.LESION_TYPES):
        f = torch.randn((10, cfg.vision.proj_dim), generator=torch.Generator().manual_seed(10 + i))
        text_feats[c] = (f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)).to(device)
    images = torch.randint(0, 255, (knobs.eval_batch, knobs.img, knobs.img, 3),
                           generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    return EvalBench(knobs, device, cfg, params, text_feats, images.to(device))


def write_pngs(root: str, n: int, size: int = INPUT_PNG, seed: int = 0) -> list:
    """``n`` seeded grayscale PNGs [size, size] under ``root`` (the JAX input
    bench's files: ``default_rng(seed).integers(0, 255)`` per image, in
    order)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"img_{i:05d}.png")
        Image.fromarray(rng.integers(0, 255, (size, size), dtype=np.uint8), "L").save(path)
        paths.append(path)
    return paths


class DecodedImages:
    """Grayscale decode through ``data/datasets.py::decode_image`` (the
    supervised trainers' ``load_image``) at ``img_size``, repeated to the 3
    channels [img_size, img_size, 3] uint8 the tower takes; ``decoders``
    holds the name of every decoder that decoded an item."""

    def __init__(self, paths, img_size: int):
        self.paths, self.img_size = paths, img_size
        self.decoders: set[str] = set()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        g, decoder = D.decode_image(self.paths[i], self.img_size)
        self.decoders.add(decoder)
        return {"image": np.repeat(g[:, :, None], 3, axis=2)}


def input_batches(ds, batch: int, workers: int, txt_feat: np.ndarray):
    """One epoch of the input mode's feed: the seeded shuffle of ``ds``
    (seed 0, drop_last), as one-microbatch steps {"image": [1, B, S, S, 3]
    uint8, "txt_feat": [1, B, embed]}."""
    for b in P.batches(ds, batch, shuffle=True, drop_last=True, seed=0, workers=workers):
        yield {"image": b["image"][None], "txt_feat": txt_feat[None]}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(fn, steps: int, device) -> float:
    """Seconds for ``steps`` calls of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return time.perf_counter() - t0


def _best(fn, knobs: Knobs, device) -> float:
    """Seconds of the better of two windows, after the warm-up calls."""
    for _ in range(knobs.warmup):
        fn()
    _sync(device)
    return min(_window(fn, knobs.steps, device) for _ in range(2))


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def finetune_bench(device, knobs: Knobs) -> dict:
    bench = build(device, knobs)
    step = bench.train_step()
    gen = torch.Generator(device=device).manual_seed(0)
    best = _best(lambda: step(bench.batch, gen), knobs, device)
    img_s = knobs.batch * knobs.steps / best
    route = "fused (NEXTGEN_UIA_FUSED_MONA=1)" if mona_fused_opted_in() else "composed"
    print(f"bench: {_kind(device)}, MONA route {route}, batch {knobs.batch} x {knobs.img} px, "
          f"{knobs.dtype}, best of 2 windows of {knobs.steps} steps: "
          f"{best * 1e3 / knobs.steps:.3f} ms per step", file=sys.stderr)
    return {"metric": METRIC, "value": round(img_s, 2), "unit": "images/sec/chip",
            "vs_baseline": round(img_s / A100_EST_IMG_S, 3)}


def supervised_bench(device, knobs: Knobs) -> dict:
    bench = build_supervised(device, knobs)
    step = bench.train_step()
    gen = torch.Generator(device=device).manual_seed(0)
    best = _best(lambda: step(bench.batch, gen), knobs, device)
    img_s = knobs.sup_batch * knobs.steps / best
    print(f"bench: {_kind(device)}, supervised seg, batch {knobs.sup_batch} x {knobs.img} px, "
          f"{knobs.dtype}, augmentation {'on' if knobs.augs else 'off'}, best of 2 windows of "
          f"{knobs.steps} steps: {best * 1e3 / knobs.steps:.3f} ms per step", file=sys.stderr)
    return {"metric": SUPERVISED_METRIC, "value": round(img_s, 2), "unit": "images/sec/chip",
            "vs_baseline": round(img_s / A100_EST_IMG_S, 3), "batch": knobs.sup_batch,
            "augs": knobs.augs}


def eval_bench(device, knobs: Knobs) -> dict:
    bench = build_eval(device, knobs)
    logits = make_zero_shot_logits_fn(bench.cfg, bench.text_feats)
    best = _best(lambda: logits(bench.params, bench.images), knobs, device)
    img_s = knobs.eval_batch * knobs.steps / best
    print(f"bench: {_kind(device)}, zero-shot eval, batch {knobs.eval_batch} x {knobs.img} px, "
          f"{knobs.dtype}, best of 2 windows of {knobs.steps} batches: "
          f"{best * 1e3 / knobs.steps:.3f} ms per batch", file=sys.stderr)
    return {"metric": EVAL_METRIC, "value": round(img_s, 2), "unit": "images/sec/chip",
            "vs_baseline": round(img_s / A100_EVAL_EST_IMG_S, 3), "batch": knobs.eval_batch}


def input_pipeline_bench(device, knobs: Knobs) -> dict:
    if knobs.batch > knobs.images:
        raise SystemExit(f"NEXTGEN_UIA_BENCH_BATCH={knobs.batch} exceeds the {knobs.images} "
                         "generated images: drop_last would yield zero batches. Lower the "
                         "batch size or raise Knobs.images.")
    root = tempfile.mkdtemp(prefix="uia_input_bench_")
    try:
        ds = DecodedImages(write_pngs(root, knobs.images), knobs.img)
        embed = clip_mod.clip_config("biomedclip").vision.proj_dim
        feat = torch.randn((knobs.batch, embed),
                           generator=torch.Generator().manual_seed(3)).numpy()
        bench = build(device, knobs, txt_feat=torch.from_numpy(feat)[None])
        step = bench.train_step()
        gen = torch.Generator(device=device).manual_seed(0)
        # one step outside the timed epochs (the first calls build workspaces)
        first = np.repeat(ds[0]["image"][None, None], knobs.batch, axis=1)
        step({"image": torch.from_numpy(first).to(device), "txt_feat": bench.batch["txt_feat"]},
             gen)
        _sync(device)

        def epochs(feed_device: bool) -> float:
            t0, n = time.perf_counter(), 0
            for _ in range(INPUT_EPOCHS):
                feed = input_batches(ds, knobs.batch, knobs.workers, feat)
                if feed_device:
                    for mb in P.prefetch_to_device(feed, device=device):
                        step(mb, gen)
                        n += knobs.batch
                    _sync(device)
                else:
                    for mb in feed:
                        n += mb["image"].shape[1]
            return n / (time.perf_counter() - t0)

        host_rate = epochs(feed_device=False)
        e2e_rate = epochs(feed_device=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    decode = "+".join(sorted(ds.decoders))
    print(f"bench: {_kind(device)}, input pipeline, {knobs.images} PNGs decoded by {decode} at "
          f"{knobs.img} px, {knobs.workers} workers, batch {knobs.batch}, {knobs.dtype}: "
          f"{e2e_rate:.2f} img/s end to end, {host_rate:.2f} img/s host only", file=sys.stderr)
    return {"metric": INPUT_METRIC, "value": round(e2e_rate, 2), "unit": "images/sec",
            "vs_baseline": round(e2e_rate / A100_EST_IMG_S, 3),
            "host_only_images_per_sec": round(host_rate, 2), "decode": decode,
            "workers": knobs.workers, "n_images": knobs.images}


MODES = (("NEXTGEN_UIA_BENCH_INPUT", input_pipeline_bench), ("NEXTGEN_UIA_BENCH_EVAL", eval_bench),
         ("NEXTGEN_UIA_BENCH_SUPERVISED", supervised_bench))


def main(device: str = "cuda", knobs: Knobs | None = None) -> dict:
    """Runs the mode the environment selects (the JAX bench's order: input,
    eval, supervised, else the fine-tune step) with ``knobs`` (default: the
    environment's), prints its JSON line and returns it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA device and none is available "
                           "(main(device='cpu') runs the plain versions on the CPU)")
    mode = next((fn for var, fn in MODES if os.environ.get(var) == "1"), finetune_bench)
    rec = mode(device, Knobs.from_env() if knobs is None else knobs)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
