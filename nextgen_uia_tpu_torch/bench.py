"""Headline benchmark of the PyTorch/CUDA port: the BiomedCLIP MONA
contrastive fine-tune step, images per second.

    python -m nextgen_uia_tpu_torch.bench

The step is the one the JAX package's root ``bench.py`` times (its
``main``): BiomedCLIP's ViT-B/16 image tower with hybrid MONA in all 12
blocks, InfoNCE (temperature 0.07) against text features cached once from
seeded token ids in [1, 30000) at context 256 through the frozen
PubMedBERT tower, AdamW (lr 1e-4, cosine over 1000 updates, weight decay
0.01, betas 0.9/0.95, clip 1.0), batch 64 as ONE microbatch of seeded
[1, 64, 224, 224, 3] images, bf16 compute. The frozen weights are rounded
to bf16 values once (the JAX bench casts them to bf16; the port keeps their
float32 storage and casts them to the compute dtype where they are used).
The model is built by ``flagship`` here, the JAX ``__graft_entry__``'s
configuration with seeded random weights.

Knobs (environment, as the JAX bench's): NEXTGEN_UIA_BENCH_BATCH (64),
_STEPS (30 per window), _WARMUP (3), _DEPTH (12; the text tower runs
max(depth // 2, 1) layers when it is cut), _IMG (224), _DTYPE (bfloat16),
_TEXT=1 (the text tower in the step), _TEXT_LEN=<n> (in-step captions of
0.6n..n tokens, trimmed to 32-token buckets). NEXTGEN_UIA_FUSED_MONA=1 runs
MONA through the fused route (ops/fused_mona.py, K12). _SUPERVISED, _EVAL and _INPUT are not
ported and raise.

Two windows of STEPS steps after WARMUP, timed with CUDA events on the card
(the host clock on the CPU); the better window is reported. Prints one JSON
line, {"metric", "value", "unit", "vs_baseline"}, against the JAX bench's
estimate of the reference's A100 throughput (600 img/s); a line on stderr
names the device, the route and the milliseconds per step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .adapters.mona import inject_mona, mona_fused_opted_in
from .core import train as T
from .core.partition import by_keywords, partition
from .losses import info_nce
from .models import clip as clip_mod
from .ops import KERNELS
from .tasks.clip_finetune import make_text_encoder, trim_token_padding

A100_EST_IMG_S = 600.0
METRIC = "BUSI Mona fine-tune images/sec/chip"
NOT_PORTED = ("NEXTGEN_UIA_BENCH_SUPERVISED", "NEXTGEN_UIA_BENCH_EVAL", "NEXTGEN_UIA_BENCH_INPUT")


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

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ.get
        return cls(batch=int(env("NEXTGEN_UIA_BENCH_BATCH", "64")),
                   steps=int(env("NEXTGEN_UIA_BENCH_STEPS", "30")),
                   warmup=int(env("NEXTGEN_UIA_BENCH_WARMUP", "3")),
                   depth=int(env("NEXTGEN_UIA_BENCH_DEPTH", "12")),
                   img=int(env("NEXTGEN_UIA_BENCH_IMG", "224")),
                   dtype=env("NEXTGEN_UIA_BENCH_DTYPE", "bfloat16"),
                   text=env("NEXTGEN_UIA_BENCH_TEXT") == "1",
                   text_len=int(env("NEXTGEN_UIA_BENCH_TEXT_LEN", "0")))


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


@dataclasses.dataclass
class Bench:
    """One built bench: the model on its device, the batch, and the loss."""
    knobs: Knobs
    device: torch.device
    cfg: clip_mod.CLIPConfig
    params: clip_mod.CLIP
    trainable: dict
    batch: dict

    def loss_fn(self, ops=KERNELS):
        encode = make_text_encoder(self.params, self.cfg, self.device, ops=ops)

        def fn(mb, gen):
            img, _ = clip_mod.encode_image(self.params, self.cfg, mb["image"], ops=ops, gen=gen)
            txt = encode(mb["tokens"]) if self.knobs.text else mb["txt_feat"]
            return info_nce(img, txt)
        return fn

    def train_step(self, ops=KERNELS, lr: float = 1e-4):
        tcfg = T.TrainConfig(lr=lr, total_updates=1000)
        return T.TrainStep(self.loss_fn(ops), T.make_optimizer(self.trainable.values(), tcfg),
                           tcfg, grad_clip=1.0)


def build(device, knobs: Knobs) -> Bench:
    """The model, its frozen weights rounded to bf16, the seeded batch and
    (unless the text runs in the step) the text features cached once."""
    device = torch.device(device)
    cfg, params = flagship(knobs.depth, image_size=knobs.img, compute_dtype=knobs.dtype)
    trainable, frozen = partition(params, by_keywords("mona"))
    with torch.no_grad():
        for p in frozen.values():
            p.copy_(p.to(torch.bfloat16).float())
    params.to(device)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((1, knobs.batch, knobs.img, knobs.img, 3), generator=gen)
    tokens = torch.randint(1, 30000, (knobs.batch, 256), generator=torch.Generator().manual_seed(2))
    batch = {"image": images.to(device)}
    if knobs.text:
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


def _window(step, batch, gen, steps, device) -> float:
    """Seconds for ``steps`` steps: CUDA events on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            step(batch, gen)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch, gen)
    return time.perf_counter() - t0


def main(device: str = "cuda") -> dict:
    for var in NOT_PORTED:
        if os.environ.get(var) == "1":
            raise NotImplementedError(f"{var}=1 is not ported to the PyTorch package yet "
                                      "(ROADMAP.md, section A, item 16)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA device and none is available "
                           "(main(device='cpu') runs the plain versions on the CPU)")
    knobs = Knobs.from_env()
    bench = build(device, knobs)
    step = bench.train_step()
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(knobs.warmup):
        step(bench.batch, gen)
    best = min(_window(step, bench.batch, gen, knobs.steps, device) for _ in range(2))
    img_s = knobs.batch * knobs.steps / best
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    route = "fused (NEXTGEN_UIA_FUSED_MONA=1)" if mona_fused_opted_in() else "composed"
    print(f"bench: {kind}, MONA route {route}, batch {knobs.batch} x {knobs.img} px, "
          f"{knobs.dtype}, best of 2 windows of {knobs.steps} steps: "
          f"{best * 1e3 / knobs.steps:.3f} ms per step", file=sys.stderr)
    rec = {"metric": METRIC, "value": round(img_s, 2), "unit": "images/sec/chip",
           "vs_baseline": round(img_s / A100_EST_IMG_S, 3)}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
