#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the toolchain.
2. Builds the port's CUDA kernels (nextgen_uia_tpu_torch/csrc, nvcc sm_90a).
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and one odd shape, with CUDA-event times.
   fused_block_infer: float32 max|d| <= 1e-4 * max|ref|; bfloat16 input
   against the float32 plain version max|d| <= 3e-2 (unit-scale input).
   mona_spatial: float32 max|d| <= 1e-5; bfloat16 <= one bf16 ulp of the
   output's scale.
4. Slice phase: BiomedCLIP ViT-B/16 at 224 px with hybrid MONA in all 12
   blocks and a 2-class seg PyramidHead, seeded random weights written to
   .npz and loaded back through --backbone_ckpt/--mona_weights/--head_weights,
   served over 3 batches of 32 and a ragged batch of 5 seeded uint8 images
   by the same per-batch function the predict CLI runs. Checks finite
   outputs of the right shape, that each block kernel launched once per
   block and batch, and the logits against a plain-path run on the card;
   prints img/s at batch 32.
5. Prints one JSON line of per-kernel results, then the final status line.

Exits non-zero without a CUDA device or without the repository beside it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEG_CLASSES, IMG, BATCH, RAGGED, N_BATCHES = 2, 224, 32, 5, 4


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(dev):
    import torch

    from nextgen_uia_tpu_torch.models.vit import VIT_B16_TIMM, Block, ViTConfig
    from nextgen_uia_tpu_torch.ops import dwconv
    from nextgen_uia_tpu_torch.ops import fused_block as fb

    gen = torch.Generator().manual_seed(0)
    results = {}

    def block(width, heads):
        blk = Block(gen, ViTConfig(width=width, heads=heads))
        with torch.no_grad():
            for ln in (blk.ln1, blk.ln2):
                ln.scale.add_(0.1 * torch.randn(width, generator=gen))
                ln.bias.add_(0.1 * torch.randn(width, generator=gen))
        return blk.to(dev)

    with torch.no_grad():
        # K1 at the serving shape: B=32, N=197, D=768, 12 heads, hidden 3072
        cfg = VIT_B16_TIMM
        blk = block(cfg.width, cfg.heads)
        kw = dict(heads=cfg.heads, act=cfg.act, eps=cfg.ln_eps)
        x = torch.randn(BATCH, cfg.seq_len, cfg.width, generator=gen).to(dev)
        ref = fb.fused_block_infer_plain(x, blk, **kw)
        rel32 = ((fb.fused_block_infer(x, blk, **kw) - ref).abs().max() / ref.abs().max()).item()
        xb = x.to(torch.bfloat16)
        ref_b = fb.fused_block_infer_plain(xb.float(), blk, **kw)
        err_b = (fb.fused_block_infer(xb, blk, **kw).float() - ref_b).abs().max().item()
        # odd shape: 50 tokens of which 41 real, key bias, quick_gelu, 2 heads
        small = block(128, 2)
        xo = torch.randn(3, 50, 128, generator=gen).to(dev)
        kb = torch.randn(3, 50, generator=gen).to(dev)
        okw = dict(heads=2, act="quick_gelu", key_bias=kb, n_real=41)
        ref_o = fb.fused_block_infer_plain(xo, small, **okw)
        rel_o = ((fb.fused_block_infer(xo, small, **okw) - ref_o).abs().max()
                 / ref_o.abs().max()).item()
        ms = cuda_ms(lambda: fb.fused_block_infer(xb, blk, **kw), 20)
        plain_ms = cuda_ms(lambda: fb.fused_block_infer_plain(xb, blk, **kw), 20)
        print(f"K1 fused_block_infer [32,197,768] h12: f32 rel max|d| {rel32:.3e} "
              f"(<= 1e-4); bf16 max|d| {err_b:.3e} (<= 3e-2, max|ref| "
              f"{ref_b.abs().max().item():.3f}); odd [3,50,128] n_real 41 f32 rel "
              f"{rel_o:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (bf16 input)")
        require(rel32 <= 1e-4 and rel_o <= 1e-4, "fused_block_infer float32 mismatch")
        require(err_b <= 3e-2, "fused_block_infer bfloat16 mismatch")
        results["fused_block_infer"] = dict(max_abs_err=err_b, ms=ms, plain_ms=plain_ms)

        # K2 at the serving shape [32, 14, 14, 64] and an odd one
        errs = []
        for shape in ((BATCH, 14, 14, 64), (3, 9, 11, 24)):
            b, _, _, c = shape
            s = torch.randn(shape, generator=gen).to(dev)
            freq = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev)
            kern = (0.2 * torch.randn(b, 7, 7, c, generator=gen)).to(dev)
            bias = torch.randn(b, c, generator=gen).to(dev)
            err32 = (dwconv.mona_spatial(s, freq, kern, bias)
                     - dwconv.mona_spatial_plain(s, freq, kern, bias)).abs().max().item()
            args_b = [t.to(torch.bfloat16) for t in (s, freq, kern, bias)]
            ref_b = dwconv.mona_spatial_plain(*[t.float() for t in args_b])
            err_b = (dwconv.mona_spatial(*args_b).float() - ref_b).abs().max().item()
            ulp = 2.0 ** (torch.floor(torch.log2(ref_b.abs().max())).item() - 7)
            print(f"K2 mona_spatial {list(shape)}: f32 max|d| {err32:.3e} (<= 1e-5); "
                  f"bf16 max|d| {err_b:.3e} (<= {ulp:.3e}, one ulp)")
            require(err32 <= 1e-5, f"mona_spatial float32 mismatch at {shape}")
            require(err_b <= ulp, f"mona_spatial bfloat16 mismatch at {shape}")
            errs.append((err_b, args_b))
        err_b, args_b = errs[0]
        ms = cuda_ms(lambda: dwconv.mona_spatial(*args_b), 200)
        plain_ms = cuda_ms(lambda: dwconv.mona_spatial_plain(*args_b), 200)
        print(f"K2 mona_spatial [32,14,14,64] bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["mona_spatial"] = dict(max_abs_err=err_b, ms=ms, plain_ms=plain_ms)
    return results


def slice_phase(dev, work):
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
    from nextgen_uia_tpu_torch.ops import PLAIN, dwconv
    from nextgen_uia_tpu_torch.ops import fused_block as fb
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, _make_forward
    from nextgen_uia_tpu_torch.tasks.common import base_parser
    from nextgen_uia_tpu_torch.tasks.serve import iter_padded, make_infer

    # seeded random weights at the published shapes, written as the JAX
    # package writes them: backbone, MONA slots, and the head
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    cfg = clip_mod.clip_config("biomedclip", compute_dtype="bfloat16", mona_variant="hybrid")
    backbone = clip_mod.clip_init(gen, cfg)
    files = {k: os.path.join(work, f"{k}.npz") for k in ("backbone", "mona", "head")}
    ckpt.save(files["backbone"], backbone)
    inject_mona(gen, backbone.visual, dim=cfg.vision.width, variant="hybrid")
    ckpt.save(files["mona"], backbone, keyword_filter=["mona"])
    head = pyramid_head_init(gen, PyramidHeadConfig(feature_dim=cfg.vision.width,
                                                    num_classes=SEG_CLASSES, img_size=IMG))
    ckpt.save(files["head"], torch.nn.ModuleDict({"head": head}))
    source = torch.nn.ModuleDict({"backbone": backbone, "head": head}).state_dict()

    args = base_parser("chip_smoke").parse_args([
        "--mona_variant", "hybrid", "--num_classes", str(SEG_CLASSES),
        "--img_size", str(IMG), "--batch_size", str(BATCH), "--device", "cuda",
        "--backbone_ckpt", files["backbone"], "--mona_weights", files["mona"],
        "--head_weights", files["head"]])
    cfg, hcfg, params = _build_supervised(args, "biomedclip", "seg",
                                          torch.Generator().manual_seed(1))
    loaded = params.state_dict()
    require(sorted(loaded) == sorted(source)
            and all(torch.equal(loaded[k], source[k]) for k in source),
            "weights did not round-trip through the .npz bridge")
    params.to(dev)
    infer = make_infer(_make_forward(cfg, hcfg, train=False), params, dev)
    print(f"slice: built and loaded {len(source)} tensors via the .npz bridge in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    sizes = [BATCH] * (N_BATCHES - 1) + [RAGGED]
    batches = [([f"img{i}_{j}" for j in range(n)],
                rng.integers(0, 256, (n, IMG, IMG), dtype=np.uint8), [True] * n)
               for i, n in enumerate(sizes)]

    fb.fused_block_infer.launches = 0
    dwconv.mona_spatial.launches = 0
    t0 = time.perf_counter()
    outs = [logits for _, _, logits in iter_padded(iter(batches), BATCH, infer, dev)]
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {"fused_block_infer": fb.fused_block_infer.launches,
                "mona_spatial": dwconv.mona_spatial.launches}
    depth = cfg.vision.depth
    print(f"slice: served {sum(sizes)} images in {N_BATCHES} batches in {host_s:.2f} s "
          f"(host clock, first batches included); launches {launches}")
    for want_n, out in zip(sizes, outs):
        require(out.shape == (want_n, SEG_CLASSES, IMG, IMG), f"logits shape {out.shape}")
        require(np.isfinite(out).all(), "non-finite logits")
    for name, n in launches.items():
        require(n == depth * N_BATCHES, f"{name} launched {n} times, want {depth * N_BATCHES}")

    # the same batches through the plain versions on the card
    worst, scale = 0.0, 0.0
    for (_, imgs, _), out in zip(batches, outs):
        ref = infer(torch.from_numpy(imgs).to(dev), ops=PLAIN).float().cpu().numpy()
        worst = max(worst, float(np.abs(out - ref).max()))
        scale = max(scale, float(np.abs(ref).max()))
    bound = 3e-2 * max(1.0, scale)
    print(f"slice: kernel path vs plain path logits max|d| {worst:.3e} "
          f"(<= {bound:.3e}; max|ref| {scale:.3f})")
    require(worst <= bound, "slice logits disagree with the plain path")

    x = torch.from_numpy(batches[0][1]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: infer(x), 10)
    plain_ms = cuda_ms(lambda: infer(x, ops=PLAIN), 3, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"slice: batch {BATCH} forward {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s "
          f"(plain path {plain_ms:.2f} ms = {BATCH * 1000 / plain_ms:.1f} img/s); "
          f"peak device memory {peak_gb:.2f} GB")
    return launches


def main():
    if not os.path.isfile(os.path.join(ROOT, "nextgen_uia_tpu_torch", "__init__.py")):
        raise SystemExit("chip_smoke: the nextgen_uia_tpu_torch package is not beside "
                         "this script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    from nextgen_uia_tpu_torch.ops import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    path, seconds = build.build()
    build.library()
    print(f"build: {seconds:.1f} s nvcc -> {os.path.relpath(path, ROOT)}")
    log = (build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    results = kernel_phase(dev)
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches = slice_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    source = {"fused_block_infer": ("nextgen_uia_tpu_torch/csrc/fused_block.cu",
                                    "nextgen_uia_tpu/ops/fused_block.py:78"),
              "mona_spatial": ("nextgen_uia_tpu_torch/csrc/mona_spatial.cu",
                               "nextgen_uia_tpu/ops/dwconv.py:156")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in source.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
