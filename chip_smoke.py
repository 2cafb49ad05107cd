#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the toolchain.
2. Builds the port's CUDA kernels (nextgen_uia_tpu_torch/csrc, one nvcc
   per source, sm_90a, all started together).
3. Kernel phase: each kernel, forward and backward, against its plain
   PyTorch version on the card, at the main paths' shapes ([32, 197, 768],
   12 heads, hidden 3072; the MONA spatial op K2 and its backward K3 at
   [64, 14, 14, 64], [32, 14, 14, 64] and 70 rows (strips of rows a
   sample), their kernels alone at both path shapes, one device record a
   call and K3 bitwise equal over two calls; flash attention [24, 12,
   1370, 64] and the fused MLP [32880, 768] x 3072, DINOv2-B/14 at 518 px;
   the flash-attention backward at the LoRA fine-tune's [16, 197, 12, 64]
   and at [24, 12, 1370, 64]; the causal text block [256, 77, 512], 8
   heads; the lookup and histogram [24, 518, 518] (and timed at [32, 224,
   224]), and equalize, K13's one kernel a slot (in place, a cluster of
   CTAs an image), bitwise equal to its plain version at [24, 518, 518]
   over every image and over 3 (a constant image, one 70% one value), [3,
   37, 41], [3, 301, 303], [32, 224, 224] and [1, 1024, 1024], one device
   record a call, timed at cluster sizes 4, 8 and 16; BERT's post-norm
   kernels at the text cache's chunk [256, 256, 768], 12 heads, with a
   key-padding bias that leaves rows wholly padded; the whole MONA adapter,
   K12, forward and backward, and the attention block, K11, forward, dx
   backward and hybrid forward, at the bench step's [64, 197, 768] with a
   causal K11 case [16, 77, 512] (K11's bf16 backward bitwise equal over
   two calls; both cases timed, op and kernels alone, with no WMMA GEMM in
   a bf16 call); K10's backward at the BERT fine-tune's
   [16 * 256, 768] x 3072 (and [1001, 768]; bitwise equal over two calls)
   and K10's forward also at [16 * 256, 768] and [1001, 768], both and K9
   on the Hopper GEMM core in bf16 (kernels alone, no WMMA GEMM),
   K5 raw-x's backward at [16, 256, 768], K4
   forward and backward at [64, 14, 14, 64]; K6 and K8, on K7 and the
   Hopper GEMM core in bf16, also at the bench step's [64, 197, 768], K8
   with gelu and with quick_gelu, their bf16 backwards bitwise equal over
   two calls, timed op and kernels alone with no WMMA GEMM and no SIMT
   attention kernel in a bf16 call) and at one odd shape
   each (K7, on Hopper's wgmma and TMA, also at its tile edges N = 1, 63,
   64, 65, 127, 128, 129 in bf16 with q, k, v packed, a key bias and the
   causal mask, its saved lse against the plain log-sum-exp, dq, dk and dv
   bitwise equal over two calls, and timed, the op and its kernels alone
   with scaled_dot_product_attention's forward and backward beside them,
   at [24, 12, 1370, 64] and the path shapes [16, 197, 12, 64] with a key
   bias, [64, 12, 197, 64] and [16, 256, 12, 64] with a key bias;
   both K5 raw-x rows also at [7, 197, 768] and [1, 16, 768], the
   Hopper GEMM's ragged and sub-tile M; its backward bitwise equal over
   two calls; each beside the GEMM kernel's device time and the shared
   WMMA GEMM's time at the same product; K1 in its three layouts and K6
   post-LN, on K7 and the Hopper GEMM core in bf16 (K1 also at [4, 577,
   768], above the 256 tokens it once refused), with their kernels'
   device time alone and no WMMA GEMM and no SIMT attention kernel in a
   bf16 call, K1 beside torch.nn.TransformerEncoderLayer holding the same
   weights under inference_mode, and whether its fast path ran, K1 pre-norm
   also at the OpenAI layout ([32, 197, 768], quick_gelu, eps 1e-5); K5
   pre-norm, on the Hopper GEMM core in bf16, at [64, 197, 768], [32, 197,
   768], [3, 37, 768] and [1, 1, 768], its bf16 backward bitwise equal over
   two calls, timed op and kernels alone; K12 in each of its four variants,
   its bf16 products on wgmma, the hybrid one timed op and kernels alone;
   no bf16 call of K5 or K12 reaching the WMMA GEMM, colgemm_kernel or
   mona_down_kernel), with
   CUDA-event times and the bound from the card's peak rates (the CUDA
   cores' float32 rate for the depthwise stencils K2, K3 and K4):
   float32 max|d| <= 1e-4 * max|ref| for every output; bfloat16 against
   the float32 plain version on the bf16-rounded inputs max|d| <= 3e-2 *
   max(1, max|ref|) (3e-2 * max|ref| for the flash-attention output and
   gradients); the lookup and histogram exactly equal. K12 and K11 against
   their plain versions on the same inputs (float32 1e-4 * max|ref|, bf16
   3e-2 * max|ref|; K12's parameter gradients min(1e-4 * the largest
   max|ref|, 3e-2 * their own) in float32), K12's backward bitwise equal
   over two calls. The post-norm epilogues' backwards, plain
   recompositions with no kernel of their own, timed per layer. K6's
   causal mode, forward and backward, at the frozen CLIP text tower's [16,
   8, 64, 64] and [16, 8, 77, 64] (beside SDPA with is_causal and addmm),
   and K7's float32 path at the CLIPSeg decoder's [32, 197, 4, 16] packed
   views (beside SDPA in float32, bound at the CUDA cores' rate).
4. Augmentation phase: one strong+weak plan at [32, 224, 224] and at [24,
   518, 518] through the kernels and through the plain versions (images and
   masks equal; equalize launched once per slot that drew it, the lookup
   and histogram never; the plan's device records).
5. Serving phase: BiomedCLIP ViT-B/16 at 224 px with hybrid MONA in all 12
   blocks and a 2-class seg PyramidHead, seeded random weights written to
   .npz and loaded back through --backbone_ckpt/--mona_weights/--head_weights,
   served over 3 batches of 32 and a ragged batch of 5 seeded uint8 images
   by the same per-batch function the predict CLI runs. Checks finite
   outputs of the right shape, that each block kernel launched once per
   block and batch, and the logits against a plain-path run on the card;
   prints img/s at batch 32 and a profiler table of one batch.
6. Train phase: the BiomedCLIP seg step at batch 32 (launch counts, loss
   and gradient norm against the plain path, and in float32 the loss and each trainable
   tensor, the loss falling over 10 steps), timed with augmentation off and
   on.
7. DINOv2 phase: the seg step at ViT-B/14, 518 px, batch 24, UNet decoder,
   augmentation on, bf16 encoder, float32 head (launch counts, loss and
   head gradient norm against the plain path and, with a float32 encoder, the loss and each head
   gradient, BatchNorm statistics moving, the loss
   falling, times, peak memory, a profiler table, the eval forward's img/s).
8. Fine-tune phase: the OpenAI CLIP LoRA contrastive fine-tune at full
   width (ViT-B/16 with LoRA in 12 blocks, the 12-layer causal text tower,
   bf16, batch 64 in 4 microbatches): 512 captions tokenized and cached
   through the causal text blocks, one update's launch counts, loss and
   gradient norm against the plain path and, in float32, the loss and each
   LoRA/bias gradient, the loss falling over 10 updates, ms per update, a
   profiler table.
9. BiomedCLIP phase: the MONA contrastive fine-tune at full width (ViT-B/16
   with hybrid MONA in 12 blocks, the frozen 12-layer PubMedBERT at ctx
   256, bf16, batch 64 in 4 microbatches): 512 captions cached through
   BERT's three-kernel chain and through the whole-layer kernel (opted in),
   a full-context chunk timed, one update with cached and one with in-step
   text (launch counts, text features, loss and gradient norm against the
   plain path; in float32 the loss and every MONA gradient), the loss
   falling over 10 updates, ms per update, a profiler table. Then
   ``--tune_text_encoder`` with both towers cut to 6 blocks and layers
   (full width), LoRA (r=16, alpha 32, dropout 0.1) in all 6 of both, and
   in the first 3: one update with the text in the step (seeded ids with a
   padded tail, a 256-token bucket): launch counts derived from the code
   (K10's backward 24 and 12, K5 raw-x's backward 0 and 12), loss and
   gradient norm against the
   plain path, in float32 the loss and every LoRA and bias gradient, the
   loss falling over 10 updates, ms per update, a profiler table.
   Zero-shot phase: BiomedCLIP (the 12-layer PubMedBERT at ctx 256) and
   the OpenAI layout (quick_gelu, ln_pre, the 12-layer causal text tower at
   ctx 77, width 512) at full width with their CLIs' default MONA in all 12
   blocks: the BUSI ensemble's 2 x 10 prompts (12 text launches a class),
   4 batches of 32 seeded uint8 images (K1 and K2 12 a batch), text
   features, logits and image features against the plain path in bf16
   (3e-2 * max|ref|) and float32 (1e-4 * max|ref|), img/s at batch 32, a
   profiler table; retrieval on 256 synthetic pairs at batch 128 (features
   held alike, the float32 recalls equal).
10. Bench phase: the port's headline step (nextgen_uia_tpu_torch/bench.py,
   the JAX bench.py's step: BiomedCLIP ViT-B/16 with hybrid MONA in 12
   blocks, cached text, batch 64 as one microbatch, bf16) by the composed
   route, the fused MONA route (K12), and with it the fused (K11) and the
   hybrid attention block: launch counts, ms and img/s, the device's busy
   share, peak memory, no WMMA GEMM, colgemm_kernel or mona_down_kernel in
   the profile; in float32 the fused route on the kernels against
   the composed plain path (loss, every MONA tensor); bench.main's JSON.
   Bench modes phase: bench.main() under NEXTGEN_UIA_BENCH_SUPERVISED,
   _EVAL and _INPUT at full width and depth (10-step windows; 1024 PNGs, 2
   epochs; the supervised mode with augmentation on and off): each JSON
   line's keys, the whole run's launches against one
   step's times the steps, img/s, ms a step, peak memory, the input mode's
   host-only rate and decoder; one augmented supervised step's launches
   (equalize once a slot that drew it) and a float32 step with
   augmentation off on the kernels against the plain path (loss and the
   head and MONA gradients; the plain path launches nothing).
11. Convert phase: full-size seeded state dicts under the reference
   checkpoints' key names (open_clip's BiomedCLIP in float32, OpenAI's
   ViT-B/16 CLIP in float16), each torch.save'd, converted by ``python -m
   nextgen_uia_tpu_torch.convert`` in a process of its own, and loaded
   into the port's CLIP with every tensor filled.
12. Full phase: ``--method full`` from the converted weights (ViT-B/16,
   both towers cut to 6 blocks and layers since the baselines came,
   bf16, batch 64 as 4 x 16, AdamW at the clamped 1e-6): BiomedCLIP with
   its captions cached through PubMedBERT's mlp_impl='xla' layers (K7
   forward with the padding bias), two updates against the plain path (K7
   forward and backward 48 each, no other kernel), then with
   --tune_text_encoder (BERT trained: K7 96 each), the OpenAI layout with
   --tune_text_encoder (the causal text tower trained: K7 96 each), each
   timed with a profiler table; then --method mona --tune_text_encoder on
   the OpenAI layout (the frozen text tower's LN route in the step: K5, K6
   causal and K10's forward 48 each, no K7 of its own, no text backward)
   against the plain path, and that tower alone at the 64-token bucket.
   CLIPSeg phase: the frozen OpenAI towers through K1 and K1 causal and
   the FiLM decoder (K7 float32 at head dim 16) at batch 32, 224 px: three
   updates and a serving batch against the plain path, launches, img/s,
   profiler tables. Supervised LoRA phase: the BiomedCLIP seg trainer's
   model from --lora_weights (r 16 in 12 blocks): two updates against the
   plain path (K7 and K8 forward 12 each, backward 10), then an eval batch
   by the composed route (no K1). Baselines phase: ResNet-18, ResNet-50
   (cls, 3 channels) and the UNet (seg, 1 channel, init_channels 16) at
   their CLIs' defaults (float32, batch 32, 224 px, augmentation on): 2
   updates through the kernels and on the plain path (equalize_plain)
   under one generator (losses, every gradient, the BatchNorm statistics;
   equalize launched and recorded once per slot that drew it), the update
   and eval batch timed with TF32 off and on (busy share, peak memory);
   CLIP's ModifiedResNet RN50 at [32, 224, 224, 3] against the CPU.
13. CLI phase: the BiomedCLIP and DINOv2 seg trainers at their default
   augmentation, the predict CLIs on their best_model.npz, both cls
   trainers, the OpenAI LoRA fine-tune CLI, the BiomedCLIP MONA fine-tune
   CLI, the BiomedCLIP LoRA fine-tune CLI with --tune_text_encoder
   --lora_layers 6 and the BiomedCLIP fine-tune CLI at its default
   --method full from the converted checkpoint (whole-model
   best_model.npz; one epoch each); then the CLIP families' CLIs at full
   width: clip.classification (the hidden cls head in best_model.npz),
   metaclip.segmentation, the unimedclip, biomedclip and clip zero-shot
   CLIs, biomedclip.retrieval and clip.predict at its default task,
   zero-shot, each with its launch counts; then clipseg.segmentation, the
   clipseg predict CLI on its best_model.npz, biomedclip.fewshot_segmentation
   and biomedclip.predict with --lora_weights; then the baselines CLIs:
   segmentation and predict --task seg on its best_model.npz,
   classification from a seeded torchvision resnet18 converted by
   ``python -m nextgen_uia_tpu_torch.convert resnet18`` and predict --task
   cls, and both few-shot trainers. Export phase: BiomedCLIP cls with
   hybrid MONA, DINOv2 seg at 518 px, CLIPSeg and the UNet (BatchNorm
   statistics as arguments) exported at batch 16 through the predict
   CLI's `build_served` and export (the kernels as nextgen_uia:: ops), loaded back:
   exactly the expected ops, no weight in the program (under 1% of the
   weights' bytes but for the UNet), outputs against the live forward and
   the plain route, export seconds and the exported call against the live
   one; the first loaded in a fresh process with only the documented
   import. Distributed phase: the sharded train step under NCCL at world
   1 (one card) on the supervised BiomedCLIP step against the plain
   TrainStep (loss, gradient norm, gradients against the plain step's own
   repeat, updated adapters, launches, both timed in turns).
14. Prints each phase's host seconds, one JSON line of per-kernel results
   (41 rows: K7 also at the full route's shapes and in float32 at head dim
   16, K10 at the frozen text tower's shape, K6 causal forward and
   backward), then the final status line.

Exits non-zero without a CUDA device or without the repository beside it,
and refuses NEXTGEN_UIA_FUSED_MONA or NEXTGEN_UIA_FUSED_BLOCK_BERT set by the
caller (each phase selects its routes itself).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEG_CLASSES, IMG, BATCH, RAGGED, N_BATCHES = 2, 224, 32, 5, 4
DINO_IMG, DINO_BATCH, DINO_TOKENS = 518, 24, 37 * 37 + 1
FT_BATCH, FT_ACCUM, FT_MICRO = 64, 4, 16     # the fine-tune's batch, accumulation, microbatch
TEXT_CHUNK, N_CAPTIONS = 256, 512            # the text cache's chunk, captions cached
TEXT_LORA_DEPTH = 6                          # blocks and layers of the text LoRA phases
FULL_DEPTH = 6                               # blocks and layers of the --method full phase


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


@contextlib.contextmanager
def environ(**values):
    """The environment variables ``values`` set for the block, then put back
    as they were."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM: dense bf16, HBM3 (data sheet)
CUDA_CORE_FLOPS = 67e12  # float32 outside the tensor cores: the stencils K2, K3, K4
BF16_BOUND, F32_BOUND = 3e-2, 1e-4


def bound(flops, nbytes, peak=PEAK_FLOPS):
    """(bound_ms, bound_by): the larger of flops at ``peak`` (the bf16
    tensor-core peak, or CUDA_CORE_FLOPS for a depthwise stencil, which has
    no matrix product) and bytes at the memory rate."""
    t_ops, t_mem = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def errors(got, ref):
    """[(max|d|, max|ref|)] for each output of a tensor or a tuple."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    require(len(got) == len(ref), "output counts differ")
    return [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
            for g, r in zip(got, ref)]


def kernel_phase(dev):
    """Every kernel (forward and backward) against its plain version on the
    card: float32 at the main path's shape and at an odd one (max|d| <= 1e-4
    max|ref|), bfloat16 against the float32 plain version on the
    bf16-rounded inputs (max|d| <= 3e-2 max(1, max|ref|), or 3e-2 max|ref|
    for attention, whose outputs lie far below 1); CUDA-event times
    of kernel, plain version and (where one exists) the one PyTorch call
    computing the same function, at the main path's shape in bfloat16."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.models.text_clip import TextConfig
    from nextgen_uia_tpu_torch.models.vit import VIT_B16_OPENAI, VIT_B16_TIMM, Block, ViTConfig
    from nextgen_uia_tpu_torch.ops import dwconv, fused_attn_o, fused_block, fused_ln_mlp
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv
    from nextgen_uia_tpu_torch.tools.compare_trees import encoder_layer

    gen = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    results = {}

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def block(width, heads):
        blk = Block(gen, ViTConfig(width=width, heads=heads))
        with torch.no_grad():
            for ln in (blk.ln1, blk.ln2):
                ln.scale.add_(0.1 * torch.randn(width, generator=gen))
                ln.bias.add_(0.1 * torch.randn(width, generator=gen))
        return blk.to(dev)

    def rounded(t):
        return t.to(bf16).float() if t.is_floating_point() else t

    def check(name, kern, plain, inputs, odd_inputs, cost, library=None, scaled=False,
              more=(), kernels=False):
        """kern/plain(*inputs) -> tensor or tuple; inputs float32 on the
        card (the first `main` shape, then the odd one, then any in
        ``more``, each held in float32 and in bf16). ``scaled`` holds
        bf16 to 3e-2 max|ref| instead of 3e-2 max(1, max|ref|).
        ``kernels``: also the bf16 call's kernels alone, none of them a
        WMMA GEMM or the SIMT attention (``hopper_kernels_ms``)."""
        def unit(scale):
            return scale if scaled else max(1.0, scale)

        def bf16_errors(args):
            args_b = [t.to(bf16) if t.is_floating_point() else t for t in args]
            return errors(kern(*args_b), plain(*[rounded(t) for t in args]))

        with torch.no_grad():
            rels = [max(d / scale for d, scale in errors(kern(*args), plain(*args)))
                    for args in (inputs, odd_inputs, *more)]
            args_b = [t.to(bf16) if t.is_floating_point() else t for t in inputs]
            errs_b = bf16_errors(inputs)
            more_b = [e for args in more for e in bf16_errors(args)]
            torch.cuda.synchronize()
            # each output against its own scale; report the worst ratio's pair
            err_b, scale_b = max(errs_b, key=lambda e: e[0] / unit(e[1]))
            lim_b = BF16_BOUND * unit(scale_b)
            ms = cuda_ms(lambda: kern(*args_b), 20)
            plain_ms = cuda_ms(lambda: plain(*args_b), 5, warmup=1)
            lib_ms = cuda_ms(lambda: library(*args_b), 20) if library else None
            if kernels:
                k_ms, seen, wmma = hopper_kernels_ms(name, lambda: kern(*args_b))
                print(f"{name}: bf16 kernels alone {k_ms:.4f} ms of device time ({wmma})")
                for key, ms_ in sorted(seen.items(), key=lambda kv: -kv[1])[:10]:
                    print(f"{name}:   {ms_:.4f} ms {key[:100]}")
        b_ms, b_by = bound(*cost)
        print(f"{name}: f32 rel max|d| {rels[0]:.3e} (odd shape {rels[1]:.3e}; <= 1e-4); "
              f"bf16 max|d| {err_b:.3e} (<= {lim_b:.3e}, max|ref| {scale_b:.3e}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by})")
        if more:
            worst = max(e / unit(sc) for e, sc in more_b)
            print(f"{name}: {len(more)} more shapes, f32 rel max|d| {max(rels[2:]):.3e}, bf16 "
                  f"max|d| / max(1, max|ref|) {worst:.3e} (<= {BF16_BOUND:.0e})")
            require(worst <= BF16_BOUND, f"{name} bfloat16 mismatch at a further shape")
        require(max(rels) <= F32_BOUND, f"{name} float32 mismatch")
        require(err_b <= lim_b, f"{name} bfloat16 mismatch")
        results[name] = dict(max_abs_err=err_b, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)

    cfg = VIT_B16_TIMM
    b, n, d, h, hid = BATCH, cfg.seq_len, cfg.width, cfg.heads, 4 * cfg.width
    m, dh = b * n, d // h
    blk, small = block(d, h), block(128, 2)
    # odd shape: 50 tokens (not a multiple of 16), 2 heads of 64, quick_gelu
    ob, on, oh = 3, 50, 2

    # K1: the whole block, forward (serving path), beside the library's
    # TransformerEncoderLayer holding the same weights
    kw = dict(heads=h, act=cfg.act, eps=cfg.ln_eps)
    okw = dict(heads=oh, act="quick_gelu", key_bias=randn(ob, on), n_real=41)
    enc = encoder_layer(blk, "prenorm", h, cfg.act, cfg.ln_eps)
    check("fused_block_infer",
          lambda x, p=None: fused_block.fused_block_infer(x, p or blk, **(okw if p else kw)),
          lambda x, p=None: fused_block.fused_block_infer_plain(x, p or blk,
                                                                **(okw if p else kw)),
          [randn(b, n, d)], [randn(ob, on, 128), small],
          (2 * m * 12 * d * d + 4 * b * h * n * n * dh, 2 * (2 * m * d + 12 * d * d)),
          library=inference(enc), kernels=True)
    encoder_fast_path("fused_block_infer", inference(enc), randn(b, n, d).to(bf16))
    # K1 above 256 tokens (ViT-B/16 at 384 px: 577), which K7 takes
    x577 = randn(4, 577, d)
    with torch.no_grad():
        for dt, lim in ((f32, F32_BOUND), (bf16, BF16_BOUND)):
            got = fused_block.fused_block_infer(x577.to(dt), blk, **kw)
            want = fused_block.fused_block_infer_plain(rounded(x577) if dt == bf16 else x577,
                                                       blk, **kw)
            torch.cuda.synchronize()
            (err, scale), = errors(got, want)
            limit = lim * (max(1.0, scale) if dt == bf16 else scale)
            print(f"fused_block_infer: {dt} [4, 577, {d}] max|d| {err:.3e} (<= {limit:.3e}, "
                  f"max|ref| {scale:.3e})")
            require(err <= limit, f"fused_block_infer {dt} mismatch at 577 tokens")

    # K1 at the OpenAI layout (quick_gelu, eps 1e-5): every image forward of the
    # openai, metaclip and unimedclip families (zero-shot, retrieval, predict, eval)
    ocfg = VIT_B16_OPENAI
    qkw = dict(heads=ocfg.heads, act=ocfg.act, eps=ocfg.ln_eps)
    check("fused_block_infer_quick_gelu",
          lambda x, p=None: fused_block.fused_block_infer(x, p or blk, **(okw if p else qkw)),
          lambda x, p=None: fused_block.fused_block_infer_plain(x, p or blk,
                                                                **(okw if p else qkw)),
          [randn(b, ocfg.seq_len, ocfg.width)], [randn(ob, on, 128), small],
          (2 * m * 12 * d * d + 4 * b * h * n * n * dh, 2 * (2 * m * d + 12 * d * d)),
          library=inference(encoder_layer(blk, "prenorm", h, ocfg.act, ocfg.ln_eps)),
          kernels=True)

    # K5: LN + q/k/v, forward and backward
    def qkv_fwd(x, p=None):
        return fused_ln_qkv.fused_ln_qkv(x, (p or blk).ln1, (p or blk).attn,
                                         heads=oh if p else h, eps=cfg.ln_eps)

    def qkv_fwd_plain(x, p=None):
        return fused_ln_qkv.fused_ln_qkv_plain(x, (p or blk).ln1, (p or blk).attn,
                                               heads=oh if p else h, eps=cfg.ln_eps)

    check("fused_ln_qkv", qkv_fwd, qkv_fwd_plain, [randn(b, n, d)], [randn(ob, on, 128), small],
          (2 * m * d * 3 * d, 2 * (4 * m * d + 3 * d * d)))

    def qkv_bwd_args(p, bb, nn_, hh, dd):
        gamma, _, w, _ = fused_ln_qkv._weights(p.ln1, p.attn, f32)
        return [randn(bb, nn_, dd), gamma, w] + [randn(bb, hh, nn_, dd // hh)
                                                 for _ in range(3)]

    check("fused_ln_qkv_backward",
          lambda x, g_, w, *dy: fused_ln_qkv.fused_ln_qkv_backward(
              x, g_.float(), w.to(x.dtype), *dy, eps=cfg.ln_eps),
          lambda x, g_, w, *dy: fused_ln_qkv.fused_ln_qkv_backward_plain(
              x, g_, w, *dy, eps=cfg.ln_eps),
          qkv_bwd_args(blk, b, n, h, d), qkv_bwd_args(small, ob, on, oh, 128),
          (2 * m * d * 3 * d, 2 * (5 * m * d + 3 * d * d)))

    # K6: attention + o-projection + residual, forward and backward
    akw = dict(bias=randn(ob, on), n_real=41)

    def attn_fwd(q, k, v, x, p=None):
        return fused_attn_o.fused_attn_o_residual(q, k, v, x, (p or blk).attn.o,
                                                  heads=q.shape[1], **(akw if p else {}))

    def attn_fwd_plain(q, k, v, x, p=None):
        return fused_attn_o.fused_attn_o_residual_plain(q, k, v, x, (p or blk).attn.o,
                                                        heads=q.shape[1],
                                                        **(akw if p else {}))

    def attn_args(bb, nn_, hh, dd, *extra):
        return [randn(bb, hh, nn_, dd // hh) for _ in range(3)] + [randn(bb, nn_, dd), *extra]

    costs = k6_k8_costs(b, n, d, h, hid)
    check("fused_attn_o_residual", attn_fwd, attn_fwd_plain, attn_args(b, n, h, d),
          attn_args(ob, on, oh, 128, small), costs["fused_attn_o_residual"])

    def attn_bwd(q, k, v, g, w, *odd):
        return fused_attn_o.fused_attn_o_residual_backward(q, k, v, w.to(q.dtype), g,
                                                           **(akw if odd else {}))

    def attn_bwd_plain(q, k, v, g, w, *odd):
        return fused_attn_o.fused_attn_o_residual_backward_plain(q, k, v, w, g,
                                                                 **(akw if odd else {}))

    check("fused_attn_o_residual_backward", attn_bwd, attn_bwd_plain,
          attn_args(b, n, h, d, blk.attn.o.w), attn_args(ob, on, oh, 128, small.attn.o.w, 1),
          costs["fused_attn_o_residual_backward"])

    # K8: LN + MLP + residual, forward and backward
    def mlp_fwd(x, p=None):
        return fused_ln_mlp.fused_ln_mlp_residual(x, (p or blk).ln2, (p or blk).mlp,
                                                  act="quick_gelu" if p else cfg.act,
                                                  eps=cfg.ln_eps)

    def mlp_fwd_plain(x, p=None):
        return fused_ln_mlp.fused_ln_mlp_residual_plain(x, (p or blk).ln2, (p or blk).mlp,
                                                        act="quick_gelu" if p else cfg.act,
                                                        eps=cfg.ln_eps)

    check("fused_ln_mlp_residual", mlp_fwd, mlp_fwd_plain, [randn(b, n, d)],
          [randn(ob, on, 128), small], costs["fused_ln_mlp_residual"])

    def mlp_bwd_args(p, bb, nn_, dd):
        ws = fused_ln_mlp._weights(p.ln2, p.mlp, f32)[:5]
        return [randn(bb, nn_, dd), *ws, randn(bb, nn_, dd)]

    def mlp_bwd(x, gamma, beta, w1, b1, w2, g, odd=False):
        return fused_ln_mlp.fused_ln_mlp_residual_backward(
            x, gamma.float(), beta.float(), w1.to(x.dtype), b1.float(), w2.to(x.dtype), g,
            act="quick_gelu" if odd else cfg.act, eps=cfg.ln_eps)

    def mlp_bwd_plain(x, gamma, beta, w1, b1, w2, g, odd=False):
        return fused_ln_mlp.fused_ln_mlp_residual_backward_plain(
            x, gamma, beta, w1, b1, w2, g, act="quick_gelu" if odd else cfg.act,
            eps=cfg.ln_eps)

    check("fused_ln_mlp_residual_backward", mlp_bwd, mlp_bwd_plain,
          mlp_bwd_args(blk, b, n, d), mlp_bwd_args(small, ob, on, 128) + [True],
          costs["fused_ln_mlp_residual_backward"])

    # K2/K3: the MONA spatial op, forward and backward, at the bench step's
    # [64, 14, 14, 64], the supervised step's [32, 14, 14, 64], 70 rows (strips
    # of rows a sample) and an odd [3, 9, 11, 24]
    def mona_args(bb, hh, ww, c, last):
        return [randn(bb, hh, ww, c), 1 + randn(c, scale=0.3), randn(bb, 7, 7, c, scale=0.2),
                randn(*last(bb, hh, ww, c))]

    def with_bias(bb, hh, ww, c):
        return bb, c

    g2, sb = cfg.grid, FT_BATCH
    px = sb * g2 * g2 * 64
    check("mona_spatial", dwconv.mona_spatial, dwconv.mona_spatial_plain,
          mona_args(sb, g2, g2, 64, with_bias), mona_args(3, 9, 11, 24, with_bias),
          (2 * 49 * px, 2 * (2 * px + sb * 50 * 64 + 64), CUDA_CORE_FLOPS),
          library=lambda s, f, k, _: F.conv2d(
              s.permute(3, 0, 1, 2).reshape(1, -1, g2, g2),
              k.permute(3, 0, 1, 2).reshape(-1, 1, 7, 7), padding=3, groups=s.shape[0] * 64),
          more=(mona_args(b, g2, g2, 64, with_bias), mona_args(2, 70, 5, 16, with_bias)))
    check("mona_spatial_backward", dwconv.mona_spatial_backward,
          dwconv.mona_spatial_backward_plain,
          mona_args(sb, g2, g2, 64, lambda *sh: sh), mona_args(3, 9, 11, 24, lambda *sh: sh),
          (4 * 49 * px, 2 * (3 * px + 2 * sb * 49 * 64 + 2 * 64) + 4 * sb * 64, CUDA_CORE_FLOPS),
          more=(mona_args(b, g2, g2, 64, lambda *sh: sh),
                mona_args(2, 70, 5, 16, lambda *sh: sh)))
    spatial_checks(dwconv, mona_args, with_bias, g2)

    # K7: flash attention forward at DINOv2-B/14's 518 px shape, and an odd
    # float32 shape with a key bias and the causal mask. Unit-variance q, k
    # and v spread each softmax row over ~500 keys, so outputs are ~0.04 and
    # bf16 is held to 3e-2 max|ref| (a limit of 3e-2 would pass a kernel
    # that dropped a key tile)
    from nextgen_uia_tpu_torch.ops import flash_attention as fa
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm
    from nextgen_uia_tpu_torch.ops import lut

    db, dn = DINO_BATCH, DINO_TOKENS
    fkw = dict(bias=randn(2, 77), causal=True)
    check("flash_attention",
          lambda q, k, v, odd=False: fa.flash_attention(q, k, v, layout="bhnd",
                                                        **(fkw if odd else {})),
          lambda q, k, v, odd=False: fa.flash_attention_plain(q, k, v, layout="bhnd",
                                                              **(fkw if odd else {})),
          [randn(db, h, dn, dh) for _ in range(3)],
          [randn(2, 3, 77, 64) for _ in range(3)] + [True],
          (4 * db * h * dn * dn * dh, 2 * 4 * db * h * dn * dh),
          library=lambda q, k, v: F.scaled_dot_product_attention(q, k, v), scaled=True)

    # the bf16 tensor-core kernel with a key bias and the causal mask at a
    # ragged N, reading q, k, v as views of one packed [B, N, 3, H, 64]
    # projection, as mha's N > 512 route hands them over
    qkv, kbias = randn(2, 333, 3, h, dh), randn(2, 333)
    with torch.no_grad():
        got = fa.flash_attention(*qkv.to(bf16).unbind(2), bias=kbias, causal=True)
        want = fa.flash_attention_plain(*rounded(qkv).unbind(2), bias=kbias, causal=True)
        torch.cuda.synchronize()
    (err, scale), = errors(got, want)
    print(f"flash_attention: bf16 packed [2, 333, 3, {h}, {dh}] with key bias and causal: "
          f"max|d| {err:.3e} (<= {BF16_BOUND * scale:.3e}, max|ref| {scale:.3e})")
    require(err <= BF16_BOUND * scale, "flash_attention bfloat16 with bias and causal mismatch")

    # K7 backward: the LoRA fine-tune's shape [16, 197, 12, 64] (bnhd, as
    # mha's LoRA route hands it over) with a key bias, float32 and bf16; odd
    # cases: float32 causal N = 77 with the bias's gradient, bf16 causal N =
    # 333 with a bias; and DINOv2's long N [24, 12, 1370, 64]. Every gradient
    # against flash_attention_backward_plain on the same (bf16-rounded)
    # inputs: float32 1e-4 * max|ref|, bf16 3e-2 * max|ref| (outputs ~0.1)
    fb_n, fb_b = VIT_B16_OPENAI.seq_len, FT_MICRO

    def k7_bwd_case(shape, layout, causal, bias, bias_grad, dtype):
        bb, nn_ = shape[0], shape[1] if layout == "bnhd" else shape[2]
        q, k, v, g = (randn(*shape) for _ in range(4))
        if dtype == bf16:
            q, k, v, g = (rounded(t) for t in (q, k, v, g))
        kb = randn(bb, nn_) if bias else None
        args = [t.to(dtype) for t in (q, k, v)]
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(*args, bias=kb, causal=causal, layout=layout)
            got = fa.flash_attention_backward(*args, out, g.to(dtype), lse, bias=kb,
                                              causal=causal, layout=layout, bias_grad=bias_grad)
            want = fa.flash_attention_backward_plain(q, k, v, kb, g, causal=causal, layout=layout)
            torch.cuda.synchronize()
        n_out = 4 if bias_grad else 3
        errs = errors(tuple(got[:n_out]), tuple(want[:n_out]))
        lim = F32_BOUND if dtype == f32 else BF16_BOUND
        ratio = max(d / (lim * s) for d, s in errs)
        require(ratio <= 1.0, f"flash_attention_backward {dtype} {shape} {layout} causal={causal} "
                              f"bias={bias}: max|d| / limit = {ratio:.3f}")
        return ratio, errs, (args, out, lse, g.to(dtype), kb)

    cases = [((fb_b, fb_n, h, dh), "bnhd", False, True, False, bf16),
             ((fb_b, fb_n, h, dh), "bnhd", False, True, True, f32),
             ((2, 3, 77, 64), "bhnd", True, True, True, f32),
             ((2, 333, h, dh), "bnhd", True, True, False, bf16),
             ((db, h, dn, dh), "bhnd", False, False, False, bf16)]
    outs = [k7_bwd_case(*c) for c in cases]
    for c, (ratio, errs, _) in zip(cases, outs):
        print(f"flash_attention_backward: {c[5]} {list(c[0])} {c[1]} causal={c[2]} bias={c[3]} "
              f"bias_grad={c[4]}: max|d| / limit {ratio:.3e} (dq, dk, dv"
              f"{', dbias' if c[4] else ''} max|d| "
              + ", ".join(f"{d:.2e}" for d, _ in errs) + ")")

    def sdpa_backward(args, g, kb, layout):
        """scaled_dot_product_attention's backward through autograd on the
        same inputs, [B, H, N, dh] views, the bias as a float mask."""
        def bhnd(t):
            return t.transpose(1, 2) if layout == "bnhd" else t
        qs = [bhnd(t).detach().requires_grad_() for t in args]
        gs = bhnd(g)
        mask = None if kb is None else kb[:, None, None, :].to(qs[0].dtype)
        o = F.scaled_dot_product_attention(*qs, attn_mask=mask)
        return lambda: torch.autograd.grad(o, qs, gs, retain_graph=True)

    def k7_bwd_cost(bb, nn_):
        return (10 * bb * h * nn_ * nn_ * dh,
                8 * bb * h * nn_ * dh * 2 + 4 * bb * h * nn_ + 4 * bb * nn_)

    (args, out, lse, gb, kb) = outs[0][2]
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: fa.flash_attention_backward_plain(*args, kb, gb,
                                                                     layout="bnhd"), 5, warmup=1)
    # dq, dk and dv bitwise equal over two calls (no atomics on them)
    for i in (0, 3, 4):
        (args, out, lse, gb, kb) = outs[i][2]
        with torch.no_grad():
            first, second = (fa.flash_attention_backward(*args, out, gb, lse, bias=kb,
                                                         causal=cases[i][2], layout=cases[i][1])
                             for _ in range(2))
        require(all(torch.equal(a, c) for a, c in zip(first[:3], second[:3])),
                f"flash_attention_backward {list(cases[i][0])} not bitwise equal over two calls")
    print("flash_attention_backward: dq, dk, dv bitwise equal over two calls at "
          + ", ".join(str(list(cases[i][0])) for i in (0, 3, 4)))
    k7_edges(fa, randn, rounded)
    k7_times = k7_timings(fa, randn, sdpa_backward, k7_bwd_cost)
    op_b, _, lib_b, b_ms, b_by = k7_times[(fb_b, h, fb_n)][1]
    results["flash_attention_backward"] = dict(
        max_abs_err=max(d for d, _ in outs[0][1]), ms=op_b, plain_ms=plain_ms, library_ms=lib_b,
        bound_ms=b_ms, bound_by=b_by)

    # K1 with the causal mask: the CLIP text block (width 512, 8 heads,
    # hidden 2048, quick_gelu) at the text cache's chunk [256, 77, 512], and
    # an odd [3, 50, 128] with 2 heads and a key bias
    tcfg = TextConfig()
    tb, tn, td, th = TEXT_CHUNK, tcfg.context_length, tcfg.width, tcfg.heads
    tblk, tdh, tm = block(td, th), td // th, TEXT_CHUNK * tcfg.context_length
    ckw = dict(heads=th, act=tcfg.act, eps=tcfg.ln_eps, causal=True)
    cokw = dict(heads=oh, act="quick_gelu", causal=True, key_bias=randn(ob, on))
    tenc = encoder_layer(tblk, "prenorm", th, tcfg.act, tcfg.ln_eps)
    causal_mask = torch.nn.Transformer.generate_square_subsequent_mask(tn, device=dev,
                                                                       dtype=bf16)
    causal_lib = inference(lambda x: tenc(x, src_mask=causal_mask, is_causal=True))
    check("fused_block_infer_causal",
          lambda x, p=None: fused_block.fused_block_infer(x, p or tblk, **(cokw if p else ckw)),
          lambda x, p=None: fused_block.fused_block_infer_plain(x, p or tblk,
                                                                **(cokw if p else ckw)),
          [randn(tb, tn, td)], [randn(ob, on, 128), small],
          (2 * tm * 12 * td * td + 4 * tb * th * tdh * tn * (tn + 1) // 2,
           2 * (2 * tm * td + 12 * td * td)), library=causal_lib, kernels=True)
    encoder_fast_path("fused_block_infer_causal", causal_lib, randn(tb, tn, td).to(bf16))

    # K10: the fused MLP forward, [24 * 1370, 768] x 3072 gelu (the last
    # 128-row tile ragged), an odd float32 [77, 128] x 512 quick_gelu, and
    # further at the BERT LoRA layers' [16 * 256, 768] and an odd row count
    # [1001, 768]; its kernels alone (Hopper core, no WMMA GEMM)
    dm = db * dn

    def mlp_only(fn):
        def run(x, odd=False):
            mod = (small if odd else blk).mlp
            return fn(x, mod.fc1.w, mod.fc1.b, mod.fc2.w, mod.fc2.b,
                      act="quick_gelu" if odd else cfg.act)
        return run

    check("fused_mlp", mlp_only(fm.fused_mlp), mlp_only(fm.fused_mlp_plain), [randn(dm, d)],
          [randn(77, 128), True], (4 * dm * d * hid, 2 * (2 * dm * d + 2 * d * hid)),
          more=[[randn(FT_MICRO * 256, d)], [randn(1001, d)]], kernels=True)
    # ... and at the frozen CLIP text tower in the step (--tune_text_encoder
    # under mona): [16 * L, 512] x 2048 quick_gelu, L the in-step text's
    # trimmed length
    tl = full_step_tokens()[1].shape[1]
    tfm = FT_MICRO * tl

    def text_mlp(fn):
        def run(x, odd=False):
            mod = (small if odd else tblk).mlp
            return fn(x, mod.fc1.w, mod.fc1.b, mod.fc2.w, mod.fc2.b, act="quick_gelu")
        return run

    check("fused_mlp_text", text_mlp(fm.fused_mlp), text_mlp(fm.fused_mlp_plain),
          [randn(tfm, td)], [randn(77, 128), True],
          (4 * tfm * td * 4 * td, 2 * (2 * tfm * td + 2 * td * 4 * td)), kernels=True)

    # K13: the table lookup and the histogram, exactly equal to their plain
    # versions at [24, 518, 518] and an odd [3, 37, 41]; ``library`` times the
    # one PyTorch call of the same function on the byte indices (x + 256 *
    # image, int64, made before the timing)
    def exact(name, kern, plain, inputs, odd_inputs, nbytes, kernel_name, library):
        with torch.no_grad():
            for args in (inputs, odd_inputs):
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"{name} differs from its plain version")
            ms = cuda_ms(lambda: kern(*inputs), 20)
            k_ms = kernel_device_ms(lambda: kern(*inputs), kernel_name)
            plain_ms = cuda_ms(lambda: plain(*inputs), 5, warmup=1)
            lib_ms = cuda_ms(library, 20)
        b_ms, b_by = bound(0, nbytes)
        print(f"{name}: equal to the plain version (main and odd shape); kernel {ms:.4f} ms "
              f"(alone {k_ms:.4f} ms, profiler), plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)

    def images(shape):
        x = torch.rand(shape, generator=gen).to(dev)
        return torch.round(x * 255) / 255  # on the byte grid, as augmentation keeps them

    big, odd = images((db, DINO_IMG, DINO_IMG)), images((3, 37, 41))
    hw = DINO_IMG * DINO_IMG
    flat = (lut.to_bytes(big).reshape(db, hw)
            + 256 * torch.arange(db, device=dev)[:, None]).reshape(-1)
    with torch.no_grad():
        require(torch.equal(torch.bincount(flat, minlength=256 * db).reshape(db, 256).int(),
                            lut.hist256_plain(big)), "bincount is not hist256's function")
    exact("hist256", lut.hist256, lut.hist256_plain, [big], [odd], db * hw * 4 + db * 256 * 4,
          "equalize_kernel", lambda: torch.bincount(flat, minlength=256 * db))
    tables = [torch.randint(0, 256, (n, 256), generator=gen, dtype=torch.int32).to(dev)
              for n in (db, 3)]
    with torch.no_grad():
        require(torch.equal(tables[0].reshape(-1)[flat].reshape(big.shape).float(),
                            lut.lut_apply_plain(big, tables[0])),
                "the flat lookup is not lut_apply's function")
    exact("lut_apply", lut.lut_apply, lut.lut_apply_plain, [big, tables[0]], [odd, tables[1]],
          2 * db * hw * 4 + db * 256 * 4, "lut_apply_kernel",
          lambda: tables[0].reshape(-1)[flat])
    small_imgs = images((BATCH, IMG, IMG))
    small_table = tables[0][:1].expand(BATCH, 256)
    with torch.no_grad():
        hist_ms = cuda_ms(lambda: lut.hist256(small_imgs), 20)
        apply_ms = cuda_ms(lambda: lut.lut_apply(small_imgs, small_table), 20)
    print(f"hist256 [{BATCH}, {IMG}, {IMG}]: kernel {hist_ms:.4f} ms, bound "
          f"{bound(0, small_imgs.numel() * 4 + BATCH * 1024)[0]:.4f} ms; lut_apply: kernel "
          f"{apply_ms:.4f} ms, bound {bound(0, 2 * small_imgs.numel() * 4 + BATCH * 1024)[0]:.4f}"
          f" ms")
    results["equalize"] = equalize_rows(dev, gen, images)
    bert_kernel_rows(dev, gen, check)
    text_lora_kernel_rows(dev, gen, check)
    fused_kernel_rows(dev, gen, results)
    k6_k8_rows(dev, block(d, h))
    k5_rows(dev, block(d, h))
    results.update(full_path_k7_rows(dev))
    results.update(k6_causal_rows(dev))
    results.update(k7_f32_dh16_rows(dev))
    return results


def equalize_rows(dev, gen, images):
    """K13's equalize (csrc/lut.cu::equalize_kernel, one cluster an image,
    in place) bitwise equal to ``equalize_plain`` at DINOv2's [24, 518,
    518] with every image and with 3 of them (a constant image, one 70% one
    value, noise), the odd [3, 37, 41] and [3, 301, 303], the trainer's [32,
    224, 224] and one [1, 1024, 1024] image; one device record a call with
    a device index list; the kernel alone, the op and the plain version
    timed at [24, 518, 518] (each call equalizing the last one's output in
    place), and the kernel alone at cluster sizes 4, 8 and 16 with every
    image and with 3. Returns the kernels line's row."""
    import torch

    from nextgen_uia_tpu_torch.ops import lut

    db, n518 = DINO_BATCH, DINO_IMG
    big = images((db, n518, n518))
    big[1] = 37 / 255  # constant: step 0, the identity
    big[2] = torch.where(torch.rand(n518, n518, generator=gen).to(dev) < 0.7,
                         torch.full_like(big[2], 5 / 255), big[2])  # 70% one dark value
    cases = [(f"[{db}, {n518}, {n518}], all {db}", big, list(range(db))),
             (f"[{db}, {n518}, {n518}], 3 of {db} (constant, 70% one value, noise)", big,
              [1, 2, 20]),
             ("odd [3, 37, 41]", images((3, 37, 41)), [2, 0, 1]),
             ("odd [3, 301, 303]", images((3, 301, 303)), [1, 2]),
             (f"[{BATCH}, {IMG}, {IMG}], every third", images((BATCH, IMG, IMG)),
              list(range(0, BATCH, 3))),
             ("[1, 1024, 1024]", images((1, 1024, 1024)), [0])]
    with torch.no_grad():
        for what, x, idx in cases:
            got = lut.equalize_(x.clone(), idx)
            want = lut.equalize_plain(x.clone(), idx)
            torch.cuda.synchronize()
            cluster, slice_ = lut._eq_grid(len(idx), x[0].numel())
            require(torch.equal(got, want), f"equalize differs from its plain version at {what}")
            print(f"equalize: {what}: equal to the plain version (clusters of {cluster}, "
                  f"slices of {slice_} floats)")
        grid = lut.unit_grid(dev)
        quotient = torch.arange(256, dtype=torch.float32) / 255.0
        print(f"equalize: the card's unit grid (quantize_u8(v / 255) on the card) differs from "
              f"v / 255 (the CPU's) at {int((grid.cpu() != quotient).sum())} of 256 bytes")

        idx = torch.arange(db, device=dev, dtype=torch.int32)
        buf, buf_p = big.clone(), big.clone()
        records, names = device_records(lambda: lut.equalize_(buf, idx))
        require(records in (None, 1), f"equalize ran {records} device records a call: {names}")
        ms = cuda_ms(lambda: lut.equalize_(buf, idx), 20)
        host_ms = cuda_ms(lambda: lut.equalize_(buf, list(range(db))), 20)
        k_ms = kernel_device_ms(lambda: lut.equalize_(buf, idx), "equalize_kernel")
        plain_ms = cuda_ms(lambda: lut.equalize_plain(buf_p, idx.long()), 5, warmup=1)
        flat, var_ms = buf.reshape(db, -1), []
        for sel in (idx, idx[[1, 2, 20]]):  # the kernel alone: one call's host time is longer
            for cluster in (4, 8, 16):
                slice_ = 4 * -(-flat.shape[1] // (4 * cluster))
                var_ms.append((len(sel), cluster, kernel_device_ms(
                    lambda: lut._launch_equalize(flat, sel, cluster, slice_), "equalize_kernel")))
    b_ms, b_by = bound(0, 2 * big.numel() * 4 + db * 4 + 1024)
    print(f"equalize: [{db}, {n518}, {n518}] all {db}: kernel {ms:.4f} ms (device idx; "
          f"{records} device record a call), op with a host index list {host_ms:.4f} ms, "
          f"kernel alone {k_ms:.4f} ms (profiler), plain {plain_ms:.4f} ms, library -, bound "
          f"{b_ms:.4f} ms ({b_by}); kernel alone by cluster size (images, cluster): "
          + ", ".join(f"({n_}, {c}) {t:.4f} ms" for n_, c, t in var_ms))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def k6_k8_costs(b, n, d, heads, hid):
    """(operations, bytes) of K6's forward and dx backward and K8's forward
    and dx backward at [b, n, d] (as ``kernel_phase``'s rows count them)."""
    m, dh = b * n, d // heads
    attn = 4 * b * heads * n * n * dh
    return {"fused_attn_o_residual": (attn + 2 * m * d * d, 2 * (5 * m * d + d * d)),
            "fused_attn_o_residual_backward": (2.5 * attn + 2 * m * d * d,
                                               2 * (7 * m * d + d * d)),
            "fused_ln_mlp_residual": (4 * m * d * hid, 2 * (2 * m * d + 2 * d * hid)),
            "fused_ln_mlp_residual_backward": (6 * m * d * hid, 2 * (3 * m * d + 2 * d * hid))}


def k6_k8_rows(dev, blk):
    """K6 (attention + o-projection + residual) and K8 (LayerNorm + MLP +
    residual), forward and dx backward, at the bench step's [64, 197, 768],
    12 heads (K8 with gelu and with quick_gelu): float32 against the plain
    version within 1e-4 * max|ref|, bf16 on the bf16-rounded inputs within
    3e-2 * max(1, max|ref|), each output against its own scale; both bf16
    backwards bitwise equal over two calls. Then in bf16, each op by CUDA
    events over back-to-back wrapper calls, its kernels alone (profiler
    device time per call of its GEMM, flash and layernorm kernels; every
    GEMM the profiler sees must be the Hopper core's, none the WMMA one,
    and no SIMT attention kernel may run; a window with no device activity
    leaves that check unmade and says so), each kernel the call launched
    with its device ms (the weight transposes and casts included), the
    plain version and the bound."""
    import torch

    from nextgen_uia_tpu_torch.ops import fused_attn_o as fao
    from nextgen_uia_tpu_torch.ops import fused_ln_mlp as flm

    f32, bf16 = torch.float32, torch.bfloat16
    b, n, d, h = FT_BATCH, 197, 768, 12
    hid, dh = 4 * d, d // h
    gen = torch.Generator().manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    q, k, v = (randn(b, h, n, dh) for _ in range(3))
    x, g = randn(b, n, d), randn(b, n, d)
    o, wo = blk.attn.o, blk.attn.o.w
    ws = flm._weights(blk.ln2, blk.mlp, f32)[:5]
    ops = {
        "fused_attn_o_residual": (
            lambda q_, k_, v_, x_, _g: fao.fused_attn_o_residual(q_, k_, v_, x_, o, heads=h),
            lambda q_, k_, v_, x_, _g: fao.fused_attn_o_residual_plain(q_, k_, v_, x_, o,
                                                                       heads=h)),
        "fused_attn_o_residual_backward": (
            lambda q_, k_, v_, _x, g_: fao.fused_attn_o_residual_backward(
                q_, k_, v_, wo.to(q_.dtype), g_),
            lambda q_, k_, v_, _x, g_: fao.fused_attn_o_residual_backward_plain(
                q_, k_, v_, wo, g_))}
    for act in ("gelu", "quick_gelu"):
        ops[f"fused_ln_mlp_residual {act}"] = (
            lambda q_, k_, v_, x_, _g, a=act: flm.fused_ln_mlp_residual(x_, blk.ln2, blk.mlp,
                                                                        act=a),
            lambda q_, k_, v_, x_, _g, a=act: flm.fused_ln_mlp_residual_plain(
                x_, blk.ln2, blk.mlp, act=a))
        ops[f"fused_ln_mlp_residual_backward {act}"] = (
            lambda q_, k_, v_, x_, g_, a=act: flm.fused_ln_mlp_residual_backward(
                x_, ws[0], ws[1], ws[2].to(x_.dtype), ws[3], ws[4].to(x_.dtype), g_, act=a),
            lambda q_, k_, v_, x_, g_, a=act: flm.fused_ln_mlp_residual_backward_plain(
                x_, *ws, g_, act=a))
    args32 = [q, k, v, x, g]
    args_b = [t.to(bf16) for t in args32]
    args_r = [t.to(bf16).float() for t in args32]
    costs = k6_k8_costs(b, n, d, h, hid)
    with torch.no_grad():
        for name, (kern, plain) in ops.items():
            rel32 = max(e / s for e, s in errors(kern(*args32), plain(*args32)))
            errs = errors(kern(*args_b), plain(*args_r))
            err_b, scale_b = max(errs, key=lambda e: e[0] / max(1.0, e[1]))
            first, second = kern(*args_b), kern(*args_b)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in
                       zip(first if isinstance(first, tuple) else (first,),
                           second if isinstance(second, tuple) else (second,)))
            print(f"{name}: [{b}, {n}, {d}], {h} heads: f32 rel max|d| {rel32:.3e} (<= 1e-4); "
                  f"bf16 max|d| {err_b:.3e} (<= {BF16_BOUND * max(1.0, scale_b):.3e}, max|ref| "
                  f"{scale_b:.3e}); two bf16 calls bitwise equal: {same}")
            require(rel32 <= F32_BOUND, f"{name} float32 mismatch at [{b}, {n}, {d}]")
            require(err_b <= BF16_BOUND * max(1.0, scale_b),
                    f"{name} bfloat16 mismatch at [{b}, {n}, {d}]")
            require(same or "backward" not in name,
                    f"{name} bf16 is not bitwise repeatable at [{b}, {n}, {d}]")
            if name.endswith("quick_gelu"):
                continue
            op_ms = cuda_ms(lambda: kern(*args_b), 20)
            kern_ms, seen, check = hopper_kernels_ms(name, lambda: kern(*args_b))
            for key, ms_ in sorted(seen.items(), key=lambda kv: -kv[1]):
                print(f"{name}:   {ms_:.4f} ms {key[:100]}")
            plain_ms = cuda_ms(lambda: plain(*args_b), 3, warmup=1)
            b_ms, b_by = bound(*costs[name.split()[0]])
            print(f"{name}: bf16 [{b}, {n}, {d}]: op {op_ms:.4f} ms, kernels alone "
                  f"{kern_ms:.4f} ms ({check}), plain {plain_ms:.4f} ms, library -, bound "
                  f"{b_ms:.4f} ms ({b_by})")


K5_SHAPES = ((FT_BATCH, 197), (BATCH, 197), (3, 37), (1, 1))  # bench, supervised, ragged


def k5_rows(dev, blk):
    """K5 pre-norm (LayerNorm + q/k/v, forward and dx backward), on the
    Hopper GEMM core in bf16, at K5_SHAPES x 768, 12 heads: float32 against
    the plain version within 1e-4 * max|ref|, bf16 on the bf16-rounded
    inputs within 3e-2 * max(1, max|ref|), each output against its own
    scale; the bf16 backward bitwise equal over two calls. At the bench
    step's and the supervised step's shapes, in bf16: the op by CUDA events,
    its kernels alone (the gemm and layernorm kernels; no kernel of
    OLD_KERNELS), each kernel with its device ms, the plain version and the
    bound."""
    import torch

    from nextgen_uia_tpu_torch.ops import fused_ln_qkv as flq

    f32, bf16 = torch.float32, torch.bfloat16
    d, h = 768, 12
    dh = d // h
    gen = torch.Generator().manual_seed(14)
    gamma, _, w_qkv, _ = flq._weights(blk.ln1, blk.attn, f32)
    ops = {"fused_ln_qkv": (
               lambda x, *_: flq.fused_ln_qkv(x, blk.ln1, blk.attn, heads=h),
               lambda x, *_: flq.fused_ln_qkv_plain(x, blk.ln1, blk.attn, heads=h)),
           "fused_ln_qkv_backward": (
               lambda x, *dy: flq.fused_ln_qkv_backward(x, gamma, w_qkv.to(x.dtype), *dy),
               lambda x, *dy: flq.fused_ln_qkv_backward_plain(x, gamma, w_qkv, *dy))}
    for b, n in K5_SHAPES:
        m = b * n
        args32 = [torch.randn(b, n, d, generator=gen).to(dev)] + [
            torch.randn(b, h, n, dh, generator=gen).to(dev) for _ in range(3)]
        args_b = [t.to(bf16) for t in args32]
        args_r = [t.float() for t in args_b]
        costs = {"fused_ln_qkv": (2 * m * d * 3 * d, 2 * (4 * m * d + 3 * d * d)),
                 "fused_ln_qkv_backward": (2 * m * d * 3 * d, 2 * (5 * m * d + 3 * d * d))}
        with torch.no_grad():
            for name, (kern, plain) in ops.items():
                rel32 = max(e / sc for e, sc in errors(kern(*args32), plain(*args32)))
                err_b, scale_b = max(errors(kern(*args_b), plain(*args_r)),
                                     key=lambda e: e[0] / max(1.0, e[1]))
                first, second = kern(*args_b), kern(*args_b)
                torch.cuda.synchronize()
                same = all(torch.equal(a, c) for a, c in
                           zip(first if isinstance(first, tuple) else (first,),
                               second if isinstance(second, tuple) else (second,)))
                print(f"{name}: [{b}, {n}, {d}], {h} heads: f32 rel max|d| {rel32:.3e} (<= 1e-4); "
                      f"bf16 max|d| {err_b:.3e} (<= {BF16_BOUND * max(1.0, scale_b):.3e}, max|ref| "
                      f"{scale_b:.3e}); two bf16 calls bitwise equal: {same}")
                require(rel32 <= F32_BOUND, f"{name} float32 mismatch at [{b}, {n}, {d}]")
                require(err_b <= BF16_BOUND * max(1.0, scale_b),
                        f"{name} bfloat16 mismatch at [{b}, {n}, {d}]")
                require(same or "backward" not in name,
                        f"{name} bf16 is not bitwise repeatable at [{b}, {n}, {d}]")
                if n != 197:
                    continue
                op_ms = cuda_ms(lambda: kern(*args_b), 20)
                kern_ms, seen, check = hopper_kernels_ms(name, lambda: kern(*args_b),
                                                         ("gemm", "layernorm"))
                for key, ms_ in sorted(seen.items(), key=lambda kv: -kv[1]):
                    print(f"{name}:   {ms_:.4f} ms {key[:100]}")
                plain_ms = cuda_ms(lambda: plain(*args_b), 3, warmup=1)
                b_ms, b_by = bound(*costs[name])
                print(f"{name}: bf16 [{b}, {n}, {d}]: op {op_ms:.4f} ms, kernels alone "
                      f"{kern_ms:.4f} ms ({check}), plain {plain_ms:.4f} ms, library -, bound "
                      f"{b_ms:.4f} ms ({b_by})")


def fused_kernel_rows(dev, gen, results):
    """K12 (the whole MONA adapter) and K11 (the attention block) at the
    bench step's shapes, x [64, 197, 768]: each against its plain version on
    the same inputs, float32 and bfloat16. K12 (each of the four variants,
    c = 64, a dropout mask): output and dx within 1e-4 * max|ref| (float32)
    or 3e-2 * max|ref| (bf16); each parameter gradient within min(1e-4 * the
    largest max|ref|, 3e-2 * its own) in float32, 3e-2 * the largest in
    bf16; two backward calls bitwise equal; the hybrid adapter's bf16 op and
    kernels alone (no WMMA GEMM, colgemm_kernel or mona_down_kernel). K11 (12 heads, a key-padding bias) forward, dx
    backward and the hybrid forward (plain products around K7), and a causal
    case [16, 77, 512] with 8 heads: 1e-4 / 3e-2 * max|ref|, the bf16
    backward bitwise equal over two calls. CUDA-event times in bf16 beside
    the plain versions and, for K11 (both cases, ``k11_timings``),
    its kernels alone and ``multi_head_attention_forward`` (packed
    in-projection) and its autograd backward, timed only."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.adapters.mona import Mona
    from nextgen_uia_tpu_torch.nn.attention import Attention
    from nextgen_uia_tpu_torch.ops import fused_attention as fa
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    f32, bf16 = torch.float32, torch.bfloat16
    b, n, d, c, grid = FT_BATCH, 197, 768, 64, 14
    m, hw = b * n, (grid, grid)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def adapter(variant):
        mona = Mona(gen, d, c, variant)
        with torch.no_grad():  # the init's gamma (1e-6) would hide the LayerNorm branch
            mona.gamma.copy_(0.5 * torch.randn(d, generator=gen))
            mona.norm.scale.add_(0.1 * torch.randn(d, generator=gen))
            mona.norm.bias.add_(0.1 * torch.randn(d, generator=gen))
            if hasattr(mona, "freq_filter"):
                mona.freq_filter.add_(0.3 * torch.randn(c, generator=gen))
        return mona.to(dev)

    x32, g32 = randn(b, n, d), randn(b, n, d)
    mkw = dict(mask=((torch.rand(b, n, c, generator=gen) < 0.9).float() / 0.9).to(dev))
    bf16_err = {}
    for variant in ("baseline", "freq_enhanced", "noise_aware", "hybrid"):
        mona = adapter(variant)
        mkw["variant"] = variant
        for dtype in (f32, bf16):
            x, g = x32.to(dtype), g32.to(dtype)
            with torch.no_grad():
                out, saved = fm.mona_block_fused_forward(mona, x, hw, **mkw)
                ref = fm.mona_block_fused_plain(mona, x, hw, **mkw)
                dx, grads = fm.mona_block_fused_backward(mona, x, hw, g, saved, **mkw)
                dx2, grads2 = fm.mona_block_fused_backward(mona, x, hw, g, saved, **mkw)
                want_dx, want = fm.mona_block_fused_backward_plain(mona, x, hw, g, **mkw)
                torch.cuda.synchronize()
            lim = F32_BOUND if dtype == f32 else BF16_BOUND
            (e_out, s_out), (e_dx, s_dx) = errors((out, dx), (ref, want_dx))
            if dtype == f32:
                worst, name = worst_ratio(grads, want, lambda k: False)
            else:
                top = max(r.abs().max().item() for r in want.values())
                worst, name = max(((grads[k] - r).abs().max().item() / (lim * top), k)
                                  for k, r in want.items())
            same = torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k]) for k in want)
            print(f"mona_block_fused: {dtype} [{b}, {n}, {d}] {variant}: output max|d| "
                  f"{e_out:.3e} (<= {lim * s_out:.3e}), dx {e_dx:.3e} (<= {lim * s_dx:.3e}); "
                  f"{len(want)} parameter gradients worst max|d| / limit {worst:.3f} ({name}); "
                  f"two backward calls bitwise equal: {same}")
            require(e_out <= lim * s_out, f"mona_block_fused {dtype} {variant} output mismatch")
            require(e_dx <= lim * s_dx, f"mona_block_fused backward {dtype} {variant} dx mismatch")
            require(worst <= 1.0, f"mona_block_fused backward {dtype} {variant} gradient of "
                                  f"{name} mismatch")
            require(set(grads) == {k for k, _ in mona.named_parameters()},
                    f"mona_block_fused backward ({variant}) does not cover every parameter")
            require(same, f"mona_block_fused backward {dtype} {variant} is not bitwise "
                          f"repeatable")
            if dtype == bf16 and variant == "hybrid":
                bf16_err = {"fwd": e_out, "bwd": max([e_dx] + [(grads[k] - r).abs().max().item()
                                                              for k, r in want.items()])}
    # the hybrid adapter in bf16: op and kernels alone (the wgmma products,
    # the spatial and LayerNorm kernels, the ordered sums; no kernel of
    # OLD_KERNELS), plain version, bound
    x, g = x32.to(bf16), g32.to(bf16)
    k12_kernels = ("gemm", "mona", "sum_splits")
    with torch.no_grad():
        _, saved = fm.mona_block_fused_forward(mona, x, hw, **mkw)
        fwd = lambda: fm.mona_block_fused_forward(mona, x, hw, **mkw)  # noqa: E731
        bwd = lambda: fm.mona_block_fused_backward(mona, x, hw, g, saved, **mkw)  # noqa: E731
        times = {"fwd": (cuda_ms(fwd, 20),
                         cuda_ms(lambda: fm.mona_block_fused_plain(mona, x, hw, **mkw), 5,
                                 warmup=1)),
                 "bwd": (cuda_ms(bwd, 20),
                         cuda_ms(lambda: fm.mona_block_fused_backward_plain(mona, x, hw, g,
                                                                            **mkw), 3,
                                 warmup=1))}
        alone = {"fwd": hopper_kernels_ms("mona_block_fused", fwd, k12_kernels),
                 "bwd": hopper_kernels_ms("mona_block_fused_backward", bwd, k12_kernels)}
    mono = 2 * 49 * b * grid * grid * c + 2 * b * grid * grid * c * c
    costs = {"fwd": (4 * m * d * c + mono, 2 * 2 * m * d + 4 * m * c),
             "bwd": (8 * m * d * c + 2 * mono, 3 * 2 * m * d + 4 * m * c)}
    for key, name in (("fwd", "mona_block_fused"), ("bwd", "mona_block_fused_backward")):
        (ms, plain_ms), (b_ms, b_by) = times[key], bound(*costs[key])
        k_ms, seen, check = alone[key]
        for kname, ms_ in sorted(seen.items(), key=lambda kv: -kv[1]):
            print(f"{name}:   {ms_:.4f} ms {kname[:100]}")
        print(f"{name}: bf16 [{b}, {n}, {d}] op {ms:.4f} ms, kernels alone {k_ms:.4f} ms "
              f"({check}), plain {plain_ms:.4f} ms, library -, bound {b_ms:.4f} ms ({b_by})")
        results[name] = dict(max_abs_err=bf16_err[key], ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # K11: [64, 197, 768], 12 heads, a key-padding bias; causal [16, 77, 512], 8 heads
    cases = [("main", b, n, d, 12, False, True), ("causal", 16, 77, 512, 8, True, False)]
    for label, bb, nn_, dd, heads, causal, has_bias in cases:
        att = Attention(gen, dd).to(dev)
        xa, ga = randn(bb, nn_, dd), randn(bb, nn_, dd)
        kb = None
        if has_bias:  # keys of a fifth of the columns padded, the rest a small bias
            kb = randn(bb, nn_) - 1e9 * (torch.rand(bb, nn_, generator=gen) < 0.2).to(dev)
        akw = dict(heads=heads, bias=kb, causal=causal)
        for dtype in (f32, bf16):
            x, g = xa.to(dtype), ga.to(dtype)
            with torch.no_grad():
                pairs = {"fused_attn_block": (fa.fused_attn_block(x, att, **akw),
                                              fa.fused_attn_block_plain(x, att, **akw)),
                         "fused_attn_block_backward": (
                             fa.fused_attn_block_backward(x, att, g, **akw),
                             fa.fused_attn_block_backward_plain(x, att, g, **akw)),
                         "hybrid_attn_block": (fa.hybrid_attn_block(x, att, **akw),
                                               fa.hybrid_attn_block_plain(x, att, **akw))}
                again = fa.fused_attn_block_backward(x, att, g, **akw)
                torch.cuda.synchronize()
            lim = F32_BOUND if dtype == f32 else BF16_BOUND
            for name, (got, want) in pairs.items():
                (err, scale), = errors(got, want)
                print(f"{name}: {label} {dtype} [{bb}, {nn_}, {dd}], {heads} heads, causal "
                      f"{causal}, key bias {has_bias}: max|d| {err:.3e} (<= {lim * scale:.3e})")
                require(bool(torch.isfinite(got).all()) and err <= lim * scale,
                        f"{name} {label} {dtype} mismatch")
                if label == "main" and dtype == bf16:
                    bf16_err[name] = err
            same = torch.equal(pairs["fused_attn_block_backward"][0], again)
            print(f"fused_attn_block_backward: {label} {dtype} two calls bitwise equal: {same}")
            require(same or dtype == f32, f"fused_attn_block_backward {label} bf16 is not bitwise "
                                          f"repeatable")
        if label == "causal":
            k11_timings(fa, att, xa.to(bf16), ga.to(bf16), akw, label)

    # times at the main shape in bf16; the library: multi_head_attention_forward
    att = Attention(gen, d).to(dev)
    x, g = randn(b, n, d).to(bf16), randn(b, n, d).to(bf16)
    kb = randn(b, n) - 1e9 * (torch.rand(b, n, generator=gen) < 0.2).to(dev)
    akw = dict(heads=12, bias=kb)
    t_fwd, t_bwd = k11_timings(fa, att, x, g, akw, "main")
    with torch.no_grad():
        t_hyb = (cuda_ms(lambda: fa.hybrid_attn_block(x, att, **akw), 20),
                 cuda_ms(lambda: fa.hybrid_attn_block_plain(x, att, **akw), 5, warmup=1))
    fwd_cost, bwd_cost = k11_costs(b, n, d, 12)
    for name, (ms, _, plain_ms, lib_ms), cost in (
            ("fused_attn_block", t_fwd, fwd_cost),
            ("fused_attn_block_backward", t_bwd, bwd_cost)):
        b_ms, b_by = bound(*cost)
        results[name] = dict(max_abs_err=bf16_err[name], ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(*fwd_cost)
    print(f"hybrid_attn_block: bf16 [{b}, {n}, {d}] forward (plain products, K7) {t_hyb[0]:.4f} "
          f"ms, plain {t_hyb[1]:.4f} ms, library {t_fwd[3]:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); max|d| {bf16_err['hybrid_attn_block']:.3e}")


def k11_costs(b, n, d, heads):
    """(forward, backward) (operations, bytes) of K11 at [b, n, d]: the
    forward's four projections and attention, x, the weights and the
    output; the dx backward's q/k/v, QK^T and dY.Wo^T recomputed or formed,
    dP, dS.K, dS^T.Q, P^T.dO and three dx products (P.V need not be: delta =
    rowsum(dP * P)), x, g, the weights and dx. bf16."""
    m, dh = b * n, d // heads
    proj, attn = 2 * m * d * d, 4 * b * heads * n * n * dh
    return ((4 * proj + attn, 2 * 2 * m * d + 2 * 4 * d * d + 4 * b * n),
            (7 * proj + 5 * attn // 2, 3 * 2 * m * d + 2 * 4 * d * d + 4 * b * n))


def k11_timings(fa, att, x, g, akw, label):
    """K11's forward and dx backward ops in bf16 on x, g: the op (CUDA
    events over back-to-back wrapper calls), its kernels alone (profiler
    device time per call of every GEMM and flash-attention kernel it
    launches; in bf16 every GEMM the profiler sees must be the Hopper
    core's, none the WMMA one; a window with no device activity leaves that
    check unmade, and says so), the plain version, ``multi_head_attention_forward`` (packed
    in-projection, the key bias as a float mask, the causal mask as a
    boolean one) and its autograd backward, and the bound. Returns
    ((op, kernel, plain, library) forward, (...) backward) in ms."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    b, n, d = x.shape
    heads, kb, causal = akw["heads"], akw.get("bias"), akw.get("causal", False)
    w_in = torch.cat([att.q.w, att.k.w, att.v.w], 1).T.contiguous().to(bf16)
    b_in = torch.cat([att.q.b, att.k.b, att.v.b]).to(bf16)
    w_out, b_out = att.o.w.T.contiguous().to(bf16), att.o.b.to(bf16)
    kpm = None if kb is None else kb.to(bf16)
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1) if causal else None

    def library(xq):
        xt = xq.transpose(0, 1)
        return F.multi_head_attention_forward(
            xt, xt, xt, d, heads, w_in, b_in, None, None, False, 0.0, w_out, b_out,
            training=False, key_padding_mask=kpm, need_weights=False, attn_mask=mask)[0]

    def fwd():
        return fa.fused_attn_block(x, att, **akw)

    def bwd():
        return fa.fused_attn_block_backward(x, att, g, **akw)

    rows, wmma_check = [], []
    with torch.no_grad():
        for what, fn, plain in (
                ("forward", fwd, lambda: fa.fused_attn_block_plain(x, att, **akw)),
                ("backward", bwd, lambda: fa.fused_attn_block_backward_plain(x, att, g, **akw))):
            seen = set()
            op_ms = cuda_ms(fn, 20)
            kern_ms = kernel_device_ms(fn, ("gemm", "flash"), seen=seen)
            wmma = sorted(k[:60] for k in seen if "gemm_bf16" in k)
            require(not wmma and (not seen or any("hopper::gemm_kernel" in k for k in seen)),
                    f"K11 {what} bf16 ran {wmma or 'no Hopper GEMM'}: every projection must run "
                    f"on hopper_gemm.cuh's core")
            wmma_check.append("no WMMA GEMM" if seen else
                              "WMMA check not made: the profiler recorded no device activity")
            rows.append([op_ms, kern_ms, cuda_ms(plain, 3, warmup=1)])
    rows[0].append(cuda_ms(lambda: library(x), 20))
    xg = x.detach().requires_grad_()
    lib_out = library(xg)
    rows[1].append(cuda_ms(lambda: torch.autograd.grad(lib_out, xg, g.transpose(0, 1),
                                                      retain_graph=True), 20))
    for what, row, check, cost in zip(("forward", "backward"), rows, wmma_check,
                                      k11_costs(b, n, d, heads)):
        b_ms, b_by = bound(*cost)
        print(f"fused_attn_block{'_backward' if what == 'backward' else ''}: {label} bf16 "
              f"[{b}, {n}, {d}], {heads} heads, key bias {kb is not None}, causal {causal}: op "
              f"{row[0]:.4f} ms, kernels alone {row[1]:.4f} ms ({check}), plain "
              f"{row[2]:.4f} ms, library (multi_head_attention_forward"
              f"{' backward' if what == 'backward' else ''}) {row[3]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    return tuple(rows)


K7_EDGES = (1, 63, 64, 65, 127, 128, 129)  # around the 64-row boxes and 128-row tiles


def k7_edges(fa, randn, rounded):
    """K7 at the wgmma kernels' tile edges, N in K7_EDGES: bf16, q, k, v as
    views of one packed [2, N, 3, 3, 64] projection, a key bias and the
    causal mask. The output and each gradient against the plain versions on
    the same bf16-rounded inputs within 3e-2 * max|ref| (a gradient whose
    reference is exactly zero, dq, dk and dbias at N = 1 where P = 1,
    within 3e-2 * the largest gradient's max|ref|: the kernel's D comes from
    the rounded output, so it keeps ~1e-7); the saved lse against the plain
    log-sum-exp within 1e-4 * max(1, max|ref|); dq, dk, dv bitwise equal
    over two calls. Then one sequence wholly padded (-1e9 bias) at N = 96."""
    import torch

    bf16 = torch.bfloat16
    for n in K7_EDGES:
        qkv, kb, g = rounded(randn(2, n, 3, 3, 64)), randn(2, n), rounded(randn(2, n, 3, 64))
        q, k, v = qkv.to(bf16).unbind(2)
        ref = qkv.unbind(2)
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(q, k, v, bias=kb, causal=True)
            first, second = (fa.flash_attention_backward(q, k, v, out, g.to(bf16), lse, bias=kb,
                                                         causal=True) for _ in range(2))
            want = fa.flash_attention_plain(*ref, bias=kb, causal=True)
            want_lse = fa.flash_attention_lse_plain(*ref[:2], bias=kb, causal=True)
            want_g = fa.flash_attention_backward_plain(*ref, kb, g, causal=True)
            torch.cuda.synchronize()
        (err, scale), = errors(out, want)
        require(err <= BF16_BOUND * scale, f"flash_attention bf16 at N = {n}: max|d| {err:.3e} "
                                           f"> {BF16_BOUND * scale:.3e}")
        (err_l, scale_l), = errors(lse, want_lse)
        require(err_l <= F32_BOUND * max(1.0, scale_l),
                f"flash_attention lse at N = {n}: max|d| {err_l:.3e} (max|ref| {scale_l:.3e})")
        errs = errors(tuple(first), tuple(want_g))
        largest = max(sc for _, sc in errs)
        ratio = max(d / (BF16_BOUND * (sc if sc > 0 else largest)) for d, sc in errs)
        require(ratio <= 1.0, f"flash_attention_backward bf16 at N = {n}: max|d| / limit "
                              f"{ratio:.3f}")
        require(all(torch.equal(a, c) for a, c in zip(first[:3], second[:3])),
                f"flash_attention_backward at N = {n} not bitwise equal over two calls")
        print(f"flash_attention: tile edge N = {n} (bf16, packed bnhd, bias, causal): output "
              f"max|d| / max|ref| {err / scale:.3e}, lse max|d| {err_l:.3e}, gradients max|d| / "
              f"limit {ratio:.3e}, backward bitwise equal over two calls")

    # a sequence whose every key carries BERT's -1e9 padding bias beside one
    # with its last third padded, at an N whose last key tile is ragged:
    # output against the plain version, every gradient finite (the padded
    # sequence's lse rounds to -1e9, so its P is 1, not 1 / N, and its
    # gradients are not the plain version's), the other sequence's
    # gradients against the plain backward
    n = 96
    qkv, g = rounded(randn(2, n, 3, 3, 64)), rounded(randn(2, n, 3, 64))
    kb = torch.zeros_like(qkv[:, :, 0, 0, 0])
    kb[0, 2 * n // 3:], kb[1] = -1e9, -1e9
    with torch.no_grad():
        out, lse = fa.flash_attention_forward(*qkv.to(bf16).unbind(2), bias=kb)
        got = fa.flash_attention_backward(*qkv.to(bf16).unbind(2), out, g.to(bf16), lse, bias=kb)
        want = fa.flash_attention_plain(*qkv.unbind(2), bias=kb)
        want_g = fa.flash_attention_backward_plain(*qkv.unbind(2), kb, g)
        torch.cuda.synchronize()
    (err, scale), = errors(out, want)
    require(err <= BF16_BOUND * scale, f"flash_attention with a wholly padded sequence: max|d| "
                                       f"{err:.3e} > {BF16_BOUND * scale:.3e}")
    require(all(bool(torch.isfinite(t).all()) for t in got),
            "flash_attention_backward with a wholly padded sequence: a gradient is not finite")
    ratio = max(d / (BF16_BOUND * sc) for d, sc in errors(tuple(t[0] for t in got),
                                                          tuple(t[0] for t in want_g)))
    require(ratio <= 1.0, f"flash_attention_backward beside a wholly padded sequence: max|d| / "
                          f"limit {ratio:.3f}")
    print(f"flash_attention: N = {n} with a wholly padded sequence (bf16, -1e9 bias): output "
          f"max|d| / max|ref| {err / scale:.3e}, gradients finite, the other sequence's max|d| "
          f"/ limit {ratio:.3e}")


def k7_timings(fa, randn, sdpa_backward, bwd_cost):
    """K7's forward and backward at compare_trees.K7_SHAPES in bf16 (the
    shapes its ``k7`` mode times against another tree): the op (CUDA events
    over back-to-back wrapper calls, its host time included), its kernels
    alone (profiler device time of every "flash" kernel per call),
    scaled_dot_product_attention's forward and autograd backward on the same
    inputs, and the bound. Returns {(B, H, N): ((op, kernel, library,
    bound_ms, bound_by) forward, (...) backward)}."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.tools.compare_trees import K7_SHAPES

    bf16, times = torch.bfloat16, {}
    for b, h, n, layout, bias in K7_SHAPES:
        shape = (b, h, n, 64) if layout == "bhnd" else (b, n, h, 64)
        q, k, v, g = (randn(*shape).to(bf16) for _ in range(4))
        kb = randn(b, n) if bias else None
        iters = 10 if n > 1000 else 20
        qs, ks, vs = (t.transpose(1, 2) if layout == "bnhd" else t for t in (q, k, v))
        mask = None if kb is None else kb[:, None, None, :].to(bf16)
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(q, k, v, bias=kb, layout=layout)

            def fwd():
                return fa.flash_attention_forward(q, k, v, bias=kb, layout=layout)

            def bwd():
                return fa.flash_attention_backward(q, k, v, out, g, lse, bias=kb, layout=layout,
                                                   bias_grad=False)

            f_op, b_op = cuda_ms(fwd, iters), cuda_ms(bwd, iters)
            f_k, b_k = kernel_device_ms(fwd, "flash", iters), kernel_device_ms(bwd, "flash", iters)
            f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                            iters)
        b_lib = cuda_ms(sdpa_backward([q, k, v], g, kb, layout), iters)
        fwd_row = (f_op, f_k, f_lib, *bound(4 * b * h * n * n * 64,
                                            2 * 4 * b * h * n * 64 + 4 * b * h * n
                                            + (4 * b * n if bias else 0)))
        bwd_row = (b_op, b_k, b_lib, *bound(*bwd_cost(b, n)))
        times[(b, h, n)] = (fwd_row, bwd_row)
        for what, row in (("forward", fwd_row), ("backward", bwd_row)):
            print(f"flash_attention {what} [{b}, {h}, {n}, 64] {layout} bias={bias} bf16: op "
                  f"{row[0]:.4f} ms, kernel {row[1]:.4f} ms, library (scaled_dot_product_"
                  f"attention{' backward' if what == 'backward' else ''}) {row[2]:.4f} ms, bound "
                  f"{row[3]:.4f} ms ({row[4]})")
    return times


def kernel_device_ms(fn, name, iters=20, windows=3, seen=None):
    """Device ms per call of the kernels whose name holds ``name`` (or any
    of a tuple of names), from torch.profiler over ``iters`` calls of fn (no
    host time in it); the window's kernel names go into ``seen`` if given.
    A window that comes back without the kernel is profiled again, up to
    ``windows`` in all. Fails if a window recorded other kernels but never
    this one; NaN ("not measured") if the profiler recorded no device
    activity at all, which says nothing of the kernel (its launches are
    counted elsewhere). ``seen`` may be a set (the names) or a dict (each
    name's device ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else name
    fn()
    torch.cuda.synchronize()
    others = set()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", 0) for e in kernels
                 if any(part in e.key for part in names))
        if us > 0:
            if seen is not None:  # a set takes the names, a dict {name: ms per call}
                seen.update({e.key: getattr(e, "self_device_time_total", 0) / 1e3 / iters
                             for e in kernels})
            return us / 1e3 / iters
        others.update(e.key[:60] for e in kernels)
        print(f"kernel_device_ms: a profiler window saw no {name} kernel among "
              f"{len(kernels)} device records")
    require(not others, f"the profiler saw no {name} kernel in {windows} windows, only "
                        f"{sorted(others)[:4]}")
    print(f"kernel_device_ms: {name} kernel alone not measured (the profiler recorded no "
          f"device activity in {windows} windows)")
    return float("nan")


# the port's old product kernels, which no bf16 call may reach: the WMMA
# GEMM, K12's SIMT down product and weight products (named as the port
# names them: a whole step also runs library kernels)
OLD_PRODUCTS = ("nx::gemm_bf16", "colgemm_kernel", "mona_down_kernel")
# ... and, inside a redesigned op's own window, no SIMT attention either
OLD_KERNELS = OLD_PRODUCTS + ("attention_kernel", "simt")


def hopper_kernels_ms(name, fn, kernels=("gemm", "flash", "layernorm"), gemm=True):
    """(device ms per call of fn's kernels alone, {kernel: ms per call},
    what the check saw): the profiler's kernels whose names hold one of
    ``kernels``. A bf16 call must run its products on hopper_gemm.cuh's core
    (or another wgmma kernel; ``gemm=False`` for an op with no product) and
    its attention on K7's wgmma kernels: a kernel of OLD_KERNELS (the WMMA
    GEMM, a SIMT attention, K12's SIMT products) fails the run; a window
    with no device activity leaves that check unmade and says so."""
    seen = {}
    ms = kernel_device_ms(fn, kernels, seen=seen)
    bad = sorted(k[:60] for k in seen if any(old in k for old in OLD_KERNELS))
    require(not bad and (not seen or not gemm or any("hopper::gemm_kernel" in k for k in seen)),
            f"{name} bf16 ran {bad or 'no Hopper GEMM'}: every product must run on "
            f"wgmma and the attention on K7's wgmma kernels")
    return ms, seen, ("no WMMA GEMM, no SIMT product or attention" if seen else
                      "WMMA check not made: the profiler recorded no device activity")


def device_records(fn, windows=4):
    """(device records per call of fn, their names): every kernel, copy and
    fill the profiler sees in one call after a warm-up call. Each window
    opens and closes with a spin kernel, left out of the count: the profiler
    has dropped one record of a window (1 of 2 calls, 3 of 4, 7 of 8), and
    the markers stand where that record was lost. A window that comes back
    empty, or with fewer records than calls (every call launches at least
    one kernel, so the profiler lost some), is profiled again with twice the
    calls, 1 to 8, and the count divided by them; the last such window's
    count if none was whole; (None, ()) if no window recorded device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    last = None, ()
    for window in range(windows):
        calls = 1 << window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [e for e in device if "spin_kernel" not in e.key]
        spins = sum(e.count for e in device) - sum(e.count for e in events)
        if spins != 2:
            print(f"device_records: a window of {calls} calls held {spins} of its 2 markers")
        if events:
            count = sum(e.count for e in events)
            last = count / calls, sorted(e.key[:60] for e in events)
            if count >= calls:
                return last
            print(f"device_records: a window of {calls} calls held {count} device records")
    return last


def spatial_checks(dwconv, mona_args, with_bias, grid):
    """K2 and K3 in bf16 at [64 | 32, grid, grid, 64]: the kernels alone
    (profiler device time of csrc/mona_spatial.cu's stencil kernels), one
    device record a call (no sum, cast, copy or fill beside the kernel;
    fails otherwise), and K3's backward bitwise equal over two calls in
    float32 and bf16 (fails otherwise)."""
    import torch

    ops = {"mona_spatial": (dwconv.mona_spatial, with_bias),
           "mona_spatial_backward": (dwconv.mona_spatial_backward, lambda *sh: sh)}
    with torch.no_grad():
        for name, (fn, last) in ops.items():
            for bb in (64, 32):
                args = [t.to(torch.bfloat16) for t in mona_args(bb, grid, grid, 64, last)]
                k_ms, _, _ = hopper_kernels_ms(name, lambda: fn(*args), ("spatial_stencil",),
                                               gemm=False)
                count, names = device_records(lambda: fn(*args))
                print(f"{name} [{bb}, {grid}, {grid}, 64] bf16: kernels alone {k_ms:.4f} ms; "
                      f"device records a call: "
                      f"{'not measured' if count is None else count} {list(names)}")
                require(count in (None, 1), f"{name} ran {count} device records a call: "
                                            f"{names}")
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in mona_args(64, grid, grid, 64, lambda *sh: sh)]
            first, second = (dwconv.mona_spatial_backward(*args) for _ in range(2))
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(first, second)),
                    f"mona_spatial_backward {dtype} differs between two calls")
        print("mona_spatial_backward: two calls bitwise equal (float32, bf16)")


def inference(fn):
    """fn under torch.inference_mode, as a library layer is timed."""
    import torch

    def run(*args):
        with torch.inference_mode():
            return fn(*args)
    return run


def encoder_fast_path(name, library, x):
    """Prints whether the library's TransformerEncoderLayer call took
    PyTorch's fused fast path (torch._transformer_encoder_layer_fwd in the
    profiler's operator names) on x."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        library(x)
    fast = any("_transformer_encoder_layer_fwd" in e.key for e in prof.key_averages())
    print(f"{name}: library TransformerEncoderLayer, fast path: {'yes' if fast else 'no'}")


def wmma_gemm_ms(a, w, bias):
    """CUDA-event ms of block_kernels.cuh's WMMA GEMM (nx_gemm, the bf16
    product K5 raw-x ran on until its Hopper core) on a [M, K] @ w [K, N]
    (+ float32 bias), row-major bf16 out."""
    import torch

    from nextgen_uia_tpu_torch.ops import build

    lib, (rows, k), n = build.library(), a.shape, w.shape[1]
    bf16 = build.DTYPE_CODES[torch.bfloat16]
    out = torch.empty(rows, n, device=a.device, dtype=torch.bfloat16)
    stream = build.stream(a.device)
    return cuda_ms(lambda: build.check(lib.nx_gemm(
        build.ptr(a), build.ptr(w), bf16, build.ptr(bias), None, 0, build.ptr(out), bf16, 0, rows,
        n, k, stream), "nx_gemm"), 20)


def bert_kernel_rows(dev, gen, check):
    """BERT's post-norm kernels (K5 raw-x, K6 post-LN, K9, K1 post-norm) at
    the text cache's chunk [256, 256, 768], 12 heads, hidden 3072, eps
    1e-12, with a key-padding bias (-1e9) of seeded caption lengths that
    leaves the last two rows wholly padded, and at an odd [7, 96, 768]
    bucket; the wholly padded rows must come out finite."""
    import torch

    from nextgen_uia_tpu_torch.models.bert import BertConfig, BertLayer
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_block, fused_ln_mlp, fused_ln_qkv
    from nextgen_uia_tpu_torch.tools.compare_trees import encoder_layer

    cfg = BertConfig()
    b, n, d, h, hid, eps = TEXT_CHUNK, cfg.context_length, cfg.width, cfg.heads, \
        cfg.intermediate, cfg.ln_eps
    m, dh = b * n, d // h
    layer = BertLayer(gen, cfg)
    with torch.no_grad():
        for ln in (layer.attn_ln, layer.ffn_ln):
            ln.scale.add_(0.2 * torch.randn(d, generator=gen))
            ln.bias.add_(0.2 * torch.randn(d, generator=gen))
    layer.to(dev)

    def pad_bias(bb, nn_):
        lengths = torch.randint(2, nn_ + 1, (bb,), generator=gen)
        lengths[-2:] = 0
        return ((torch.arange(nn_)[None] >= lengths[:, None]).float() * -1e9).to(dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    bias, odd_bias = pad_bias(b, n), pad_bias(7, 96)
    x, odd_x = randn(b, n, d), randn(7, 96, d)
    with torch.no_grad():
        y = fused_block.fused_block_infer(x.to(torch.bfloat16), layer, heads=h, eps=eps,
                                          key_bias=bias, layout="postnorm")
        require(bool(torch.isfinite(y[-2:]).all()), "a wholly padded row came out non-finite")
    qkv_bytes = 2 * (4 * m * d + 3 * d * d)
    # the library's call: one GEMM on the concatenated weights, q/k/v being
    # head-major views of its [m, 3d] output
    lins = (layer.attn.q, layer.attn.k, layer.attn.v)
    w_qkv = torch.cat([lin.w for lin in lins], 1).to(torch.bfloat16)
    b_qkv = torch.cat([lin.b for lin in lins]).to(torch.bfloat16)
    # further shapes for the Hopper GEMM's (sequence, 128-token) tiles: a
    # token count the tile does not divide, and fewer rows than one tile
    check("fused_ln_qkv_rawx",
          lambda t: fused_ln_qkv.fused_ln_qkv(t, None, layer.attn, heads=h),
          lambda t: fused_ln_qkv.fused_ln_qkv_plain(t, None, layer.attn, heads=h),
          [x], [odd_x], (2 * m * d * 3 * d, qkv_bytes),
          library=lambda t: torch.addmm(b_qkv, t.view(-1, d), w_qkv),
          more=[[randn(7, 197, d)], [randn(1, 16, d)]])
    # the Hopper GEMM's device time alone (the op's time above adds the
    # wrapper and its weight concatenation), and the earlier design, the
    # shared WMMA GEMM, on the same product and bias (row-major [m, 3d] out)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        dev_ms = kernel_device_ms(lambda: fused_ln_qkv.fused_ln_qkv(xb, None, layer.attn, heads=h),
                                  "hopper::gemm_kernel")
    wmma = wmma_gemm_ms(xb.view(m, d), w_qkv, b_qkv.float())
    print(f"fused_ln_qkv_rawx: Hopper GEMM kernel alone {dev_ms:.4f} ms of device time; the "
          f"shared WMMA GEMM (nx_gemm) at the same product {wmma:.4f} ms")

    def attn(fn):
        return lambda q, k, v, t, odd=False: fn(q, k, v, t, layer.attn.o, heads=h,
                                                bias=odd_bias if odd else bias,
                                                post_ln=layer.attn_ln, ln_eps=eps)

    def qkv_x(bb, nn_, t):
        return [randn(bb, h, nn_, dh) for _ in range(3)] + [t]

    check("fused_attn_o_residual_postln", attn(fused_attn_o.fused_attn_o_residual),
          attn(fused_attn_o.fused_attn_o_residual_plain), qkv_x(b, n, x),
          qkv_x(7, 96, odd_x) + [True],
          (4 * b * h * n * n * dh + 2 * m * d * d, 2 * (5 * m * d + d * d) + 4 * b * n),
          kernels=True)
    check("fused_postnorm_mlp_ln",
          lambda t: fused_ln_mlp.fused_postnorm_mlp_ln(t, layer.ffn, layer.ffn_ln, eps=eps),
          lambda t: fused_ln_mlp.fused_postnorm_mlp_ln_plain(t, layer.ffn, layer.ffn_ln,
                                                             eps=eps),
          [x], [odd_x], (4 * m * d * hid, 2 * (2 * m * d + 2 * d * hid)), kernels=True)

    def whole(fn):
        return lambda t, odd=False: fn(t, layer, heads=h, eps=eps, layout="postnorm",
                                       key_bias=odd_bias if odd else bias)

    # the library's layer gives NaN on a wholly padded row (its fast path's
    # key-padding mask); it is timed only
    benc = encoder_layer(layer, "postnorm", h, "gelu", eps)
    bert_lib = inference(lambda t: benc(t, src_key_padding_mask=bias))
    check("fused_block_infer_postnorm", whole(fused_block.fused_block_infer),
          whole(fused_block.fused_block_infer_plain), [x], [odd_x, True],
          (2 * m * 12 * d * d + 4 * b * h * n * n * dh, 2 * (2 * m * d + 12 * d * d) + 4 * b * n),
          library=bert_lib, kernels=True)
    encoder_fast_path("fused_block_infer_postnorm", bert_lib, x.to(torch.bfloat16))


def text_lora_kernel_rows(dev, gen, check):
    """The kernels --tune_text_encoder adds, against their plain versions:
    K10's backward at the BERT fine-tune's microbatch [16 * 256, 768] x 3072
    (odd: [77, 128] x 512, quick_gelu; further [1001, 768]; its kernels
    alone; two bf16 calls bitwise equal), K5 raw-x's backward at [16, 256,
    768], 12 heads (odd: [3, 40, 128], 2 heads), and K4, forward and
    backward, at the MONA bottleneck on the ViT-B/16 grid [64, 14, 14, 64]
    (odd: [3, 9, 11, 24]). Then the post-norm chain's other two backwards,
    K6 post-LN's and K9's, which run as autograd through their plain
    recompositions (no kernel of their own, as in the JAX package): their
    device time per layer at [16, 256, 768]."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.models.bert import BertConfig, BertLayer
    from nextgen_uia_tpu_torch.ops import dwconv, fused_attn_o, fused_ln_mlp, fused_ln_qkv
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    cfg = BertConfig()
    b, n, d, h, hid = FT_MICRO, cfg.context_length, cfg.width, cfg.heads, cfg.intermediate
    m, dh = b * n, d // h

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def mlp_args(mm, dd, hh):
        return [randn(mm, dd), randn(dd, hh, scale=dd ** -0.5), randn(hh, scale=0.1),
                randn(hh, dd, scale=hh ** -0.5), randn(mm, dd)]

    def mlp_bwd(x, w1, b1, w2, g, odd=False):
        return fm.fused_mlp_backward(x, w1, b1, w2, g, act="quick_gelu" if odd else "gelu")

    check("fused_mlp_backward", mlp_bwd,
          lambda x, w1, b1, w2, g, odd=False: fm.fused_mlp_backward_plain(
              x, w1, b1, w2, g, act="quick_gelu" if odd else "gelu"),
          mlp_args(m, d, hid), mlp_args(77, 128, 512) + [True],
          (6 * m * d * hid, 2 * (3 * m * d + 2 * d * hid) + 4 * hid),
          more=[mlp_args(1001, d, hid)], kernels=True)
    with torch.no_grad():
        args_b = [t.to(torch.bfloat16) for t in mlp_args(m, d, hid)]
        first, second = mlp_bwd(*args_b), mlp_bwd(*args_b)
        torch.cuda.synchronize()
    require(torch.equal(first, second), "two bf16 calls of K10's backward differ")
    print(f"fused_mlp_backward: two bf16 calls bitwise equal at [{m}, {d}] x {hid}")

    def rawx_args(bb, nn_, hh, dd):
        return [randn(dd, 3 * dd, scale=dd ** -0.5)] + [randn(bb, hh, nn_, dd // hh)
                                                         for _ in range(3)]

    args = rawx_args(b, n, h, d)
    # the library's call: one product of the token-major [dq | dk | dv] with
    # W_qkv^T, the concatenation made beforehand
    dy_cat = fused_ln_qkv._head_cat(*args[1:]).to(torch.bfloat16)
    w_b = args[0].to(torch.bfloat16)

    def rawx_bwd(w, *t):
        return fused_ln_qkv.fused_ln_qkv_rawx_backward(w, *t, dtype=t[0].dtype)

    check("fused_ln_qkv_rawx_backward", rawx_bwd,
          lambda w, *t: fused_ln_qkv.fused_ln_qkv_rawx_backward_plain(w, *t, dtype=t[0].dtype),
          args, rawx_args(3, 40, 2, 128), (2 * m * 3 * d * d, 2 * (4 * m * d + 3 * d * d)),
          library=lambda *_: torch.mm(dy_cat, w_b.T),
          more=[rawx_args(7, 197, h, d), rawx_args(1, 16, h, d)])
    with torch.no_grad():
        args_b = [t.to(torch.bfloat16) for t in args]
        first, second = rawx_bwd(*args_b), rawx_bwd(*args_b)
        torch.cuda.synchronize()
    require(torch.equal(first, second), "two bf16 calls of K5 raw-x's backward differ")
    dev_ms = kernel_device_ms(lambda: rawx_bwd(*args_b), "hopper::gemm_kernel")
    wmma = wmma_gemm_ms(dy_cat, w_b.T.contiguous(), None)
    print(f"fused_ln_qkv_rawx_backward: two bf16 calls bitwise equal; Hopper GEMM kernel alone "
          f"{dev_ms:.4f} ms of device time; the shared WMMA GEMM (nx_gemm, dq|dk|dv "
          f"token-major) at the same product {wmma:.4f} ms")

    kb, kh, kc = FT_BATCH, IMG // 16, 64
    px = kb * kh * kh * kc

    def conv_args(bb, hh, ww, c, with_g):
        return [randn(bb, hh, ww, c), randn(bb, 7, 7, c, scale=0.2)] + (
            [randn(bb, hh, ww, c)] if with_g else [])

    def grouped_conv(x, k):
        """The library's call: one grouped convolution with B * C groups."""
        return F.conv2d(x.permute(3, 0, 1, 2).reshape(1, -1, *x.shape[1:3]),
                        k.permute(3, 0, 1, 2).reshape(-1, 1, 7, 7), padding=3,
                        groups=x.shape[0] * x.shape[3])

    check("dwconv7_per_sample", dwconv.dwconv7_per_sample, dwconv.dwconv7_per_sample_plain,
          conv_args(kb, kh, kh, kc, False), conv_args(3, 9, 11, 24, False),
          (2 * 49 * px, 2 * (2 * px + kb * 49 * kc), CUDA_CORE_FLOPS), library=grouped_conv)
    xg, kg, gg = (t.to(torch.bfloat16).requires_grad_() for t in conv_args(kb, kh, kh, kc, True))
    y = grouped_conv(xg, kg)
    g_conv = gg.detach().permute(3, 0, 1, 2).reshape(y.shape)
    check("dwconv7_per_sample_backward", dwconv.dwconv7_per_sample_backward,
          dwconv.dwconv7_per_sample_backward_plain, conv_args(kb, kh, kh, kc, True),
          conv_args(3, 9, 11, 24, True),
          (4 * 49 * px, 2 * (3 * px + 2 * kb * 49 * kc), CUDA_CORE_FLOPS),
          library=lambda *_: torch.autograd.grad(y, (xg, kg), g_conv, retain_graph=True))

    # K6 post-LN's and K9's backward: autograd through the plain version,
    # recomputed from the saved inputs (timed alone: forward kernel excluded)
    layer = BertLayer(gen, cfg).to(dev)
    bias = torch.zeros(b, n, device=dev)
    bias[:, n // 2:] = -1e9
    x = randn(b, n, d).to(torch.bfloat16).requires_grad_()
    qkv = [randn(b, h, n, dh).to(torch.bfloat16).requires_grad_() for _ in range(3)]
    g = randn(b, n, d).to(torch.bfloat16)
    y6 = fused_attn_o.fused_attn_o_residual(*qkv, x, layer.attn.o, heads=h, bias=bias,
                                            post_ln=layer.attn_ln)
    y9 = fused_ln_mlp.fused_postnorm_mlp_ln(x, layer.ffn, layer.ffn_ln)
    ms6 = cuda_ms(lambda: torch.autograd.grad(y6, [*qkv, x], g, retain_graph=True), 10)
    ms9 = cuda_ms(lambda: torch.autograd.grad(y9, x, g, retain_graph=True), 10)
    print(f"post-norm backwards by plain recomposition (bf16, [{b}, {n}, {d}], no kernel of "
          f"their own): K6 post-LN (dq, dk, dv, dx) {ms6:.4f} ms, K9 (dx) {ms9:.4f} ms per "
          f"layer")


def augment_phase(dev):
    """One strong+weak plan per shape through the kernels and through the
    plain versions: images and masks equal, equalize launched once per slot
    that drew it and the lookup and histogram never; the plan's device
    records (profiler); ms per batch (CUDA events around augment_batch, the
    plan's host read included)."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.data import augment as aug
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    for b, size in ((BATCH, IMG), (DINO_BATCH, DINO_IMG)):
        imgs, masks = disc_batch(np.random.default_rng(size), b, size)
        x = (torch.from_numpy(imgs).to(dev).float() / 255.0)[..., None]
        m = torch.from_numpy(masks).to(dev).float()[..., None]
        plan = aug.sample_plan(torch.Generator(device=dev).manual_seed(size), b)
        slots = int((plan.strong_ids == 2).any(0).sum())
        reset_counts()
        got = aug.apply_plan(plan, x, m, out_size=size, ops=KERNELS)
        torch.cuda.synchronize()
        counts = read_counts()
        want = aug.apply_plan(plan, x, m, out_size=size, ops=PLAIN)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"augmentation at {size} px: the kernel path differs from the plain path")
        require(counts["equalize"] == slots and counts["lut_apply"] == counts["hist256"] == 0,
                f"augmentation at {size} px launched equalize {counts['equalize']}, lut_apply "
                f"{counts['lut_apply']} and hist256 {counts['hist256']} times for {slots} "
                f"equalize slots")
        records, _ = device_records(lambda: aug.apply_plan(plan, x, m, out_size=size))
        gen = torch.Generator(device=dev).manual_seed(1)
        ms = cuda_ms(lambda: aug.augment_batch(gen, x, m, out_size=size), 10)
        plain_ms = cuda_ms(lambda: aug.augment_batch(gen, x, m, out_size=size, ops=PLAIN), 5,
                           warmup=1)
        print(f"augment [{b}, {size}, {size}]: kernel path equals plain path; {slots} equalize "
              f"slots, equalize launches {counts['equalize']} (lookup/histogram "
              f"{counts['lut_apply']}/{counts['hist256']}); {records} device records a plan; "
              f"{ms:.2f} ms per batch (plain path {plain_ms:.2f} ms)")


def slice_phase(dev, work):
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
    from nextgen_uia_tpu_torch.ops import PLAIN
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, make_forward
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
    infer = make_infer(make_forward(cfg, hcfg, train=False), params, dev)
    print(f"slice: built and loaded {len(source)} tensors via the .npz bridge in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    sizes = [BATCH] * (N_BATCHES - 1) + [RAGGED]
    batches = [([f"img{i}_{j}" for j in range(n)],
                rng.integers(0, 256, (n, IMG, IMG), dtype=np.uint8), [True] * n)
               for i, n in enumerate(sizes)]

    reset_counts()
    t0 = time.perf_counter()
    outs = [logits for _, _, logits in iter_padded(iter(batches), BATCH, infer, dev)]
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = read_counts()
    launches = {k: counts[k] for k in ("fused_block_infer", "mona_spatial")}
    depth = cfg.vision.depth
    print(f"slice: served {sum(sizes)} images in {N_BATCHES} batches in {host_s:.2f} s "
          f"(host clock, first batches included); launches {launches}")
    for want_n, out in zip(sizes, outs):
        require(out.shape == (want_n, SEG_CLASSES, IMG, IMG), f"logits shape {out.shape}")
        require(np.isfinite(out).all(), "non-finite logits")
    for name, n in launches.items():
        require(n == depth * N_BATCHES, f"{name} launched {n} times, want {depth * N_BATCHES}")
    require(sum(counts.values()) == sum(launches.values()),
            f"serving launched a train-path kernel: {counts}")

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
    profile_steps(lambda: infer(x), 5, ms)
    return launches, files


def disc_batch(rng, n, size=IMG):
    """Seeded uint8 images [n, size, size] with a brighter disc of seeded
    centre and radius, and its 0/1 mask: foreground the seg loss can see."""
    import numpy as np

    yy, xx = np.mgrid[:size, :size]
    imgs = rng.integers(0, 120, (n, size, size)).astype(np.int32)
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 9, size // 4)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        masks[i][disc] = 1
        imgs[i][disc] += 100
    return imgs.clip(0, 255).astype(np.uint8), masks


TRAIN_LAUNCHES = {  # per train step: see PERF.md (blocks 1-9 backward, MONA 0-9)
    "fused_ln_qkv": 12, "fused_attn_o_residual": 12, "fused_ln_mlp_residual": 12,
    "mona_spatial": 12, "fused_ln_qkv_backward": 9, "fused_attn_o_residual_backward": 9,
    "fused_ln_mlp_residual_backward": 9, "mona_spatial_backward": 10, "fused_block_infer": 0,
    "flash_attention": 0, "fused_mlp": 0}
# the DINOv2 path's (lut_apply and hist256: 0, equalize took both)
NEW_KERNELS = ("flash_attention", "fused_mlp", "lut_apply", "hist256", "equalize")
DINO_LAUNCHES = {"flash_attention": 12, "fused_mlp": 12, "fused_ln_qkv": 0,
                 "fused_attn_o_residual": 0, "fused_ln_mlp_residual": 0, "fused_block_infer": 0}


def launch_counters():
    """name -> the function whose ``launches`` counts that kernel."""
    from nextgen_uia_tpu_torch.ops import dwconv, flash_attention, fused_attention, fused_attn_o
    from nextgen_uia_tpu_torch.ops import fused_block, fused_ln_mlp, fused_ln_qkv, fused_mlp
    from nextgen_uia_tpu_torch.ops import fused_mona, lut

    fns = [fused_block.fused_block_infer, dwconv.mona_spatial, dwconv.mona_spatial_backward,
           fused_ln_qkv.fused_ln_qkv, fused_ln_qkv.fused_ln_qkv_backward,
           fused_attn_o.fused_attn_o_residual, fused_attn_o.fused_attn_o_residual_backward,
           fused_ln_mlp.fused_ln_mlp_residual, fused_ln_mlp.fused_ln_mlp_residual_backward,
           flash_attention.flash_attention, flash_attention.flash_attention_backward,
           fused_mlp.fused_mlp, lut.lut_apply, lut.hist256, lut.equalize_,
           fused_ln_qkv.fused_ln_qkv_rawx,
           fused_attn_o.fused_attn_o_residual_postln, fused_ln_mlp.fused_postnorm_mlp_ln,
           fused_block.fused_block_infer_postnorm, fused_mona.mona_block_fused,
           fused_mona.mona_block_fused_backward, fused_attention.fused_attn_block,
           fused_attention.fused_attn_block_backward, fused_mlp.fused_mlp_backward,
           fused_ln_qkv.fused_ln_qkv_rawx_backward, dwconv.dwconv7_per_sample,
           dwconv.dwconv7_per_sample_backward]
    return {f.__name__.rstrip("_"): f for f in fns}  # equalize_ counts as "equalize"


def reset_counts():
    for f in launch_counters().values():
        f.launches = 0


def read_counts():
    return {name: f.launches for name, f in launch_counters().items()}


def train_phase(dev, files):
    """The supervised train step at full ViT-B/16 width: hybrid MONA in all
    12 blocks, 2-class seg head, batch 32, bf16, AdamW as run_supervised
    sets it. Checks the launch counts of one step, the first step's loss and
    trainable gradients against the plain path on the card, and that the
    loss falls over 10 steps on one fixed batch; times the step."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.data.augment import augment_batch, sample_plan
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, make_forward
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    args = base_parser("chip_smoke").parse_args([
        "--mona_variant", "hybrid", "--num_classes", str(SEG_CLASSES), "--img_size", str(IMG),
        "--backbone_ckpt", files["backbone"], "--mona_weights", files["mona"],
        "--head_weights", files["head"]])
    cfg, hcfg, params = _build_supervised(args, "biomedclip", "seg",
                                          torch.Generator().manual_seed(1))
    trainable, frozen = partition(params, by_keywords("head", "mona", "lora"))
    params.to(dev)
    forward = make_forward(cfg, hcfg, train=True)
    imgs, masks = disc_batch(np.random.default_rng(1), BATCH)
    batch = {"image": torch.from_numpy(imgs).to(dev)[None],
             "mask": torch.from_numpy(masks).to(dev)[None]}
    print(f"train: {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values), {len(frozen)} frozen; "
          f"foreground {masks.mean():.3f} of the pixels")

    def loss_fn(ops):
        def fn(mb, gen):
            logits, m = forward(params, mb["image"], mb["mask"], gen, ops=ops)
            return dice_ce_loss(logits, m)
        return fn

    def grads(ops):
        for p in trainable.values():
            p.grad = None
        loss = loss_fn(ops)({k: v[0] for k, v in batch.items()},
                            torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        # blocks past the last tap (10-11) get no gradient: zeros, as in JAX
        out = {k: torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
               for k, p in trainable.items()}
        for p in trainable.values():
            p.grad = None
        return loss.item(), out

    reset_counts()
    loss_k, g_k = grads(KERNELS)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"train: one step's launches {launches}")
    for name, want in TRAIN_LAUNCHES.items():
        require(launches[name] == want, f"{name} launched {launches[name]} times in a train "
                                        f"step, want {want}")
    loss_p, g_p = grads(PLAIN)
    norm_k, norm_p, rel_l2 = bf16_gradient_gap(g_k, g_p)
    # in bf16 the two paths differ by rounding alone by a few % of the
    # largest gradient, so in bf16 the whole gradient's norm is held to the
    # plain path's, and each tensor to the plain path in the same step in
    # float32
    forward = make_forward(cfg.replace(compute_dtype="float32"), hcfg, train=True)
    loss32_k, g32_k = grads(KERNELS)
    loss32_p, g32_p = grads(PLAIN)
    forward = make_forward(cfg, hcfg, train=True)
    worst, worst_name = worst_ratio(g32_k, g32_p, lambda k: False)
    print(f"train: first-step loss kernel {loss_k:.6f} plain {loss_p:.6f}, gradient norm "
          f"{norm_k:.6f} / {norm_p:.6f} (relative L2 distance {rel_l2:.3e}); float32: loss "
          f"{loss32_k:.7f} / {loss32_p:.7f}, trainable gradients worst max|d| / min(1e-4 "
          f"max|ref| of all, 3e-2 its own max|ref|) = {worst:.3f} ({worst_name})")
    require(np.isfinite(loss_k), "non-finite train loss")
    require(abs(loss_k - loss_p) <= BF16_BOUND * max(1.0, abs(loss_p)),
            "train loss disagrees with the plain path")
    require(abs(norm_k - norm_p) <= BF16_BOUND * norm_p,
            "the bf16 train gradient norm disagrees with the plain path")
    require(abs(loss32_k - loss32_p) <= F32_BOUND * abs(loss32_p),
            "the float32 train loss disagrees with the plain path")
    require(worst <= 1.0, f"the float32 gradient of {worst_name} disagrees with the plain path")

    tcfg = T.TrainConfig(lr=1e-4, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                         total_updates=25)
    opt = T.make_optimizer(trainable.values(), tcfg)
    step = T.TrainStep(loss_fn(KERNELS), opt, tcfg)
    gen = torch.Generator(device=dev).manual_seed(123)
    losses = [step(batch, gen)["loss"] for _ in range(10)]
    print("train: losses over 10 steps on one batch " + " ".join(f"{v:.4f}" for v in losses))
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "the train loss did not fall")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch, gen), 10, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_step = T.TrainStep(loss_fn(PLAIN), opt, tcfg)
    plain_ms = cuda_ms(lambda: plain_step(batch, gen), 3, warmup=1)
    print(f"train: batch {BATCH} step {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s (plain path "
          f"{plain_ms:.2f} ms = {BATCH * 1000 / plain_ms:.1f} img/s); peak device memory "
          f"{peak_gb:.2f} GB")
    profile_steps(lambda: step(batch, gen), 3, ms)

    # the same step with the trainer's default strong+weak augmentation
    forward_aug = make_forward(cfg, hcfg, train=True, strong=True, weak=True)

    def aug_loss(mb, gen_):
        logits, m = forward_aug(params, mb["image"], mb["mask"], gen_)
        return dice_ce_loss(logits, m)

    aug_step = T.TrainStep(aug_loss, opt, tcfg)
    # the plan the step draws first from gen (augment_batch, before any dropout)
    twin = torch.Generator(device=dev)
    twin.set_state(gen.get_state())
    eq_slots = int((sample_plan(twin, BATCH).strong_ids == 2).any(0).sum())
    reset_counts()
    aug_loss_value = aug_step(batch, gen)["loss"]
    torch.cuda.synchronize()
    aug_counts = read_counts()
    require(np.isfinite(aug_loss_value), "non-finite augmented train loss")
    want_aug = {**TRAIN_LAUNCHES, "equalize": eq_slots, "lut_apply": 0, "hist256": 0}
    for name, want in want_aug.items():
        require(aug_counts[name] == want, f"{name} launched {aug_counts[name]} times in an "
                                          f"augmented train step, want {want}")
    aug_ms = cuda_ms(lambda: aug_step(batch, gen), 10, warmup=1)
    x01 = (batch["image"][0].float() / 255.0)[..., None]
    m01 = batch["mask"][0].float()[..., None]
    alone_ms = cuda_ms(lambda: augment_batch(gen, x01, m01, out_size=IMG), 10)
    print(f"train: batch {BATCH} step with augmentation on {aug_ms:.2f} ms = "
          f"{BATCH * 1000 / aug_ms:.1f} img/s (off: {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s; "
          f"augment_batch alone {alone_ms:.2f} ms); one step's launches {aug_counts}")
    profile_steps(lambda: aug_step(batch, gen), 3, aug_ms)
    return launches


def dino_phase(dev):
    """The DINOv2 seg step at ViT-B/14, 518 px, batch 24: UNet decoder, 2
    classes, strong+weak augmentation, bf16 encoder, float32 head, AdamW as
    run_supervised sets it. LayerScale is drawn from U[0.5, 1.5] (the init's
    1e-5 would hide any attention or MLP error). Checks one step's launches
    (K7 and K10 12 each, K5 0, equalize once per slot that drew it, the
    lookup and histogram 0), the first step's loss and every head gradient against
    the plain path, that the BatchNorm running statistics moved and that
    the loss falls over 10 steps on one batch; times the step and the eval
    forward. Returns the step's launch counts."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.data.augment import sample_plan
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks import other_tasks as OT
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    p = base_parser("chip_smoke_dino", batch_size=DINO_BATCH, strong_augs=True, weak_augs=True)
    OT.add_dino_flags(p, seg=True)
    args = p.parse_args(["--num_classes", str(SEG_CLASSES)])
    require(args.img_size == DINO_IMG and args.compute_dtype == "bfloat16"
            and args.decoder_type == "unet" and args.head_dtype == "float32",
            f"dino defaults changed: {args}")
    cpu_gen = torch.Generator().manual_seed(3)
    bundle = OT.build_dino_seg_bundle(args, cpu_gen)
    params, bn = bundle.params, bundle.bn_state
    with torch.no_grad():
        for blk in params["encoder"].blocks:
            blk.ls1.uniform_(0.5, 1.5, generator=cpu_gen)
            blk.ls2.uniform_(0.5, 1.5, generator=cpu_gen)
    trainable, frozen = partition(params, by_keywords("head"))
    params.to(dev)
    bn.to(dev)
    imgs, masks = disc_batch(np.random.default_rng(4), DINO_BATCH, DINO_IMG)
    batch = {"image": torch.from_numpy(imgs).to(dev)[None],
             "mask": torch.from_numpy(masks).to(dev)[None]}
    print(f"dino: {len(trainable)} trainable tensors "
          f"({sum(t.numel() for t in trainable.values())} values), {len(frozen)} frozen")

    def loss_fn(ops):
        def fn(mb, gen):
            logits, m = bundle.forward_train(params, mb, gen, ops=ops)
            return dice_ce_loss(logits, m)
        return fn

    def grads(ops):
        for t in trainable.values():
            t.grad = None
        loss = loss_fn(ops)({k: v[0] for k, v in batch.items()},
                            torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        out = {k: t.grad.float().clone() for k, t in trainable.items()}
        for t in trainable.values():
            t.grad = None
        return loss.item(), out

    # the plan the step draws first from its generator (nothing draws before it)
    plan = sample_plan(torch.Generator(device=dev).manual_seed(7), DINO_BATCH)
    eq_slots = int((plan.strong_ids == 2).any(0).sum())
    bn_before = {k: v.clone() for k, v in bn.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss_k, g_k = grads(KERNELS)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_k = torch.cuda.max_memory_allocated() / 1e9
    print(f"dino: one step's launches {launches} ({eq_slots} slots drew equalize)")
    want = {**DINO_LAUNCHES, "equalize": eq_slots, "lut_apply": 0, "hist256": 0}
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times in a dino step, "
                                     f"want {n}")
    moved = max((bn.state_dict()[k] - v).abs().max().item() for k, v in bn_before.items())
    require(moved > 0, "the BatchNorm running statistics did not move")
    torch.cuda.reset_peak_memory_stats()
    loss_p, g_p = grads(PLAIN)
    peak_p = torch.cuda.max_memory_allocated() / 1e9
    norm_k, norm_p, rel_l2 = bf16_gradient_gap(g_k, g_p)
    # each head tensor held to the plain path in the same step with a
    # float32 encoder (the same weights; bf16 rounding alone moves the
    # gradients by a few % of the largest)
    args32 = p.parse_args(["--num_classes", str(SEG_CLASSES), "--compute_dtype", "float32"])
    bundle32 = OT.build_dino_seg_bundle(args32, torch.Generator().manual_seed(3))
    bundle32.params.load_state_dict(params.state_dict())
    bundle32.params.to(dev)
    bundle32.bn_state.to(dev)
    fp32 = bundle32.params
    train32, _ = partition(fp32, by_keywords("head"))

    def grads32(ops):
        for t in train32.values():
            t.grad = None
        logits, m = bundle32.forward_train(fp32, {k: v[0] for k, v in batch.items()},
                                           torch.Generator(device=dev).manual_seed(7), ops=ops)
        loss = dice_ce_loss(logits, m)
        loss.backward()
        return loss.item(), {k: t.grad.float().clone() for k, t in train32.items()}

    loss32_k, g32_k = grads32(KERNELS)
    loss32_p, g32_p = grads32(PLAIN)
    del bundle32, fp32, train32
    # a bias that feeds a train-mode BatchNorm has an exact gradient of zero
    # (the batch mean removes it): rounding noise, held only to 1e-4 * the
    # largest max|ref|
    worst, worst_name = worst_ratio(g32_k, g32_p,
                                    lambda k: k.endswith(("/conv/b", "/skip_conv/b")))
    print(f"dino: first-step loss kernel {loss_k:.6f} plain {loss_p:.6f}, head gradient "
          f"norm {norm_k:.6f} / {norm_p:.6f} (relative L2 distance {rel_l2:.3e}); float32 "
          f"encoder: loss "
          f"{loss32_k:.7f} / {loss32_p:.7f}, head gradients worst max|d| / min(1e-4 max|ref| "
          f"of all, 3e-2 its own) = {worst:.3f} ({worst_name}); BatchNorm running "
          f"statistics moved by up to {moved:.3e}; peak device memory kernel path "
          f"{peak_k:.2f} GB, plain path {peak_p:.2f} GB")
    require(np.isfinite(loss_k), "non-finite dino loss")
    require(abs(loss_k - loss_p) <= BF16_BOUND * max(1.0, abs(loss_p)),
            "dino loss disagrees with the plain path")
    require(abs(norm_k - norm_p) <= BF16_BOUND * norm_p,
            "the bf16 dino head gradient norm disagrees with the plain path")
    require(abs(loss32_k - loss32_p) <= F32_BOUND * abs(loss32_p),
            "the float32 dino loss disagrees with the plain path")
    require(worst <= 1.0, f"the float32 dino gradient of {worst_name} disagrees with the plain "
                          f"path")

    tcfg = T.TrainConfig(lr=1e-3, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                         total_updates=25)
    opt = T.make_optimizer(trainable.values(), tcfg)
    step = T.TrainStep(loss_fn(KERNELS), opt, tcfg)
    gen = torch.Generator(device=dev).manual_seed(123)
    losses = [step(batch, gen)["loss"] for _ in range(10)]
    print("dino: losses over 10 steps on one batch (augmented anew each step) "
          + " ".join(f"{v:.4f}" for v in losses))
    require(all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]),
            "the dino train loss did not fall")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch, gen), 5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_step = T.TrainStep(loss_fn(PLAIN), opt, tcfg)
    plain_ms = cuda_ms(lambda: plain_step(batch, gen), 2, warmup=1)
    # the same step under PyTorch's default backend settings, as the CLI runs
    # it: cuDNN may then use TF32 in the decoder's float32 convolutions
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cli_ms = cuda_ms(lambda: step(batch, gen), 5, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"dino: batch {DINO_BATCH} step with TF32 off {ms:.2f} ms = "
          f"{DINO_BATCH * 1000 / ms:.1f} img/s (plain path {plain_ms:.2f} ms = "
          f"{DINO_BATCH * 1000 / plain_ms:.1f} img/s; cuDNN TF32 on, as the CLI runs, "
          f"{cli_ms:.2f} ms = {DINO_BATCH * 1000 / cli_ms:.1f} img/s); peak device memory "
          f"{peak_gb:.2f} GB")
    profile_steps(lambda: step(batch, gen), 2, ms)

    with torch.inference_mode():
        x = batch["image"][0]
        eval_ms = cuda_ms(lambda: bundle.forward_eval(params, x), 5, warmup=1)
        out = bundle.forward_eval(params, x)
        require(out.shape == (DINO_BATCH, SEG_CLASSES, DINO_IMG, DINO_IMG)
                and bool(torch.isfinite(out).all()), f"dino eval logits {tuple(out.shape)}")
    print(f"dino: eval forward batch {DINO_BATCH} {eval_ms:.2f} ms = "
          f"{DINO_BATCH * 1000 / eval_ms:.1f} img/s")
    return launches


FT_LAUNCHES = {  # per fine-tune update: 12 LoRA blocks x 4 microbatches
    "flash_attention": 48, "flash_attention_backward": 48, "fused_ln_mlp_residual": 48,
    "fused_ln_mlp_residual_backward": 48, "fused_ln_qkv": 0, "fused_attn_o_residual": 0,
    "fused_block_infer": 0}


def synthetic_captions(n, seed):
    """``n`` distinct seeded captions of 5-60 words, some longer than the
    77-token context (truncated with EOT by the tokenizer)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("ultrasound image of a hypoechoic lesion with irregular margins posterior "
             "acoustic shadowing benign malignant breast thyroid liver kidney cyst solid "
             "mass calcification vascularity doppler transverse longitudinal view probe "
             "left right lobe measured mm cm 1 2 3 4 5 -- ; ( ) % \u00b1 !").split()
    return [f"case {i}: " + " ".join(rng.choice(words, rng.integers(5, 61)))
            for i in range(n)]


def finetune_phase(dev):
    """The OpenAI CLIP LoRA contrastive fine-tune at full width (ViT-B/16 at
    224 px with LoRA r=16, alpha 32, dropout 0.1 in all 12 blocks; the
    12-layer causal text tower at width 512; bf16 towers; batch 64,
    accumulation 4, clip 1.0, InfoNCE at 0.07), seeded random weights with
    the LoRA b matrices drawn nonzero. Caches 512 synthetic captions through
    the text tower (K1 with the causal mask, 12 launches per chunk of 256),
    timed and checked against the plain path; one update's launch counts,
    loss and trainable gradients (LoRA a/b, q/k/v/o biases) against the
    plain path; the loss falling over 10 updates on one batch; ms per
    update and img/s; a profiler table. Returns the launch counts."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.data.tokenizer import ClipTokenizer
    from nextgen_uia_tpu_torch.losses import info_nce
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.ops import PLAIN
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model

    args = ft._finetune_parser("openai").parse_args(["--method", "lora", "--seed", "5"])
    require(args.batch_size == FT_BATCH and args.accumulation_steps == FT_ACCUM
            and args.grad_clip == 1.0 and args.compute_dtype == "bfloat16"
            and args.lora_r == 16 and args.lora_alpha == 32 and args.lora_dropout == 0.1
            and (args.weight_decay, args.beta1_adam, args.beta2_adam) == (0.01, 0.9, 0.95),
            f"fine-tune defaults changed: {args}")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    cfg, params = build_clip_model(args, "openai", adapter="lora", gen=gen)
    with torch.no_grad():
        for blk in params.visual.blocks:
            for pair in blk.attn.lora.children():
                pair.b.normal_(0.0, 0.02, generator=gen)
    trainable, frozen = partition(params, ft.lora_trainable_predicate(params))
    params.to(dev)
    print(f"finetune: built OpenAI CLIP (ViT-B/16 + 12-layer text) with LoRA in "
          f"{sum(1 for b in params.visual.blocks if hasattr(b.attn, 'lora'))} blocks in "
          f"{time.perf_counter() - t0:.1f} s; {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values), {len(frozen)} frozen")

    # the text cache: tokenize, then 12 causal K1 launches per chunk of 256
    captions = synthetic_captions(N_CAPTIONS, 5)
    tokenizer = ClipTokenizer()
    t0 = time.perf_counter()
    tokens = tokenizer(captions, 77)
    tok_s = time.perf_counter() - t0
    encode = ft.make_text_encoder(params, cfg, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = ft.cache_text_features(encode, lambda texts, ctx: tokenizer(texts, ctx), captions,
                                   77, chunk=TEXT_CHUNK)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    text_launches = read_counts()["fused_block_infer"]
    chunks = [tokens[s:s + TEXT_CHUNK] for s in range(0, N_CAPTIONS, TEXT_CHUNK)]
    encode_ms = cuda_ms(lambda: [encode(c) for c in chunks], 5, warmup=1)
    n_chunks = (N_CAPTIONS + TEXT_CHUNK - 1) // TEXT_CHUNK
    feats = torch.from_numpy(np.stack([cache[c] for c in captions]))
    plain = ft.make_text_encoder(params, cfg, dev, ops=PLAIN)(tokens[:TEXT_CHUNK]).cpu()
    err = (feats[:TEXT_CHUNK] - plain).abs().max().item()
    scale = plain.abs().max().item()
    print(f"finetune: text cache of {N_CAPTIONS} captions: tokenized in {tok_s:.2f} s "
          f"({int((tokens != 0).sum(1).max())} tokens at most); cache_text_features (tokenizing "
          f"again, BPE words cached, then encoding) {cache_s:.3f} s (host clock, first call); "
          f"the {n_chunks} chunks of {TEXT_CHUNK} tokens encoded in {encode_ms:.2f} ms (CUDA "
          f"events); K1 causal launches {text_launches}; features vs plain path max|d| "
          f"{err:.3e} (<= {BF16_BOUND * max(1.0, scale):.3e}, max|ref| {scale:.3f})")
    require(feats.shape == (N_CAPTIONS, cfg.text.embed_dim) and bool(torch.isfinite(feats).all()),
            f"text features {tuple(feats.shape)}")
    require(text_launches == cfg.text.depth * n_chunks,
            f"the text cache launched K1 {text_launches} times, want {cfg.text.depth * n_chunks}")
    require(err <= BF16_BOUND * max(1.0, scale), "text features disagree with the plain path")

    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (FT_BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = T.stack_microbatches({"image": torch.from_numpy(images).to(dev),
                                  "txt_feat": feats[:FT_BATCH].to(dev)}, FT_ACCUM)

    def loss_for(ops, c):
        def fn(mb, g):
            img, _ = clip_mod.encode_image(params, c, mb["image"].float() / 255.0, ops=ops,
                                           gen=g)
            return info_nce(img, mb["txt_feat"], temperature=args.temperature)
        return fn

    launches, _, g_k = check_update("finetune", loss_for, cfg, trainable, args, batch, dev,
                                    is_key_bias)
    for name, want in FT_LAUNCHES.items():
        require(launches[name] == want, f"{name} launched {launches[name]} times in a fine-tune "
                                        f"update, want {want}")
    require(min(g.abs().max().item() for k, g in g_k.items() if k.endswith("/a")) > 0,
            "a LoRA a matrix got no gradient")

    train_and_time("finetune", loss_for, cfg, trainable, args, batch, dev)
    with torch.no_grad():
        ecfg = clip_mod.infer_cfg(cfg)
        x = batch["image"][0].float() / 255.0
        eval_ms = cuda_ms(lambda: clip_mod.encode_image(params, ecfg, x), 5, warmup=1)
    print(f"finetune: eval forward of {FT_MICRO} images {eval_ms:.2f} ms")
    return {**launches, "fused_block_infer_causal": text_launches}


BERT_CHAIN = ("fused_ln_qkv_rawx", "fused_attn_o_residual_postln", "fused_postnorm_mlp_ln")


def bf16_gradient_gap(got, ref):
    """bf16 gradients, kernel path against plain path, every tensor
    flattened into one vector: (|got|, |ref|, |got - ref| / |ref|)."""
    import torch

    flat_k, flat_p = (torch.cat([g[k].flatten() for k in ref]) for g in (got, ref))
    norm_p = flat_p.norm().item()
    return flat_k.norm().item(), norm_p, (flat_k - flat_p).norm().item() / norm_p


def worst_ratio(got, ref, own_exempt):
    """Float32 gradients, kernel path against plain path: (worst ratio, its
    name) of max|d| to 1e-4 * the largest max|ref| of all the tensors, and
    to 3e-2 * the tensor's own max|ref| (but for the names ``own_exempt``
    takes, which reach no feature). The first holds the large gradients
    tightly; the second, loose enough for the smallest (differences of
    large terms, which amplify float32 rounding by 1e3 and more), fails a
    tensor that is zeroed (by 33x) or of the wrong sign."""
    top = max(r.abs().max().item() for r in ref.values())
    worst, name = 0.0, None
    for k, r in ref.items():
        diff, own = (got[k] - r).abs().max().item(), r.abs().max().item()
        ratio = diff / (F32_BOUND * top)
        if not own_exempt(k):
            ratio = max(ratio, (diff / (BF16_BOUND * own) if own
                                 else float("inf") if diff else 0.0))
        if ratio > worst:
            worst, name = ratio, k
    return worst, name


def is_key_bias(name):
    """The attention key bias adds q . b_k to every score of a row, which
    the softmax removes: its exact gradient is zero, so both paths give
    rounding noise, held only to 1e-4 * the largest max|ref|."""
    return name.endswith("/attn/k/b")


def make_update(loss_for, ops, cfg, trainable, args, lr):
    """The fine-tune CLI's update around ``loss_for(ops, cfg)``: AdamW with
    the parser's betas and weight decay, FT_ACCUM microbatches, the clip."""
    from nextgen_uia_tpu_torch.core import train as T

    tcfg = T.TrainConfig(lr=lr, lr_min=1e-8, weight_decay=args.weight_decay,
                         beta1=args.beta1_adam, beta2=args.beta2_adam, total_updates=25)
    return T.TrainStep(loss_for(ops, cfg), T.make_optimizer(trainable.values(), tcfg), tcfg,
                       accum_steps=FT_ACCUM, grad_clip=args.grad_clip)


def check_update(tag, loss_for, cfg, trainable, args, batch, dev, own_exempt):
    """One update at lr 0 (the parameters stay) through the kernels, its
    launches counted, against the same update on the plain path. In bf16
    rounding alone moves single gradients by a few % of the largest, so
    there the loss is held to 3e-2 * max(1, |ref|) and the gradient norm to
    3e-2; the same update in float32 holds the loss to 1e-4 and every
    trainable tensor by ``worst_ratio`` (``own_exempt``: the names whose
    exact gradient is zero). Returns (the kernel update's launch counts,
    its metrics, its averaged, clipped gradients)."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    def first_update(ops, c):
        m = make_update(loss_for, ops, c, trainable, args, 0.0)(
            batch, torch.Generator(device=dev).manual_seed(7))
        return m, {k: p.grad.float().clone() for k, p in trainable.items()}

    reset_counts()
    m_k, g_k = first_update(KERNELS, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    m_p, g_p = first_update(PLAIN, cfg)
    rel_l2 = bf16_gradient_gap(g_k, g_p)[2]
    cfg32 = cfg.replace(compute_dtype="float32")
    m32_k, g32_k = first_update(KERNELS, cfg32)
    m32_p, g32_p = first_update(PLAIN, cfg32)
    worst, worst_name = worst_ratio(g32_k, g32_p, own_exempt)
    print(f"{tag}: one update's launches {({k: v for k, v in counts.items() if v})}; loss "
          f"kernel {m_k['loss']:.6f} plain {m_p['loss']:.6f}, gradient norm "
          f"{m_k['grad_norm']:.4f} / {m_p['grad_norm']:.4f} (clipped to {args.grad_clip}; "
          f"relative L2 distance {rel_l2:.3e}); float32: loss {m32_k['loss']:.7f} / "
          f"{m32_p['loss']:.7f}, trainable gradients worst max|d| / min(1e-4 max|ref| of all, "
          f"3e-2 its own) = {worst:.3f} ({worst_name})")
    require(np.isfinite(m_k["loss"]) and m_k["skipped"] == 0, f"{tag} update {m_k}")
    require(abs(m_k["loss"] - m_p["loss"]) <= BF16_BOUND * max(1.0, abs(m_p["loss"]))
            and abs(m_k["grad_norm"] - m_p["grad_norm"]) <= BF16_BOUND * m_p["grad_norm"],
            f"the {tag} loss or gradient norm disagrees with the plain path")
    require(abs(m32_k["loss"] - m32_p["loss"]) <= F32_BOUND * abs(m32_p["loss"]),
            f"the float32 {tag} loss disagrees with the plain path")
    require(worst <= 1.0, f"the float32 {tag} gradient of {worst_name} disagrees with the "
                          f"plain path")
    return counts, m_k, g_k


def train_and_time(tag, loss_for, cfg, trainable, args, batch, dev, same_masks=False):
    """Ten updates at lr 1e-3 on one batch through the kernels, dropout on
    (``same_masks``: the same masks in every update, so that their noise
    does not hide small adapter steps): the loss must fall. Then ms per
    update (CUDA events), img/s and peak memory, the plain path's ms, and
    the profiler's busy share. Returns (the update, its generator)."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    step = make_update(loss_for, KERNELS, cfg, trainable, args, 1e-3)
    gen = torch.Generator(device=dev).manual_seed(123)
    losses = [step(batch, torch.Generator(device=dev).manual_seed(123) if same_masks
                   else gen)["loss"] for _ in range(10)]
    print(f"{tag}: losses over 10 updates on one batch (lr 1e-3, dropout on"
          f"{', the same masks each update' if same_masks else ''}) "
          + " ".join(f"{v:.4f}" for v in losses))
    require(all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"the {tag} loss did not fall")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch, gen), 5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = make_update(loss_for, PLAIN, cfg, trainable, args, 1e-3)
    plain_ms = cuda_ms(lambda: plain(batch, gen), 2, warmup=1)
    print(f"{tag}: batch {FT_BATCH} update ({FT_ACCUM} x {FT_MICRO}) {ms:.2f} ms = "
          f"{FT_BATCH * 1000 / ms:.1f} img/s (plain path {plain_ms:.2f} ms = "
          f"{FT_BATCH * 1000 / plain_ms:.1f} img/s); peak device memory {peak_gb:.2f} GB")
    profile_steps(lambda: step(batch, gen), 2, ms)
    return step, gen


def biomedclip_finetune_phase(dev):
    """The BiomedCLIP MONA contrastive fine-tune at full width: ViT-B/16 at
    224 px with hybrid MONA in all 12 blocks, the frozen 12-layer PubMedBERT
    (width 768, ctx 256, vocabulary 30522), bf16, batch 64 in 4
    microbatches, AdamW (0.9, 0.95), clip 1.0, InfoNCE at 0.07, seeded random
    weights. Caches 512 synthetic captions (the folded CLIP-BPE tokenizer at
    ctx 256) through the three-kernel chain (12 launches of each per chunk
    of 256), then through the whole-layer kernel (opted in), each against
    the plain path; times a full-context chunk of random ids [1, 30000);
    one update with cached text and one with in-step text (trimmed to
    32-token buckets): launch counts derived from the code, the text
    features, loss and gradient norm against the plain path, and the same
    update in float32, its loss and each MONA gradient against the plain
    path's; the loss falling over 10 updates; ms per update, img/s, peak
    memory, a profiler table. Returns the launch counts of the chain's and
    of the whole-layer cache."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.losses import info_nce
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model, get_text_tokenizer

    parser = ft._finetune_parser("biomedclip")
    ref_defaults = parser.parse_args([])
    args = parser.parse_args(["--method", "mona", "--mona_variant", "hybrid", "--seed", "5"])
    require(ref_defaults.epochs == 32 and ref_defaults.mona_variant == "freq_enhanced"
            and args.batch_size == FT_BATCH and args.accumulation_steps == FT_ACCUM
            and args.grad_clip == 1.0 and args.compute_dtype == "bfloat16"
            and (args.beta1_adam, args.beta2_adam) == (0.9, 0.95) and args.temperature == 0.07,
            f"biomedclip fine-tune defaults changed: {args}")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    cfg, params = build_clip_model(args, "biomedclip", adapter="mona", gen=gen)
    tc = cfg.text
    require(cfg.text_kind == "bert" and (tc.depth, tc.width, tc.heads, tc.intermediate,
                                         tc.context_length, tc.vocab_size, tc.ln_eps)
            == (12, 768, 12, 3072, 256, 30522, 1e-12), f"BERT config {tc}")
    trainable, frozen = partition(params, by_keywords("mona"))
    params.to(dev)
    print(f"biomedclip: built ViT-B/16 with hybrid MONA in 12 blocks and the 12-layer "
          f"PubMedBERT in {time.perf_counter() - t0:.1f} s; {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values), {len(frozen)} frozen "
          f"({sum(p.numel() for p in params.text.parameters())} values in the text tower)")

    captions = synthetic_captions(N_CAPTIONS, 7)
    tokenizer = get_text_tokenizer(args, "biomedclip")
    ctx, depth_t = tc.context_length, tc.depth
    t0 = time.perf_counter()
    tokens = tokenizer(captions, ctx)
    tok_s = time.perf_counter() - t0
    n_chunks = -(-N_CAPTIONS // TEXT_CHUNK)
    encode = ft.make_text_encoder(params, cfg, dev)
    plain_encode = ft.make_text_encoder(params, cfg, dev, ops=PLAIN)
    ids = torch.randint(1, 30000, (TEXT_CHUNK, ctx),
                        generator=torch.Generator().manual_seed(9)).to(dev)
    print(f"biomedclip: {N_CAPTIONS} captions tokenized in {tok_s:.2f} s "
          f"({'folded CLIP-BPE fallback' if getattr(tokenizer, 'is_fallback', False) else 'HF'}"
          f" tokenizer; {int((tokens != 0).sum(1).max())} tokens at most)")

    def cache_run(route, kernels):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = ft.cache_text_features(encode, tokenizer, captions, ctx, chunk=TEXT_CHUNK)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        feats = torch.from_numpy(np.stack([cache[c] for c in captions]))
        ref = plain_encode(tokens[:TEXT_CHUNK]).cpu()
        err, scale = (feats[:TEXT_CHUNK] - ref).abs().max().item(), ref.abs().max().item()
        full_ms = cuda_ms(lambda: encode(ids), 5, warmup=1)
        plain_full_ms = cuda_ms(lambda: plain_encode(ids), 2, warmup=1)
        full_err = (encode(ids) - plain_encode(ids)).abs().max().item()
        launched = {k: v for k, v in counts.items() if v}
        print(f"biomedclip: text cache by the {route}: {N_CAPTIONS} captions in {seconds:.3f} s "
              f"(host clock, tokenizing included, first call); launches {launched}; features "
              f"vs plain path max|d| {err:.3e} (<= {BF16_BOUND * max(1.0, scale):.3e}, max|ref| "
              f"{scale:.3f}); a full-context chunk [{TEXT_CHUNK}, {ctx}] of random ids "
              f"{full_ms:.2f} ms = {TEXT_CHUNK * 1000 / full_ms:.0f} captions/s (plain path "
              f"{plain_full_ms:.2f} ms; max|d| {full_err:.3e})")
        require(feats.shape == (N_CAPTIONS, tc.embed_dim) and bool(torch.isfinite(feats).all()),
                f"text features {tuple(feats.shape)}")
        require(launched == {k: depth_t * n_chunks for k in kernels},
                f"the text cache by the {route} launched {launched}, want "
                f"{depth_t * n_chunks} of each of {kernels} and nothing else")
        require(err <= BF16_BOUND * max(1.0, scale) and full_err <= BF16_BOUND * max(1.0, scale),
                f"text features by the {route} disagree with the plain path")
        return counts, feats

    chain_counts, feats = cache_run("three-kernel chain", BERT_CHAIN)
    with environ(NEXTGEN_UIA_FUSED_BLOCK_BERT="1"):
        whole_counts, _ = cache_run("whole-layer kernel (NEXTGEN_UIA_FUSED_BLOCK_BERT=1)",
                                    ("fused_block_infer_postnorm",))

    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (FT_BATCH, IMG, IMG, 3), dtype=np.uint8))
    batch = T.stack_microbatches({"image": images.to(dev), "txt_feat": feats[:FT_BATCH].to(dev)},
                                 FT_ACCUM)
    step_tokens = ft.trim_token_padding(tokens[TEXT_CHUNK:TEXT_CHUNK + FT_BATCH])
    batch_t = T.stack_microbatches({"image": images.to(dev),
                                    "tokens": torch.from_numpy(step_tokens).to(dev)}, FT_ACCUM)

    # the text features each update's microbatches met, in order, by
    # (kernel path?, dtype)
    seen = {}

    def loss_for(text):
        def make(ops, c):
            enc = ft.make_text_encoder(params, c, dev, ops=ops)
            met = seen[ops is KERNELS, c.compute_dtype] = []

            def fn(mb, g):
                img, _ = clip_mod.encode_image(params, c, mb["image"].float() / 255.0, ops=ops,
                                               gen=g)
                txt = mb["txt_feat"] if text == "cached" else enc(mb["tokens"])
                met.append(txt.detach().float())
                return info_nce(img, txt, temperature=args.temperature)
            return fn
        return make

    # per update: every block's forward kernels and MONA once per microbatch;
    # block 0's input needs no gradient, so its three block kernels run no
    # backward, while every MONA (block 0's too) trains
    depth, n_mb = cfg.vision.depth, FT_ACCUM
    # only the CLS token is pooled, so the last block's patch tokens reach
    # no feature: its spatial op's tensors alone get no gradient
    last = f"visual/blocks/{depth - 1}/mona/"

    def reaches_no_feature(k):
        return k.startswith(last) and not k.startswith((last + "down/", last + "up/"))

    want = {"fused_ln_qkv": depth * n_mb, "fused_attn_o_residual": depth * n_mb,
            "fused_ln_mlp_residual": depth * n_mb, "mona_spatial": depth * n_mb,
            "fused_ln_qkv_backward": (depth - 1) * n_mb,
            "fused_attn_o_residual_backward": (depth - 1) * n_mb,
            "fused_ln_mlp_residual_backward": (depth - 1) * n_mb,
            "mona_spatial_backward": depth * n_mb}
    for text, b in (("cached", batch), ("in-step", batch_t)):
        tag = f"biomedclip ({text} text)"
        counts, _, g_k = check_update(tag, loss_for(text), cfg, trainable, args, b, dev,
                                      reaches_no_feature)
        launched = {k: v for k, v in counts.items() if v}
        expect = {**want, **({k: depth_t * n_mb for k in BERT_CHAIN} if text == "in-step" else {})}
        t_k, t_p = (torch.cat(seen[on_kernels, "bfloat16"]) for on_kernels in (True, False))
        t_err, t_scale = (t_k - t_p).abs().max().item(), t_p.abs().max().item()
        print(f"{tag}: text features {tuple(t_k.shape)} vs plain path max|d| {t_err:.3e} (<= "
              f"{BF16_BOUND * max(1.0, t_scale):.3e}, max|ref| {t_scale:.3f})")
        require(launched == expect, f"an update with {text} text launched {launched}, want "
                                    f"{expect}")
        require(t_k.shape == (FT_BATCH, tc.embed_dim) and bool(torch.isfinite(t_k).all())
                and t_err <= BF16_BOUND * max(1.0, t_scale),
                f"the text features of an update with {text} text disagree with the plain path")
        zero = [k for k, g in g_k.items() if g.abs().max().item() == 0]
        require(all(map(reaches_no_feature, zero)), f"MONA tensors with no gradient: {zero}")

    _, gen = train_and_time("biomedclip (cached text)", loss_for("cached"), cfg, trainable,
                            args, batch, dev, same_masks=True)
    step_t = make_update(loss_for("in-step"), KERNELS, cfg, trainable, args, 1e-3)
    torch.cuda.reset_peak_memory_stats()
    in_step_ms = cuda_ms(lambda: step_t(batch_t, gen), 3, warmup=1)
    in_step_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"biomedclip: batch {FT_BATCH} update ({FT_ACCUM} x {FT_MICRO}) with in-step text "
          f"({step_tokens.shape[1]}-token bucket) {in_step_ms:.2f} ms = "
          f"{FT_BATCH * 1000 / in_step_ms:.1f} img/s, peak {in_step_gb:.2f} GB")
    return {**{k: chain_counts[k] for k in BERT_CHAIN},
            "fused_block_infer_postnorm": whole_counts["fused_block_infer_postnorm"]}


def text_lora_launches(depth_v, depth_t, k, n_mb):
    """Kernel launches of one --tune_text_encoder update, LoRA in the first
    k vision blocks and BERT layers, n_mb microbatches. Every forward runs
    once per microbatch and, the LoRA pairs sitting below every block and
    layer above them, every backward too: a LoRA block runs K7 and K8, a
    LoRA layer K7 and K10, a block without LoRA K5 and K6, a layer without
    LoRA the chain (K5 raw-x, K6 post-LN, K9; K6 post-LN's and K9's
    backwards are plain recompositions, counted nowhere)."""
    kv, kt = min(k, depth_v), min(k, depth_t)
    want = {"flash_attention": kv + kt, "flash_attention_backward": kv + kt,
            "fused_ln_mlp_residual": depth_v, "fused_ln_mlp_residual_backward": depth_v,
            "fused_ln_qkv": depth_v - kv, "fused_ln_qkv_backward": depth_v - kv,
            "fused_attn_o_residual": depth_v - kv,
            "fused_attn_o_residual_backward": depth_v - kv,
            "fused_mlp": kt, "fused_mlp_backward": kt,
            **{name: depth_t - kt for name in BERT_CHAIN},
            "fused_ln_qkv_rawx_backward": depth_t - kt}
    return {name: v * n_mb for name, v in want.items() if v}


def text_lora_phase(dev, lora_layers):
    """``--tune_text_encoder`` at full width: BiomedCLIP ViT-B/16 at 224 px
    and PubMedBERT (ctx 256), each cut to its first ``TEXT_LORA_DEPTH`` blocks and
    layers, with LoRA r=16, alpha 32, dropout 0.1 in the first
    ``lora_layers`` blocks and layers of both towers (built through
    build_clip_model as the CLI builds it, the b matrices drawn nonzero),
    bf16, batch 64 as 4 x 16, AdamW (0.9, 0.95), clip 1.0, the
    text of seeded ids (lengths 16-256, padded tail) encoded in the step
    and trimmed to its 32-token bucket. One update's launch counts against
    text_lora_launches; its loss and gradient norm against the plain path
    (bf16), and in float32 the loss and each LoRA and bias gradient; the
    loss falling over 10 updates with dropout on; ms per update, img/s,
    peak memory, the busy share. Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.losses import info_nce
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model

    depth = TEXT_LORA_DEPTH
    tag = f"text LoRA ({lora_layers} of {depth} layers)"
    args = ft._finetune_parser("biomedclip").parse_args(
        ["--method", "lora", "--tune_text_encoder", "--lora_layers", str(lora_layers),
         "--seed", "5"])
    require(args.batch_size == FT_BATCH and args.accumulation_steps == FT_ACCUM
            and args.grad_clip == 1.0 and args.compute_dtype == "bfloat16"
            and (args.lora_r, args.lora_alpha, args.lora_dropout) == (16, 32, 0.1)
            and (args.beta1_adam, args.beta2_adam) == (0.9, 0.95),
            f"biomedclip LoRA fine-tune defaults changed: {args}")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    cfg, params = build_clip_model(args, "biomedclip", adapter="lora", gen=gen)
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, depth=depth),
                      text=dataclasses.replace(cfg.text, depth=depth))
    params.visual.blocks = torch.nn.ModuleList(list(params.visual.blocks)[:depth])
    params.text.layers = torch.nn.ModuleList(list(params.text.layers)[:depth])
    attns = [blk.attn for blk in params.visual.blocks] + [ly.attn for ly in params.text.layers]
    with torch.no_grad():
        for attn in attns:
            for pair in (attn.lora.children() if "lora" in attn._modules else ()):
                pair.b.normal_(0.0, 0.02, generator=gen)
    n_lora = sum("lora" in a._modules for a in attns)
    require(n_lora == 2 * lora_layers, f"LoRA in {n_lora} attentions, want {2 * lora_layers}")
    trainable, frozen = partition(params, ft.lora_trainable_predicate(params))
    params.to(dev)
    print(f"{tag}: built ViT-B/16 and PubMedBERT, {depth} blocks and layers, with LoRA in "
          f"{n_lora} attentions in {time.perf_counter() - t0:.1f} s; {len(trainable)} "
          f"trainable tensors ({sum(p.numel() for p in trainable.values())} values), "
          f"{len(frozen)} frozen")

    rng = np.random.default_rng(8)
    ctx = cfg.text.context_length
    tokens = np.zeros((FT_BATCH, ctx), np.int32)
    for i, n in enumerate(rng.integers(16, ctx + 1, FT_BATCH)):
        tokens[i, :n] = rng.integers(1, 30000, n)
    tokens = ft.trim_token_padding(tokens)
    images = rng.integers(0, 256, (FT_BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = T.stack_microbatches({"image": torch.from_numpy(images).to(dev),
                                  "tokens": torch.from_numpy(tokens).to(dev)}, FT_ACCUM)

    def loss_for(ops, c):
        def fn(mb, g):
            img, _ = clip_mod.encode_image(params, c, mb["image"].float() / 255.0, ops=ops,
                                           gen=g)
            txt = clip_mod.encode_text(params, c, mb["tokens"], ops=ops, gen=g)
            return info_nce(img, txt, temperature=args.temperature)
        return fn

    print(f"{tag}: {tokens.shape[1]}-token bucket")
    counts, _, g_k = check_update(tag, loss_for, cfg, trainable, args, batch, dev, is_key_bias)
    launched = {k: v for k, v in counts.items() if v}
    want = text_lora_launches(cfg.vision.depth, cfg.text.depth, lora_layers, FT_ACCUM)
    require(launched == want, f"a {tag} update launched {launched}, want {want}")
    require(min(g.abs().max().item() for k, g in g_k.items()
                if k.startswith("text/") and k.endswith("/a")) > 0,
            "a text LoRA a matrix got no gradient")
    train_and_time(tag, loss_for, cfg, trainable, args, batch, dev)
    return launched


ZS_FAMILIES = (("biomedclip", "freq_enhanced"), ("openai", "noise_aware"))  # CLI defaults
ZS_BATCHES, N_PAIRS, RET_BATCH = 4, 256, 128  # image batches; retrieval pairs and batch


def held(tag, got, ref, dtype):
    """Fails unless each of got's tensors is within the dtype's bound of ref's,
    the float32 plain path's: bf16 3e-2 * max|ref|, float32 1e-4 * max|ref|;
    prints the worst."""
    bf16 = dtype == "bfloat16"
    errs = [(d, scale) for g, r in zip(got, ref, strict=True) for d, scale in errors(g, r)]
    d, scale = max(errs, key=lambda e: e[0] / e[1])
    limit = (BF16_BOUND if bf16 else F32_BOUND) * scale
    print(f"zero-shot: {tag} {dtype} vs the float32 plain path max|d| {d:.3e} (<= "
          f"{limit:.3e}; max|ref| {scale:.3e}, max|d| / max|ref| {d / scale:.3e})")
    require(d <= limit, f"{tag} {dtype} disagrees with the plain path")


def bf16_logits_held(tag, outs, text, refs):
    """The bf16 logits, held as the function of the held features that they
    are: each within 1e-4 * max|want| of the mean over prompts of 100 * cos
    recomputed in float64 from the run's own image and text features. Their
    distance from the float32 plain path's logits is printed, not held: at
    random weights |cos| is a few hundredths, so bf16's feature error moves
    a logit by several percent of max|logit|."""
    import torch

    from nextgen_uia_tpu_torch.tasks import prompts as PR

    want = [torch.stack([(100.0 * f.double() @ text[c].double().T).mean(dim=1)
                         for c in PR.LESION_TYPES], dim=1) for _, f in outs]
    d, scale = max((x for o, w in zip(outs, want) for x in errors(o[0], w)),
                   key=lambda e: e[0] / e[1])
    print(f"zero-shot: {tag} bfloat16 vs 100 * cos of its own features max|d| {d:.3e} (<= "
          f"{F32_BOUND * scale:.3e}; max|want| {scale:.3e})")
    require(d <= F32_BOUND * scale, f"{tag} bfloat16 are not 100 * cos of their features")
    d, scale = max((x for o, r in zip(outs, refs) for x in errors(o[0], r[0])),
                   key=lambda e: e[0] / e[1])
    print(f"zero-shot: {tag} bfloat16 vs the float32 plain path max|d| {d:.3e} (not held; "
          f"max|ref| {scale:.3e}, max|d| / max|ref| {d / scale:.3e})")


def zero_shot_phase(dev):
    """Zero-shot classification at full width, as zero_shot_main runs it, with
    seeded random weights and each family's CLI default MONA variant in all 12
    blocks (its slots drawn away from their init): BiomedCLIP (timm ViT-B/16
    at 224 px, the 12-layer PubMedBERT at ctx 256) and the OpenAI layout
    (ViT-B/16 with quick_gelu and ln_pre, the 12-layer causal text tower at
    ctx 77, width 512). Per family: the BUSI ensemble's 2 x 10 prompts (text
    launches 12 per class: K1 causal, or K5 raw-x, K6 post-LN and K9), then 4
    batches of 32 seeded uint8 images (K1 and K2 12 per batch); text
    and image features, bf16 and float32, and the float32 logits against
    the float32 plain path on the card (``held``), the bf16 logits against
    100 * cos of their own features (``bf16_logits_held``); img/s at batch
    32 and a
    profiler table. Then retrieval at BiomedCLIP's weights on 256
    synthetic image/caption pairs at batch 128: features held alike, the
    recalls of the kernels' and the plain path's float32 features equal.
    Returns the OpenAI layout's K1 image launches."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import PLAIN
    from nextgen_uia_tpu_torch.tasks import prompts as PR
    from nextgen_uia_tpu_torch.tasks.clip_tasks import (build_text_features,
                                                        make_zero_shot_logits_fn)
    from nextgen_uia_tpu_torch.tasks.common import (base_parser, build_clip_model,
                                                    get_text_tokenizer)

    ensemble = PR.prompt_ensemble_for("BUSI")
    rng = np.random.default_rng(4)
    images = [torch.from_numpy(rng.integers(0, 256, (BATCH, IMG, IMG), dtype=np.uint8)).to(dev)
              for _ in range(ZS_BATCHES)]
    out = {}
    for family, variant in ZS_FAMILIES:
        t0 = time.perf_counter()
        args = base_parser("chip_zero_shot", mona_variant=variant).parse_args(
            ["--device", "cuda", "--seed", "3"])
        gen = torch.Generator().manual_seed(3)
        cfg, params = build_clip_model(args, family, adapter="mona", gen=gen)
        with torch.no_grad():
            for name, t in params.named_parameters():
                if "/mona/" in name.replace(".", "/"):
                    t.add_(0.05 * torch.randn(t.shape, generator=gen))
        params.to(dev)
        tokenizer = get_text_tokenizer(args, family)
        text_names = BERT_CHAIN if cfg.text_kind == "bert" else ("fused_block_infer",)
        print(f"zero-shot: {family} (ViT-B/16 + {cfg.text.depth}-layer "
              f"{cfg.text_kind} text at ctx {cfg.text.context_length}, {variant} MONA) built "
              f"in {time.perf_counter() - t0:.1f} s")

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = build_text_features(params, cfg, tokenizer, ensemble)
        torch.cuda.synchronize()
        text_s = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        want = {k: cfg.text.depth * len(PR.LESION_TYPES) for k in text_names}
        print(f"zero-shot: {family} prompt features of 2 x {len(ensemble['benign'])} prompts in "
              f"{text_s * 1e3:.1f} ms (host clock, first call); launches {counts}")
        require(counts == want, f"{family} text launches {counts}, want {want}")

        fn = make_zero_shot_logits_fn(cfg, text)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(params, x) for x in images]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        want = {"fused_block_infer": cfg.vision.depth * ZS_BATCHES,
                "mona_spatial": cfg.vision.depth * ZS_BATCHES}
        print(f"zero-shot: {family} {ZS_BATCHES} batches of {BATCH} in {wall_s:.2f} s (host "
              f"clock, first batch included); launches {counts}")
        require(counts == want, f"{family} image launches {counts}, want {want}")
        out[family] = counts.get("fused_block_infer", 0)
        for logits, feats in outs:
            require(logits.shape == (BATCH, 2) and feats.shape == (BATCH, cfg.vision.proj_dim)
                    and bool(torch.isfinite(logits).all()), f"{family} logits {logits.shape}")

        # the float32 plain path on the card is the reference of both dtypes
        cfg32 = cfg.replace(compute_dtype="float32")
        ref_text = build_text_features(params, cfg32, tokenizer, ensemble, ops=PLAIN)
        text32 = build_text_features(params, cfg32, tokenizer, ensemble)
        for dtype, feats in (("bfloat16", text), ("float32", text32)):
            held(f"{family} text features", [feats[c] for c in PR.LESION_TYPES],
                 [ref_text[c] for c in PR.LESION_TYPES], dtype)
        refs = [make_zero_shot_logits_fn(cfg32, ref_text)(params, x, PLAIN) for x in images]
        outs32 = [make_zero_shot_logits_fn(cfg32, text32)(params, x) for x in images]
        for dtype, got in (("bfloat16", outs), ("float32", outs32)):
            held(f"{family} image features", [o[1] for o in got], [r[1] for r in refs], dtype)
        held(f"{family} logits", [o[0] for o in outs32], [r[0] for r in refs], "float32")
        bf16_logits_held(f"{family} logits", outs, text, refs)

        ms = cuda_ms(lambda: fn(params, images[0]), 10)
        plain_ms = cuda_ms(lambda: fn(params, images[0], PLAIN), 3, warmup=1)
        print(f"zero-shot: {family} batch {BATCH} forward {ms:.2f} ms = {BATCH * 1000 / ms:.1f} "
              f"img/s (plain path {plain_ms:.2f} ms = {BATCH * 1000 / plain_ms:.1f} img/s)")
        profile_steps(lambda: fn(params, images[0]), 5, ms)
        if family == "biomedclip":
            retrieval_check(dev, params, cfg, tokenizer)
        del params
    return out["openai"]


def retrieval_check(dev, params, cfg, tokenizer):
    """Retrieval features of N_PAIRS seeded images (a brighter disc each)
    and synthetic captions, batch RET_BATCH, through the kernels in bf16 and
    float32, held to the float32 plain path as zero-shot's; the recalls
    (R@1, 2, 5, 10 both ways) and rSum of the float32 kernel and plain
    features equal. MedR and MeanR are printed: at random weights the
    similarities of many pairs lie within float32 rounding of each other."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft

    imgs, _ = disc_batch(np.random.default_rng(8), N_PAIRS, IMG)
    rgb = np.stack([imgs, imgs[:, ::-1], imgs[:, :, ::-1]], axis=-1)
    tokens = tokenizer(synthetic_captions(N_PAIRS, 8), cfg.text.context_length)
    batches = [(torch.from_numpy(np.ascontiguousarray(rgb[s:s + RET_BATCH])).to(dev),
                torch.from_numpy(tokens[s:s + RET_BATCH]).to(dev))
               for s in range(0, N_PAIRS, RET_BATCH)]

    def encode(c, ops):
        fn = ft.make_pair_features(c)
        parts = [fn(params, x, t, ops) for x, t in batches]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = encode(cfg, KERNELS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    n_b = len(batches)
    want = {"fused_block_infer": 12 * n_b, "mona_spatial": 12 * n_b,
            **{k: 12 * n_b for k in BERT_CHAIN}}
    print(f"retrieval: {N_PAIRS} pairs in {n_b} batches of {RET_BATCH} encoded in {wall_s:.2f} s "
          f"(host clock, first call); launches {counts}")
    require(counts == want, f"retrieval launches {counts}, want {want}")
    cfg32 = cfg.replace(compute_dtype="float32")
    got32, ref32 = encode(cfg32, KERNELS), encode(cfg32, PLAIN)
    for dtype, feats in (("bfloat16", got), ("float32", got32)):
        held("retrieval image, text features", feats, ref32, dtype)
    sims = [(i @ t.T).cpu().numpy() for i, t in (got32, ref32)]
    m, m_ref = (ft.retrieval_metrics(s) for s in sims)
    err = np.abs(sims[0] - sims[1]).max()
    # a caption whose similarity to an image lies within err of the true
    # pair's may rank either side of it: MedR and MeanR can move, R@K only
    # if such a tie straddles rank K
    ties = int((np.abs(sims[1] - np.diagonal(sims[1])[:, None]) <= err).sum()) - N_PAIRS
    recalls = [(d, k) for d in ("i2t", "t2i") for k in m[d] if k.startswith("r")]
    print(f"retrieval: float32 rsum {m['rsum']:.4f} (plain path {m_ref['rsum']:.4f}); "
          + ", ".join(f"{d} {k} {m[d][k]:.2f}" for d, k in recalls)
          + f"; MedR/MeanR i2t {m['i2t']['medr']}/{m['i2t']['meanr']:.4f} (plain "
          f"{m_ref['i2t']['medr']}/{m_ref['i2t']['meanr']:.4f}), t2i {m['t2i']['medr']}/"
          f"{m['t2i']['meanr']:.4f} ({m_ref['t2i']['medr']}/{m_ref['t2i']['meanr']:.4f}); sim "
          f"max|d| {err:.3e}, {ties} image-caption pairs within it of their true pair's sim")
    require(m["rsum"] == m_ref["rsum"] and all(m[d][k] == m_ref[d][k] for d, k in recalls),
            "retrieval recalls differ between the kernels and the plain path")


BENCH_ROUTES = (  # (label, ViT attn_impl, NEXTGEN_UIA_FUSED_MONA)
    ("composed", "auto", False), ("fused MONA (K12)", "auto", True),
    ("fused MONA + fused attention block (K11)", "fused_block", True),
    ("fused MONA + hybrid attention block (K7 forward, K11 backward)", "hybrid_block", True))


def bench_launches(depth, attn, fused):
    """Kernel launches of one bench step: every block's forward once, the
    attention and MLP backward in blocks 1.. (block 0's input needs no
    gradient), every MONA's backward (block 0's adapter trains too)."""
    want = {"fused_ln_mlp_residual": depth, "fused_ln_mlp_residual_backward": depth - 1}
    want.update({"auto": {"fused_ln_qkv": depth, "fused_attn_o_residual": depth,
                          "fused_ln_qkv_backward": depth - 1,
                          "fused_attn_o_residual_backward": depth - 1},
                 "fused_block": {"fused_attn_block": depth,
                                 "fused_attn_block_backward": depth - 1},
                 "hybrid_block": {"flash_attention": depth,
                                  "fused_attn_block_backward": depth - 1}}[attn])
    want.update({"mona_block_fused": depth, "mona_block_fused_backward": depth} if fused else
                {"mona_spatial": depth, "mona_spatial_backward": depth})
    return want


def bench_phase(dev):
    """The port's headline step, ``nextgen_uia_tpu_torch.bench`` (the JAX
    bench.py's): BiomedCLIP ViT-B/16 with hybrid MONA in 12 blocks, text
    features cached through the frozen PubMedBERT, AdamW, batch 64 as one
    microbatch, bf16, at full width and depth. Each route of BENCH_ROUTES:
    one step's launch counts, ms per step by CUDA events, img/s, the
    device's busy share (profiler) and peak memory. Then the same step in
    float32, the fused MONA route on the kernels against the composed route
    on the plain path: loss within 1e-4 and every MONA tensor within
    min(1e-4 * the largest max|ref|, 3e-2 * its own). Last, ``bench.main``
    as ``python -m nextgen_uia_tpu_torch.bench`` runs it (10-step windows).
    Returns the K11 and K12 launch counts of their routes' steps."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch import bench
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    knobs = bench.Knobs()
    require((knobs.batch, knobs.img, knobs.dtype, knobs.depth, knobs.text)
            == (64, 224, "bfloat16", 12, False), f"bench defaults changed: {knobs}")
    t0 = time.perf_counter()
    bn = bench.build(dev, knobs)
    depth, vision = bn.cfg.vision.depth, bn.cfg.vision
    print(f"bench: built BiomedCLIP (ViT-B/16 + hybrid MONA in {depth} blocks, the 12-layer "
          f"PubMedBERT) and cached {knobs.batch} text features in "
          f"{time.perf_counter() - t0:.1f} s; {len(bn.trainable)} trainable tensors")
    launches = {}
    for label, attn, fused in BENCH_ROUTES:
        bn.cfg = bn.cfg.replace(vision=dataclasses.replace(vision, attn_impl=attn))
        with environ(NEXTGEN_UIA_FUSED_MONA="1" if fused else "0"):
            step = bn.train_step()
            gen = torch.Generator(device=dev).manual_seed(0)
            step(bn.batch, gen)
            reset_counts()
            metrics = step(bn.batch, gen)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(bn.batch, gen), 10, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 1e9
            seen = set()
            busy = profile_steps(lambda: step(bn.batch, gen), 2, ms, seen)
        want = bench_launches(depth, attn, fused)
        print(f"bench: {label}: batch {knobs.batch} step {ms:.2f} ms = "
              f"{knobs.batch * 1000 / ms:.1f} img/s, device busy {busy:.1f}%, peak device "
              f"memory {peak:.2f} GB, loss {metrics['loss']:.6f}; one step's launches {counts}")
        require(np.isfinite(metrics["loss"]) and metrics["skipped"] == 0,
                f"bench step ({label}) {metrics}")
        require(counts == want, f"a bench step ({label}) launched {counts}, want {want}")
        old = sorted(k[:60] for k in seen if any(o in k for o in OLD_PRODUCTS))
        print(f"bench: {label}: {len(seen)} kernels in the profile, "
              f"{old or 'no WMMA GEMM, colgemm_kernel or mona_down_kernel'}")
        require(not seen or not old, f"the bf16 bench step ({label}) ran {old}")
        launches.update({k: counts[k] for k in ("mona_block_fused", "mona_block_fused_backward",
                                                "fused_attn_block", "fused_attn_block_backward")
                         if k in counts and attn != "hybrid_block"})
    bn.cfg = bn.cfg.replace(vision=vision)

    # float32: the fused route on the kernels against the composed plain path
    b32 = bench.build(dev, dataclasses.replace(knobs, dtype="float32"))

    def grads32(ops, fused):
        with environ(NEXTGEN_UIA_FUSED_MONA="1" if fused else "0"):
            for t in b32.trainable.values():
                t.grad = None
            loss = b32.loss_fn(ops)({k: v[0] for k, v in b32.batch.items()},
                                    torch.Generator(device=dev).manual_seed(7))
            loss.backward()
        return loss.item(), {k: torch.zeros_like(t) if t.grad is None else t.grad.float().clone()
                             for k, t in b32.trainable.items()}

    reset_counts()
    loss_k, g_k = grads32(KERNELS, True)
    fused_counts = read_counts()
    loss_p, g_p = grads32(PLAIN, False)
    del b32
    # only the CLS token is pooled: the last block's spatial op reaches no feature
    last = f"visual/blocks/{depth - 1}/mona/"

    def reaches_no_feature(k):
        return k.startswith(last) and not k.startswith((last + "down/", last + "up/"))

    worst, worst_name = worst_ratio(g_k, g_p, reaches_no_feature)
    zero = [k for k, g in g_k.items() if g.abs().max().item() == 0]
    print(f"bench: float32 step, fused MONA on the kernels ({fused_counts['mona_block_fused']} "
          f"K12 forward, {fused_counts['mona_block_fused_backward']} backward) against the "
          f"composed plain path: loss {loss_k:.7f} / {loss_p:.7f}, MONA gradients worst max|d| "
          f"/ min(1e-4 max|ref| of all, 3e-2 its own) = {worst:.3f} ({worst_name})")
    require(fused_counts["mona_block_fused"] == depth
            and fused_counts["mona_block_fused_backward"] == depth,
            f"the float32 fused step launched {fused_counts}")
    require(abs(loss_k - loss_p) <= F32_BOUND * abs(loss_p),
            "the float32 bench loss (fused MONA) disagrees with the plain path")
    require(worst <= 1.0, f"the float32 bench gradient of {worst_name} (fused MONA) disagrees "
                          f"with the plain path")
    require(all(map(reaches_no_feature, zero)), f"MONA tensors with no gradient: {zero}")

    # the entry point itself, as `python -m nextgen_uia_tpu_torch.bench` runs it
    del bn
    out = io.StringIO()
    with environ(NEXTGEN_UIA_BENCH_STEPS="10", NEXTGEN_UIA_BENCH_WARMUP="2"), \
            contextlib.redirect_stdout(out):
        rec = bench.main()
    lines = out.getvalue().strip().splitlines()
    print(f"bench: nextgen_uia_tpu_torch.bench.main() (10-step windows) printed {lines}")
    require(len(lines) == 1 and set(json.loads(lines[0])) == {"metric", "value", "unit",
                                                              "vs_baseline"}
            and rec["value"] > 0, "the bench did not print its one JSON line")
    return launches


BENCH_MODE_KEYS = {  # each JAX bench mode's JSON keys beyond metric, value, unit, vs_baseline
    "SUPERVISED": {"batch", "augs"}, "EVAL": {"batch"},
    "INPUT": {"host_only_images_per_sec", "decode", "workers", "n_images"}}


def bench_modes_phase(dev):
    """The bench's three other modes at full width and depth (ViT-B/16, 224
    px, 12 blocks, bf16), each through ``bench.main()`` under its
    environment variable with 10-step windows after 2 warm-up steps (the
    input mode: 1024 PNGs, 2 epochs): one JSON line with the JAX mode's
    keys and a positive rate, and the launches of the whole run equal to
    one step's (or batch's) times the steps: the supervised step's
    TRAIN_LAUNCHES and equalize, the zero-shot batch's K1 and K2 12 each,
    the input mode's bench step (warm-up and end-to-end epochs; the
    host-only epochs launch nothing); the supervised mode with augmentation
    on and off (NEXTGEN_UIA_BENCH_AUGS). Before them, from
    ``bench.build_supervised``: one augmented bf16 step's launches exactly
    (equalize once a slot that drew it), and one float32 step with
    augmentation off on the kernels against the plain path (which launches
    nothing): loss within F32_BOUND, head and MONA gradients by
    ``worst_ratio``. Prints each mode's img/s, ms a step, peak memory and the
    input mode's host-only rate and decoder."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch import bench
    from nextgen_uia_tpu_torch.data.augment import sample_plan
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    knobs = bench.Knobs()
    require((knobs.img, knobs.dtype, knobs.depth, knobs.sup_batch, knobs.augs, knobs.images)
            == (224, "bfloat16", 12, 32, True, 1024), f"bench defaults changed: {knobs}")
    step_launches = {k: v for k, v in TRAIN_LAUNCHES.items() if v}

    sb = bench.build_supervised(dev, knobs)
    step = sb.train_step()
    gen = torch.Generator(device=dev).manual_seed(0)
    step(sb.batch, gen)
    twin = torch.Generator(device=dev)  # the plan the next step draws first from gen
    twin.set_state(gen.get_state())
    eq_slots = int((sample_plan(twin, knobs.sup_batch).strong_ids == 2).any(0).sum())
    reset_counts()
    metrics = step(sb.batch, gen)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    want = {**step_launches, **({"equalize": eq_slots} if eq_slots else {})}
    print(f"bench modes: supervised, one augmented bf16 step: loss {metrics['loss']:.6f}, "
          f"launches {counts}")
    require(np.isfinite(metrics["loss"]), f"supervised bench step {metrics}")
    require(counts == want, f"a supervised bench step launched {counts}, want {want}")

    sb.cfg = sb.cfg.replace(compute_dtype="float32")
    mb = {k: v[0] for k, v in sb.batch.items()}

    def loss32(ops):
        for t in sb.trainable.values():
            t.grad = None
        loss = sb.loss_fn(ops, augs=False)(mb, torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        return loss.item(), {k: torch.zeros_like(t) if t.grad is None else t.grad.clone()
                             for k, t in sb.trainable.items()}

    reset_counts()
    loss_k, g_k = loss32(KERNELS)
    counts32 = {k: v for k, v in read_counts().items() if v}
    reset_counts()
    loss_p, g_p = loss32(PLAIN)
    counts_plain = {k: v for k, v in read_counts().items() if v}
    worst, worst_name = worst_ratio(g_k, g_p, lambda k: False)
    del sb, step, g_k, g_p
    print(f"bench modes: supervised, float32 step, augmentation off: loss kernels {loss_k:.7f}, "
          f"plain {loss_p:.7f} (|d| {abs(loss_k - loss_p):.2e}); head and MONA gradients worst "
          f"max|d| / min(1e-4 max|ref| of all, 3e-2 its own max|ref|) = {worst:.3f} "
          f"({worst_name}); launches {counts32}, plain path {counts_plain}")
    require(counts32 == step_launches, f"the float32 supervised step launched {counts32}")
    require(not counts_plain, f"the plain float32 supervised step launched {counts_plain}")
    require(abs(loss_k - loss_p) <= F32_BOUND * abs(loss_p),
            "the float32 supervised bench loss disagrees with the plain path")
    require(worst <= 1.0, f"the float32 supervised gradient of {worst_name} disagrees with the "
                          "plain path")

    n_steps = 2 + 2 * 10
    e2e = 1 + bench.INPUT_EPOCHS * (knobs.images // knobs.batch)
    runs = (("SUPERVISED", "1", step_launches, n_steps, knobs.sup_batch),
            ("SUPERVISED", "0", step_launches, n_steps, knobs.sup_batch),
            ("EVAL", "1", {"fused_block_infer": 12, "mona_spatial": 12}, n_steps,
             knobs.eval_batch),
            ("INPUT", "1", bench_launches(12, "auto", False), e2e, knobs.batch))
    for mode, augs, launches, steps, batch in runs:
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with environ(NEXTGEN_UIA_BENCH_STEPS="10", NEXTGEN_UIA_BENCH_WARMUP="2",
                     NEXTGEN_UIA_BENCH_AUGS=augs, **{f"NEXTGEN_UIA_BENCH_{mode}": "1"}), \
                contextlib.redirect_stdout(out):
            rec = bench.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        lines = out.getvalue().strip().splitlines()
        print(f"bench modes: {mode}: {lines}")
        require(len(lines) == 1 and set(json.loads(lines[0])) == {
            "metric", "value", "unit", "vs_baseline"} | BENCH_MODE_KEYS[mode]
            and rec["value"] > 0 and rec.get("augs", augs == "1") == (augs == "1"),
            f"the {mode} bench did not print its one JSON line")
        want = {k: v * steps for k, v in launches.items()}
        if mode == "SUPERVISED":  # the slots that drew equalize vary by step
            eq = counts.pop("equalize", 0)
            require((eq > 0) == (augs == "1"), f"{eq} equalize launches, augmentation {augs}")
            mode = f"{mode} (augmentation {'on' if augs == '1' else 'off'})"
        require(counts == want, f"the {mode} bench launched {counts}, want {want} "
                                f"({steps} steps)")
        extra = (f", host only {rec['host_only_images_per_sec']:.2f} img/s, decoder "
                 f"{rec['decode']}, {rec['workers']} workers" if mode == "INPUT" else "")
        print(f"bench modes: {mode}: {rec['value']:.2f} img/s = {batch * 1000 / rec['value']:.2f} "
              f"ms a step at batch {batch}{extra}; peak device memory {peak:.2f} GB; "
              f"{seconds:.1f} s in bench.main()")


def profile_steps(fn, steps, step_ms, seen=None):
    """torch.profiler over ``steps`` calls: device time per call by kernel
    (top 14) and in all, and the share of ``step_ms`` (the call's time
    without the profiler) that the card was busy (kernel times summed,
    returned in %); the host time per call blocked on the device and inside
    the 'augment' range (tasks/supervised.py::preprocess). The kernels'
    names go into the set ``seen`` if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue  # CPU ops and annotated ranges span the kernels they launch
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    if seen is not None:
        seen.update(r[2] for r in rows)
    total = sum(r[0] for r in rows)
    # the host blocked on the device: .item(), .cpu() and explicit syncs
    waits = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU and "Synchronize" in e.key]
    wait_ms = sum(e.cpu_time_total for e in waits) / 1e3 / steps
    aug_ms = sum(e.cpu_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key == "augment") / 1e3 / steps
    print(f"profile: kernels {total:.2f} ms of device time per step; busy "
          f"{100 * total / step_ms:.1f}% of the {step_ms:.2f} ms step (host clock under the "
          f"profiler {host_ms:.2f} ms; host blocked in {sum(e.count for e in waits) // steps} "
          f"cuda*Synchronize calls {wait_ms:.2f} ms; in the augment range {aug_ms:.2f} ms)")
    for ms_, count, key in rows[:14]:
        print(f"profile:   {ms_:8.3f} ms {100 * ms_ / max(total, 1e-9):5.1f}%  x{count:<4d} "
              f"{key[:90]}")
    # where the host's time goes: the operators with the most self CPU time
    cpu = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count // steps, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    print("profile: host self time per step: " + "; ".join(
        f"{key[:40]} {ms_:.2f} ms x{count}" for ms_, count, key in cpu[:8]))
    return 100 * total / step_ms


def cli_phase(dev, work, files):
    """The trainer CLIs on a synthetic dataset in the reference layout, at
    their default strong+weak augmentation: BiomedCLIP seg (224 px, batch
    32, 2 updates) and DINOv2 seg (518 px, batch 24, 2 updates), each
    followed by its predict CLI on its best_model.npz, then the BiomedCLIP
    and DINOv2 classification CLIs (one epoch each)."""
    import csv
    import glob

    import numpy as np
    from PIL import Image

    from nextgen_uia_tpu_torch.tasks.biomedclip import classification, predict, segmentation
    from nextgen_uia_tpu_torch.tasks.dino import classification as dino_classification
    from nextgen_uia_tpu_torch.tasks.dino import predict as dino_predict
    from nextgen_uia_tpu_torch.tasks.dino import segmentation as dino_segmentation

    data = os.path.join(work, "data")
    split_dir = os.path.join(data, "classification", "SYNTH")
    for sub in ("all/images", "all/masks", "classification/SYNTH"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    imgs, masks = disc_batch(np.random.default_rng(2), 80)
    names = [f"img_{i:03d}.png" for i in range(80)]
    for name, img, mask in zip(names, imgs, masks):
        Image.fromarray(img).save(os.path.join(data, "all", "images", name))
        Image.fromarray(mask * 255).save(os.path.join(data, "all", "masks", name))
    for split, part in (("train", names[:64]), ("val", names[64:72]), ("test", names[72:])):
        with open(os.path.join(split_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(part))
    with open(os.path.join(split_dir, "labels.csv"), "w") as f:  # large disc: class 1
        f.write("\n".join(f"{n},{int(m.mean() > 0.1)}" for n, m in zip(names, masks)))

    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        stats = segmentation.main([
            "--dataset", "SYNTH", "--data_root", data, "--exp", "chip_cli", "--epochs", "1",
            "--val_interval", "1", "--img_size", str(IMG), "--batch_size", str(BATCH),
            "--num_workers", "4", "--device", "cuda", "--mona_variant", "hybrid", "--backbone_ckpt", files["backbone"],
            "--mona_weights", files["mona"], "--head_weights", files["head"]])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        run = os.path.join(work, "runs", "chip_cli", "SYNTH", "train")
        best = os.path.join(run, "best_model.npz")
        results = glob.glob(os.path.join(run, "*_iou=*", "results.csv"))
        print(f"cli: trained 2 augmented updates + val/test evaluation in {seconds:.1f} s (host "
              f"clock, data decode included); dice_mean {stats['dice_mean']:.4f}; launches {counts}")
        require(np.isfinite(stats["loss"]) and np.isfinite(stats["dice_mean"]),
                f"trainer CLI stats {stats}")
        require(counts["fused_ln_qkv_backward"] == 2 * 9 and counts["mona_spatial_backward"]
                == 2 * 10, "the trainer CLI did not train through the backward kernels")
        require(counts["fused_block_infer"] > 0, "the trainer CLI did not evaluate through K1")
        require(os.path.exists(best) and results, "best_model.npz or results.csv missing")
        listing = os.path.join(work, "predict.txt")
        with open(listing, "w") as f:
            f.write("\n".join(os.path.join(data, "all", "images", n) for n in names[72:]))
        out = predict.main([
            "--task", "seg", "--images", listing, "--img_size", str(IMG), "--batch_size",
            str(BATCH), "--num_workers", "4", "--device", "cuda", "--mona_variant", "hybrid",
            "--backbone_ckpt", files["backbone"], "--mona_weights", best, "--head_weights",
            best, "--out", os.path.join(work, "predict_out")])["out"]
        with open(os.path.join(out, "index.csv")) as f:
            rows = list(csv.DictReader(f))
        require(len(rows) == 8 and all(r["status"] == "ok" for r in rows),
                "predict CLI on best_model.npz failed")
        print(f"cli: predict loaded best_model.npz as --head_weights and --mona_weights and "
              f"wrote {len(rows)} masks")

        reset_counts()
        t0 = time.perf_counter()
        stats = dino_segmentation.main([
            "--dataset", "SYNTH", "--data_root", data, "--exp", "chip_dino", "--epochs", "1",
            "--val_interval", "1", "--num_workers", "4", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        best = os.path.join(work, "runs", "chip_dino", "SYNTH", "train", "best_model.npz")
        print(f"cli: dino seg trained 2 augmented updates at {DINO_IMG} px + val/test "
              f"evaluation in {seconds:.1f} s (host clock, data decode included); dice_mean "
              f"{stats['dice_mean']:.4f}; launches {counts}")
        require(np.isfinite(stats["loss"]) and np.isfinite(stats["dice_mean"]),
                f"dino trainer CLI stats {stats}")
        require(counts["flash_attention"] > 0 and counts["fused_mlp"] > 0
                and counts["fused_ln_qkv"] == 0, "the dino CLI did not run through K7 and K10")
        require(os.path.exists(best), "dino best_model.npz missing")
        out = dino_predict.main([
            "--task", "seg", "--images", listing, "--batch_size", str(DINO_BATCH),
            "--num_workers", "4", "--device", "cuda", "--head_weights", best,
            "--out", os.path.join(work, "dino_predict_out")])["out"]
        with open(os.path.join(out, "index.csv")) as f:
            rows = list(csv.DictReader(f))
        require(len(rows) == 8 and all(r["status"] == "ok" for r in rows),
                "dino predict CLI on best_model.npz failed")
        print(f"cli: dino predict loaded best_model.npz (head and BatchNorm statistics) and "
              f"wrote {len(rows)} masks")

        for name, fn, argv in (
                ("biomedclip cls", classification.main,
                 ["--img_size", str(IMG), "--batch_size", str(BATCH), "--mona_variant", "hybrid",
                  "--backbone_ckpt", files["backbone"], "--mona_weights", files["mona"]]),
                ("dino cls", dino_classification.main, [])):
            reset_counts()
            t0 = time.perf_counter()
            stats = fn(["--dataset", "SYNTH", "--data_root", data, "--exp",
                        f"chip_{name.replace(' ', '_')}",
                        "--epochs", "1", "--val_interval", "1", "--num_workers", "4",
                        "--device", "cuda", *argv])
            counts = {k: v for k, v in read_counts().items() if v}
            print(f"cli: {name} trained one augmented epoch + val/test evaluation in "
                  f"{time.perf_counter() - t0:.1f} s; acc {stats['acc']:.4f}; launches {counts}")
            require(np.isfinite(stats["loss"]) and np.isfinite(stats["acc"]),
                    f"{name} CLI stats {stats}")
            want = ("fused_ln_qkv_backward", "fused_block_infer") if name == "biomedclip cls" \
                else ("flash_attention", "fused_mlp")
            require(all(counts.get(k, 0) > 0 for k in want),
                    f"the {name} CLI did not run through {want}")
    finally:
        os.chdir(cwd)


def caption_data(work):
    """160 seeded 224 px images with synthetic captions in the MedPix/PMC-CURD
    CSV layout under ``work``/ft (written once): 144 train pairs, 2 updates
    at batch 64; 16 val."""
    import csv

    import numpy as np
    from PIL import Image

    data = os.path.join(work, "ft")
    if os.path.exists(os.path.join(data, "captions.csv")):
        return data
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    rng = np.random.default_rng(6)
    captions = synthetic_captions(160, 6)
    with open(os.path.join(data, "captions.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "Caption"])
        for i, caption in enumerate(captions):
            name = f"ft_{i:03d}.png"
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)).save(
                os.path.join(data, "images", name))
            w.writerow([name, caption])
    return data


def finetune_cli_phase(work):
    """``python -m nextgen_uia_tpu_torch.tasks.clip.finetune --method lora
    --epochs 1`` on the card, on 160 seeded 224 px images with synthetic
    captions in the MedPix/PMC-CURD CSV layout (144 train: 2 updates at
    batch 64; 16 val): its best_model.npz holds only the LoRA tensors."""
    import numpy as np

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks.clip.finetune import main as finetune_main

    data = caption_data(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = finetune_main(["--method", "lora", "--epochs", "1", "--exp", "chip_ft",
                             "--finetune_csvs", os.path.join(data, "captions.csv"),
                             "--finetune_img_dirs", os.path.join(data, "images"),
                             "--num_workers", "4", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
    finally:
        os.chdir(cwd)
    best = os.path.join(work, "runs", "chip_ft", "best_model.npz")
    keys = ckpt.peek_keys(best) if os.path.exists(best) else []
    print(f"cli: openai LoRA fine-tune, one epoch (2 updates + validation) in {seconds:.1f} s "
          f"(host clock: build, text cache and data decode included); best val loss "
          f"{out['best_val_loss']:.4f}; best_model.npz {len(keys)} tensors; launches {counts}")
    require(np.isfinite(out["best_val_loss"]), f"fine-tune CLI result {out}")
    require(len(keys) == 12 * 4 * 2 and all("/attn/lora/" in k for k in keys),
            "best_model.npz does not hold exactly the LoRA tensors")
    require(counts.get("flash_attention_backward", 0) == 2 * FT_LAUNCHES["flash_attention_backward"]
            and counts.get("fused_block_infer", 0) == 12,
            "the fine-tune CLI did not run through K7 backward and K1 causal")


def biomedclip_finetune_cli_phase(work):
    """``python -m nextgen_uia_tpu_torch.tasks.biomedclip.finetune --method
    mona --mona_variant hybrid --epochs 1`` on the card, with
    NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1 (no HF tokenizer files), on the
    seeded caption data: its best_model.npz holds the MONA tensors of all 12
    blocks and nothing else; the captions were cached through BERT's chain
    and the updates ran the backward kernels."""
    import numpy as np

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks.biomedclip.finetune import main as finetune_main

    data = caption_data(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with environ(NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK="1"):
            reset_counts()
            t0 = time.perf_counter()
            out = finetune_main(["--method", "mona", "--mona_variant", "hybrid", "--epochs",
                                 "1", "--exp", "chip_bm_ft",
                                 "--finetune_csvs", os.path.join(data, "captions.csv"),
                                 "--finetune_img_dirs", os.path.join(data, "images"),
                                 "--num_workers", "4", "--device", "cuda"])
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
    finally:
        os.chdir(cwd)
    best = os.path.join(work, "runs", "chip_bm_ft", "best_model.npz")
    keys = ckpt.peek_keys(best) if os.path.exists(best) else []
    blocks = {k.split("/")[2] for k in keys if k.startswith("visual/blocks/")}
    print(f"cli: biomedclip MONA fine-tune, one epoch (2 updates + validation) in {seconds:.1f} s "
          f"(host clock: build, text cache and data decode included); best val loss "
          f"{out['best_val_loss']:.4f}; best_model.npz {len(keys)} tensors in {len(blocks)} "
          f"blocks; launches {counts}")
    require(np.isfinite(out["best_val_loss"]), f"biomedclip fine-tune CLI result {out}")
    require(keys and all("/mona/" in k for k in keys) and len(blocks) == 12,
            "best_model.npz does not hold exactly the MONA tensors of the 12 blocks")
    require(all(counts.get(k, 0) == 12 for k in BERT_CHAIN)
            and counts.get("fused_ln_qkv_backward", 0) == 2 * 11 * FT_ACCUM
            and counts.get("mona_spatial_backward", 0) == 2 * 12 * FT_ACCUM,
            "the biomedclip fine-tune CLI did not cache its captions through BERT's chain "
            "or did not train through the backward kernels")


def text_lora_cli_phase(work):
    """``python -m nextgen_uia_tpu_torch.tasks.biomedclip.finetune --method
    lora --tune_text_encoder --lora_layers 6 --epochs 1`` on the card, with
    NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1, on the seeded caption data: the
    text uncached, K10's and K5 raw-x's backward kernels launched in each
    of the 2 updates (24 each), best_model.npz holding exactly the LoRA
    tensors of vision blocks 0-5 and text layers 0-5."""
    import numpy as np

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks.biomedclip.finetune import main as finetune_main

    data = caption_data(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with environ(NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK="1"):
            reset_counts()
            t0 = time.perf_counter()
            out = finetune_main(["--method", "lora", "--tune_text_encoder", "--lora_layers",
                                 "6", "--epochs", "1", "--exp", "chip_tt_ft",
                                 "--finetune_csvs", os.path.join(data, "captions.csv"),
                                 "--finetune_img_dirs", os.path.join(data, "images"),
                                 "--num_workers", "4", "--device", "cuda"])
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
    finally:
        os.chdir(cwd)
    best = os.path.join(work, "runs", "chip_tt_ft", "best_model.npz")
    keys = ckpt.peek_keys(best) if os.path.exists(best) else []
    attns = sorted({k.rsplit("/lora/", 1)[0] for k in keys})
    print(f"cli: biomedclip LoRA fine-tune with --tune_text_encoder --lora_layers 6, one epoch "
          f"(2 updates + validation) in {seconds:.1f} s (host clock: build and data decode "
          f"included); best val loss {out['best_val_loss']:.4f}; best_model.npz {len(keys)} "
          f"tensors in {len(attns)} attentions; launches {counts}")
    require(np.isfinite(out["best_val_loss"]), f"text LoRA fine-tune CLI result {out}")
    require(len(keys) == 2 * 6 * 8 and all("/lora/" in k for k in keys)
            and attns == sorted([f"visual/blocks/{i}/attn" for i in range(6)]
                                + [f"text/layers/{i}/attn" for i in range(6)]),
            "best_model.npz does not hold exactly the LoRA tensors of both towers' 6 layers")
    require(counts.get("fused_mlp_backward", 0) == 2 * 6 * FT_ACCUM
            and counts.get("fused_ln_qkv_rawx_backward", 0) == 2 * 6 * FT_ACCUM,
            "the text LoRA fine-tune CLI did not train through K10's and K5 raw-x's backward "
            "kernels")


def clip_cli_phase(work):
    """The CLIP families' CLIs at full width on cli_phase's dataset (80
    seeded 224 px images, also listed as BUSI for the prompt ensemble), with
    NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1 (no HF tokenizer files): the
    clip.classification trainer (one augmented epoch, freq_enhanced MONA
    from seeded slots; best_model.npz holds the hidden cls head's four
    tensors), metaclip.segmentation (noise_aware MONA), the unimedclip,
    biomedclip and clip zero-shot CLIs (text launches 12 per class, K1 12
    per image batch), biomedclip.retrieval on caption_data's 160 pairs and
    clip.predict at its default task, zero-shot."""
    import csv
    import glob

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.models.vit import VIT_B16_OPENAI, vit_init
    from nextgen_uia_tpu_torch.tasks.biomedclip import retrieval
    from nextgen_uia_tpu_torch.tasks.biomedclip import zero_shot as biomedclip_zero_shot
    from nextgen_uia_tpu_torch.tasks.clip import classification as clip_classification
    from nextgen_uia_tpu_torch.tasks.clip import predict as clip_predict
    from nextgen_uia_tpu_torch.tasks.clip import zero_shot as clip_zero_shot
    from nextgen_uia_tpu_torch.tasks.metaclip import segmentation as metaclip_segmentation
    from nextgen_uia_tpu_torch.tasks.unimedclip import zero_shot as unimedclip_zero_shot

    data = os.path.join(work, "data")
    busi = os.path.join(data, "classification", "BUSI")
    shutil.copytree(os.path.join(data, "classification", "SYNTH"), busi, dirs_exist_ok=True)
    # the OpenAI layout's MONA slots, seeded, in each variant its CLIs default to
    mona = {}
    gen = torch.Generator().manual_seed(11)
    vit = vit_init(gen, VIT_B16_OPENAI)
    for variant in ("freq_enhanced", "noise_aware"):
        inject_mona(gen, vit, dim=VIT_B16_OPENAI.width, variant=variant)
        mona[variant] = os.path.join(work, f"openai_{variant}.npz")
        ckpt.save(mona[variant], torch.nn.ModuleDict({"visual": vit}), keyword_filter=["mona"])
    captions = caption_data(work)
    common = ["--num_workers", "4", "--device", "cuda"]
    trainer = ["--dataset", "SYNTH", "--data_root", data, "--epochs", "1", "--val_interval", "1",
               *common]
    zero_shot = ["--dataset", "BUSI", "--data_root", data, *common]
    bert = {k: 12 * 2 for k in BERT_CHAIN}  # 2 classes, 12 layers
    images = 12 * 3  # 80 images: 3 batches of 32
    rows = (
        ("clip cls", clip_classification.main, trainer + ["--exp", "chip_clip_cls", "--mona_weights",
                                                          mona["freq_enhanced"]]),
        ("metaclip seg", metaclip_segmentation.main,
         trainer + ["--exp", "chip_metaclip_seg", "--mona_weights", mona["noise_aware"]]),
        ("unimedclip zero-shot", unimedclip_zero_shot.main, zero_shot + ["--exp", "chip_umc_zs"]),
        ("biomedclip zero-shot", biomedclip_zero_shot.main, zero_shot + ["--exp", "chip_bmc_zs"]),
        ("clip zero-shot", clip_zero_shot.main, zero_shot + ["--exp", "chip_clip_zs"]),
        ("biomedclip retrieval", retrieval.main,
         ["--csv", os.path.join(captions, "captions.csv"), "--img_dir",
          os.path.join(captions, "images"), "--exp", "chip_retrieval", *common]),
        ("clip predict", clip_predict.main,
         ["--images", os.path.join(work, "predict.txt"), "--out",
          os.path.join(work, "clip_predict_out"), *common]))
    want = {"unimedclip zero-shot": {"fused_block_infer": 24 + images},
            "biomedclip zero-shot": {"fused_block_infer": images, **bert},
            "clip zero-shot": {"fused_block_infer": 24 + images},
            "biomedclip retrieval": {"fused_block_infer": 24, **bert},  # 160 pairs: 2 of 128
            "clip predict": {"fused_block_infer": 24 + 12}}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with environ(NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK="1"):
            for name, fn, argv in rows:
                reset_counts()
                t0 = time.perf_counter()
                out = fn(argv)
                seconds = time.perf_counter() - t0
                counts = {k: v for k, v in read_counts().items() if v}
                shown = {k: round(float(v), 4) for k, v in out.items() if np.isscalar(v)
                         and not isinstance(v, str)}
                print(f"cli: {name} in {seconds:.1f} s (host clock: build, data decode "
                      f"included); {shown}; launches {counts}")
                if name in want:
                    require(counts == want[name], f"{name} launches {counts}, want {want[name]}")
                else:  # the trainers: the backward kernels, then K1 in evaluation
                    require(np.isfinite(out["loss"])
                            and all(counts.get(k, 0) > 0 for k in (
                                "fused_ln_qkv_backward", "fused_attn_o_residual_backward",
                                "fused_ln_mlp_residual_backward", "mona_spatial_backward",
                                "fused_block_infer")),
                            f"the {name} CLI did not train through the backward kernels")
    finally:
        os.chdir(cwd)
    best = os.path.join(work, "runs", "chip_clip_cls", "SYNTH", "train", "best_model.npz")
    heads = sorted(k for k in ckpt.peek_keys(best) if "/cls_head/" in k)
    require(heads == [f"params/head/cls_head/{fc}/{t}" for fc in ("fc1", "fc2") for t in "bw"],
            f"clip cls best_model.npz head tensors {heads}")
    for exp in ("chip_umc_zs", "chip_bmc_zs", "chip_clip_zs"):
        require(glob.glob(os.path.join(work, "runs", exp, "BUSI", "test", "*acc*",
                                       "results.csv")), f"{exp} wrote no results.csv")
    require(os.path.exists(os.path.join(work, "runs", "chip_retrieval", "BUSI", "test",
                                        "results.csv")), "retrieval wrote no results.csv")
    with open(os.path.join(work, "clip_predict_out", "predictions.csv")) as f:
        preds = list(csv.DictReader(f))
    require(len(preds) == 8 and all(r["status"] == "ok" and r["pred"] in ("benign", "malignant")
                                    for r in preds), "clip predict --task zero_shot failed")
    print(f"cli: clip cls best_model.npz holds {heads}; clip predict wrote {len(preds)} "
          f"zero-shot predictions")


# --- --method full, the converter and the CLIP text tower's composed route ---

def full_step_tokens():
    """The in-step token batches of the full fine-tune phase, FT_BATCH seeded
    captions each: (BiomedCLIP's at context 256, the OpenAI layout's at 77),
    tokenized and trimmed to 32-token buckets as the CLI trims them."""
    import argparse

    from nextgen_uia_tpu_torch.data.tokenizer import ClipTokenizer
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import get_text_tokenizer

    captions = synthetic_captions(FT_BATCH, 14)
    bert_tok = get_text_tokenizer(argparse.Namespace(), "biomedclip")
    return (ft.trim_token_padding(bert_tok(captions, 256)),
            ft.trim_token_padding(ClipTokenizer()(captions, 77)))


def full_k7_shapes():
    """K7 on this slice's routes: (JSON name, B, N, H, causal, padding bias,
    backward): the ViT under full, the trained CLIP text tower at its
    trimmed length, BERT trained at its trimmed length, BERT's text cache
    under full (forward only, a chunk at full context)."""
    bert_tokens, clip_tokens = full_step_tokens()
    return (("flash_attention_full", FT_MICRO, 197, 12, False, False, True),
            ("flash_attention_causal", FT_MICRO, clip_tokens.shape[1], 8, True, False, True),
            ("flash_attention_bert", FT_MICRO, bert_tokens.shape[1], 12, False, True, True),
            ("flash_attention_bert_cache", TEXT_CHUNK, 256, 12, False, True, False))


def full_path_k7_rows(dev):
    """K7 in bf16 at the shapes of ``full_k7_shapes``, q, k and v strided
    views of one packed [B, N, 3, H, 64] product as ``mha`` hands them over:
    output and (where the route trains) dq, dk, dv against the plain versions
    on the bf16-rounded inputs (3e-2 * max|ref|); the op and its kernels alone
    (profiler device time of the "flash" kernels) forward and backward,
    scaled_dot_product_attention's forward and autograd backward on the same
    views, the plain versions, and the bound (causal: the lower triangle's
    work). Returns {name: JSON row}, the backward's under name + "_backward"."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(11)
    bf16, rows = torch.bfloat16, {}
    for name, b, n, h, causal, padded, backward in full_k7_shapes():
        qkv = torch.randn(b, n, 3, h, 64, generator=gen, device=dev).to(bf16)
        q, k, v = qkv.unbind(2)
        g = torch.randn(b, n, h, 64, generator=gen, device=dev).to(bf16)
        kb = None
        if padded:  # BERT's key-padding bias: a real length per sequence
            lengths = torch.randint(8, n + 1, (b,), generator=gen, device=dev)
            kb = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() * -1e9
        f32 = [t.float() for t in (q, k, v, g)]
        kw = dict(bias=kb, causal=causal, layout="bnhd")
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
            want = fa.flash_attention_plain(*f32[:3], **kw)
            err, scale = (out.float() - want).abs().max().item(), want.abs().max().item()
            require(err <= BF16_BOUND * scale, f"{name}: max|d| {err:.3e} > 3e-2 * {scale:.3e}")
            fwd = lambda: fa.flash_attention_forward(q, k, v, **kw)  # noqa: E731
            bwd = lambda: fa.flash_attention_backward(q, k, v, out, g, lse,  # noqa: E731
                                                      bias_grad=False, **kw)
            sdpa_args = [t.transpose(1, 2) for t in (q, k, v)]
            mask = None if kb is None else kb[:, None, None, :].to(bf16)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *sdpa_args, attn_mask=mask, is_causal=causal)
            iters = 20
            f_op, f_k = cuda_ms(fwd, iters), kernel_device_ms(fwd, "flash", iters)
            f_lib = cuda_ms(sdpa, iters)
            f_plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3, warmup=1)
        pairs = n * (n + 1) // 2 if causal else n * n
        io = 2 * 4 * b * h * n * 64 + 4 * b * h * n + (4 * b * n if padded else 0)
        f_bound = bound(4 * b * h * pairs * 64, io)
        rows[name] = dict(max_abs_err=err, ms=f_op, plain_ms=f_plain, library_ms=f_lib,
                          bound_ms=f_bound[0], bound_by=f_bound[1])
        line = (f"{name}: K7 forward [{b}, {n}, {h}, 64] packed causal={causal} "
                f"bias={padded} bf16: max|d| {err:.3e} (<= {BF16_BOUND * scale:.3e}); op "
                f"{f_op:.4f} ms, kernel {f_k:.4f} ms, SDPA {f_lib:.4f} ms, plain "
                f"{f_plain:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]})")
        if backward:
            with torch.no_grad():
                got = bwd()[:3]
                ref = fa.flash_attention_backward_plain(*f32[:3], kb, f32[3], causal=causal,
                                                        layout="bnhd")[:3]
                errs = errors(tuple(got), tuple(ref))
                b_err = max(d / s for d, s in errs)
                require(b_err <= BF16_BOUND, f"{name} backward: max|d| / max|ref| {b_err:.3e}")
                b_op, b_k = cuda_ms(bwd, iters), kernel_device_ms(bwd, "flash", iters)
                b_plain = cuda_ms(lambda: fa.flash_attention_backward_plain(
                    q, k, v, kb, g, causal=causal, layout="bnhd"), 3, warmup=1)
            leaves = [t.detach().requires_grad_() for t in sdpa_args]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, is_causal=causal)
            b_lib = cuda_ms(lambda: torch.autograd.grad(o, leaves, g.transpose(1, 2),
                                                        retain_graph=True), iters)
            b_bound = bound(10 * b * h * pairs * 64,
                            8 * b * h * n * 64 * 2 + 4 * b * h * n + (4 * b * n if padded else 0))
            rows[name + "_backward"] = dict(
                max_abs_err=max(d for d, _ in errs), ms=b_op, plain_ms=b_plain,
                library_ms=b_lib, bound_ms=b_bound[0], bound_by=b_bound[1])
            line += (f"; backward max|d| / max|ref| {b_err:.3e}, op {b_op:.4f} ms, kernel "
                     f"{b_k:.4f} ms, SDPA backward {b_lib:.4f} ms, plain {b_plain:.4f} ms, "
                     f"bound {b_bound[0]:.4f} ms ({b_bound[1]})")
        print(line)
    return rows


def _scaled(gen, *shape, std):
    import torch

    return torch.randn(*shape, generator=gen) * std


def torchvision_resnet18(gen):
    """torchvision's resnet18 state dict, seeded from ``gen``: convolutions
    normal of std fan_in^-0.5, BatchNorm scales near 1 and running
    statistics away from their init, the ImageNet 1000-way fc."""
    import torch

    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = _scaled(gen, cout, cin, k, k, std=(cin * k * k) ** -0.5)

    def bn(name, c):
        sd[name + ".weight"] = 1 + _scaled(gen, c, std=0.1)
        sd[name + ".bias"] = _scaled(gen, c, std=0.1)
        sd[name + ".running_mean"] = _scaled(gen, c, std=0.1)
        sd[name + ".running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[name + ".num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage in range(4):
        cout = 64 * 2 ** stage
        for b in range(2):
            base = f"layer{stage + 1}.{b}"
            conv(base + ".conv1", cout, cin if b == 0 else cout, 3)
            bn(base + ".bn1", cout)
            conv(base + ".conv2", cout, cout, 3)
            bn(base + ".bn2", cout)
            if b == 0 and stage > 0:
                conv(base + ".downsample.0", cout, cin, 1)
                bn(base + ".downsample.1", cout)
        cin = cout
    sd["fc.weight"] = _scaled(gen, 1000, 512, std=512 ** -0.5)
    sd["fc.bias"] = _scaled(gen, 1000, std=0.02)
    return sd


def reference_state_dict(kind, seed):
    """A full-size state dict under the reference checkpoint's key names,
    seeded: 'biomedclip' is open_clip's BiomedCLIP (a timm ViT-B/16 trunk
    under visual.trunk, PubMedBERT under text.transformer, the MLP text
    projection; float32), 'openai' OpenAI's ViT-B/16 CLIP (fused in_proj
    q/k/v; float16, as ViT-B-16.pt holds it), 'resnet18' torchvision's
    (``torchvision_resnet18``). Weights are normal of std fan_in^-0.5,
    embeddings 0.02, LayerNorm scales near 1."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    if kind == "resnet18":
        return torchvision_resnet18(gen)

    def lin(name, d_in, d_out, bias=True):
        sd[name + ".weight"] = _scaled(gen, d_out, d_in, std=d_in ** -0.5)
        if bias:
            sd[name + ".bias"] = _scaled(gen, d_out, std=0.02)

    def ln(name, d):
        sd[name + ".weight"] = 1 + _scaled(gen, d, std=0.1)
        sd[name + ".bias"] = _scaled(gen, d, std=0.1)

    d, hid, depth = 768, 3072, 12
    if kind == "biomedclip":
        t = "visual.trunk."
        sd[t + "patch_embed.proj.weight"] = _scaled(gen, d, 3, 16, 16, std=768 ** -0.5)
        sd[t + "patch_embed.proj.bias"] = _scaled(gen, d, std=0.02)
        sd[t + "cls_token"] = _scaled(gen, 1, 1, d, std=0.02)
        sd[t + "pos_embed"] = _scaled(gen, 1, 197, d, std=0.02)
        for i in range(depth):
            b = f"{t}blocks.{i}."
            lin(b + "attn.qkv", d, 3 * d)
            lin(b + "attn.proj", d, d)
            ln(b + "norm1", d)
            ln(b + "norm2", d)
            lin(b + "mlp.fc1", d, hid)
            lin(b + "mlp.fc2", hid, d)
        ln(t + "norm", d)
        lin("visual.head.proj", d, 512, bias=False)
        tt = "text.transformer."
        for name, rows in (("word", 30522), ("position", 512), ("token_type", 2)):
            sd[f"{tt}embeddings.{name}_embeddings.weight"] = _scaled(gen, rows, d, std=0.02)
        ln(tt + "embeddings.LayerNorm", d)
        for i in range(depth):
            b = f"{tt}encoder.layer.{i}."
            for name in ("query", "key", "value"):
                lin(b + "attention.self." + name, d, d)
            lin(b + "attention.output.dense", d, d)
            ln(b + "attention.output.LayerNorm", d)
            lin(b + "intermediate.dense", d, hid)
            lin(b + "output.dense", hid, d)
            ln(b + "output.LayerNorm", d)
        lin("text.proj.0", d, 640, bias=False)
        lin("text.proj.2", 640, 512, bias=False)
    else:
        sd["visual.conv1.weight"] = _scaled(gen, d, 3, 16, 16, std=768 ** -0.5)
        sd["visual.class_embedding"] = _scaled(gen, d, std=0.02)
        sd["visual.positional_embedding"] = _scaled(gen, 197, d, std=0.02)
        ln("visual.ln_pre", d)
        for prefix, w, n_blocks in (("visual.transformer.", d, depth), ("transformer.", 512, 12)):
            for i in range(n_blocks):
                b = f"{prefix}resblocks.{i}."
                sd[b + "attn.in_proj_weight"] = _scaled(gen, 3 * w, w, std=w ** -0.5)
                sd[b + "attn.in_proj_bias"] = _scaled(gen, 3 * w, std=0.02)
                lin(b + "attn.out_proj", w, w)
                ln(b + "ln_1", w)
                ln(b + "ln_2", w)
                lin(b + "mlp.c_fc", w, 4 * w)
                lin(b + "mlp.c_proj", 4 * w, w)
        ln("visual.ln_post", d)
        sd["visual.proj"] = _scaled(gen, d, 512, std=d ** -0.5)
        sd["token_embedding.weight"] = _scaled(gen, 49408, 512, std=0.02)
        sd["positional_embedding"] = _scaled(gen, 77, 512, std=0.01)
        ln("ln_final", 512)
        sd["text_projection"] = _scaled(gen, 512, 512, std=512 ** -0.5)
        sd = {k: v.half() for k, v in sd.items()}
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


def convert_phase(work):
    """The checkpoint converter on full-size reference state dicts
    (``reference_state_dict``): each ``torch.save``d and converted by
    ``python -m nextgen_uia_tpu_torch.convert <kind>`` in a process of its
    own (both at once), then loaded by ``load_into`` into the port's CLIP,
    whose every tensor it must fill; two tensors checked against the source
    after the layout rules (a split q/k/v weight transposed, the patch
    convolution in HWIO). Returns {family: (converted .npz path, the loaded
    CLIP module, cfg)}."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model

    jobs = {}
    for family, kind, seed in (("biomedclip", "biomedclip", 21), ("openai", "openai_clip", 22)):
        t0 = time.perf_counter()
        sd = reference_state_dict(family, seed)
        src, dst = (os.path.abspath(os.path.join(work, f"{family}.{ext}")) for ext in ("pt", "npz"))
        torch.save(sd, src)
        made_s = time.perf_counter() - t0
        proc = subprocess.Popen([sys.executable, "-m", "nextgen_uia_tpu_torch.convert", kind, src,
                                 dst], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs[family] = (kind, sd, src, dst, made_s, proc, time.perf_counter())
    out = {}
    for family, (kind, sd, src, dst, made_s, proc, t0) in jobs.items():
        args = ft._finetune_parser(family).parse_args(["--seed", "5"])
        cfg, model = build_clip_model(args, family, gen=torch.Generator().manual_seed(5))
        stdout, stderr = proc.communicate()
        conv_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"the converter failed on {kind}: {stderr[-2000:]}")
        flat = ckpt.load_flat(dst)
        _, n = ckpt.merge_flat(flat, model, source=dst)
        n_model = len(model.state_dict())
        if family == "biomedclip":
            w = sd["visual.trunk.blocks.3.attn.qkv.weight"][768:1536].T
            patch = sd["visual.trunk.patch_embed.proj.weight"]
        else:
            w = sd["visual.transformer.resblocks.3.attn.in_proj_weight"][768:1536].T.float()
            patch = sd["visual.conv1.weight"].float()
        same = (torch.equal(model.visual.blocks[3].attn.k.w, w)
                and torch.equal(model.visual.patch.w, patch.permute(2, 3, 1, 0)))
        print(f"convert: {kind}: {len(sd)} reference tensors "
              f"({sum(v.numel() for v in sd.values())} values, "
              f"{sd['visual.proj' if family == 'openai' else 'visual.head.proj.weight'].dtype}"
              f" weights) made and saved in {made_s:.1f} s; `python -m "
              f"nextgen_uia_tpu_torch.convert {kind}` done {conv_s:.1f} s after its start: "
              f"{stdout.strip()}; load_into filled {n} of the port's {n_model} tensors "
              f"({os.path.getsize(dst) / 1e6:.0f} MB .npz); split k and HWIO patch equal to the "
              f"source: {same}")
        require(n == n_model == len(flat), f"{kind}: {n} of {n_model} tensors loaded from "
                                           f"{len(flat)} converted")
        require(same, f"{kind}: a converted tensor differs from its source")
        require(np.isfinite(flat["logit_scale"]).all(), "logit_scale")
        os.remove(src)
        out[family] = (dst, model, cfg)
    return out


def check_two_updates(tag, loss_for, cfg, trainable, args, batch, dev, lr, expect):
    """Two AdamW updates at ``lr`` through the kernels, the first's launches
    counted (every counter not in ``expect`` must stay 0), then the same two
    updates on the plain path from the same weights: in bf16 the loss to 3e-2
    * max(1, |ref|) and the gradient norm to 3e-2 of the plain path's, in
    float32 both to 1e-4; the bf16 gradients' relative L2 distance printed.
    The trainable weights are put back after each run. Returns the first
    update's launch counts."""
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    start = {k: p.detach().clone() for k, p in trainable.items()}

    def run(ops, c, count=False):
        step = make_update(loss_for, ops, c, trainable, args, lr)
        gen = torch.Generator(device=dev).manual_seed(7)
        if count:
            reset_counts()
        ms = [step(batch, gen)]
        torch.cuda.synchronize()
        counts = read_counts()
        grads = {k: p.grad.float().clone() for k, p in trainable.items()}
        ms.append(step(batch, gen))
        with torch.no_grad():
            for k, p in trainable.items():
                p.copy_(start[k])
                p.grad = None
        return ms, counts, grads

    m_k, counts, g_k = run(KERNELS, cfg, count=True)
    m_p, _, g_p = run(PLAIN, cfg)
    rel_l2 = bf16_gradient_gap(g_k, g_p)[2]
    del g_k, g_p
    cfg32 = cfg.replace(compute_dtype="float32")
    m32_k, _, _ = run(KERNELS, cfg32)
    m32_p, _, _ = run(PLAIN, cfg32)
    launched = {k: v for k, v in counts.items() if v}
    print(f"{tag}: the first update's launches {launched}; bf16 losses kernel "
          + " ".join(f"{m['loss']:.6f}" for m in m_k) + " plain "
          + " ".join(f"{m['loss']:.6f}" for m in m_p) + "; gradient norms kernel "
          + " ".join(f"{m['grad_norm']:.4f}" for m in m_k) + " plain "
          + " ".join(f"{m['grad_norm']:.4f}" for m in m_p)
          + f" (first update's gradients: relative L2 distance {rel_l2:.3e}); float32 losses "
          + " ".join(f"{a['loss']:.7f}/{b['loss']:.7f}" for a, b in zip(m32_k, m32_p))
          + ", gradient norms "
          + " ".join(f"{a['grad_norm']:.6f}/{b['grad_norm']:.6f}" for a, b in zip(m32_k, m32_p)))
    require(launched == expect, f"{tag}: an update launched {launched}, want {expect}")
    for (a, b), (a32, b32) in zip(zip(m_k, m_p), zip(m32_k, m32_p)):
        require(a["skipped"] == 0 and abs(a["loss"] - b["loss"]) <= BF16_BOUND * max(
            1.0, abs(b["loss"])) and abs(a["grad_norm"] - b["grad_norm"])
            <= BF16_BOUND * b["grad_norm"], f"{tag}: a bf16 update disagrees with the plain path")
        require(abs(a32["loss"] - b32["loss"]) <= F32_BOUND * abs(b32["loss"])
                and abs(a32["grad_norm"] - b32["grad_norm"]) <= F32_BOUND * b32["grad_norm"],
                f"{tag}: a float32 update disagrees with the plain path")
    return counts


def time_update(tag, loss_for, cfg, trainable, args, batch, dev, lr):
    """ms per update by CUDA events, img/s, peak memory, the profiler's
    kernel sum and busy share over one update; the weights put back."""
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS

    start = {k: p.detach().clone() for k, p in trainable.items()}
    gen = torch.Generator(device=dev).manual_seed(8)
    step = make_update(loss_for, KERNELS, cfg, trainable, args, lr)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch, gen), 2, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}: batch {FT_BATCH} update ({FT_ACCUM} x {FT_MICRO}) {ms:.2f} ms = "
          f"{FT_BATCH * 1000 / ms:.1f} img/s; peak device memory {peak_gb:.2f} GB")
    busy = profile_steps(lambda: step(batch, gen), 1, ms)
    with torch.no_grad():
        for k, p in trainable.items():
            p.copy_(start[k])
    return ms, busy


def cut_towers(params, cfg, depth):
    """Cut a CLIP model's towers, in place, to their first ``depth`` blocks
    and layers; returns the config that says so."""
    import dataclasses

    import torch

    params.visual.blocks = torch.nn.ModuleList(list(params.visual.blocks)[:depth])
    name = "layers" if hasattr(params.text, "layers") else "blocks"
    setattr(params.text, name, torch.nn.ModuleList(list(getattr(params.text, name))[:depth]))
    return cfg.replace(vision=dataclasses.replace(cfg.vision, depth=depth),
                       text=dataclasses.replace(cfg.text, depth=depth))


def full_finetune_phase(dev, converted):
    """``--method full`` at full width from the converted weights, both
    towers cut to their first FULL_DEPTH blocks and layers (ViT-B/16
    at 224 px, bf16, batch 64 as 4 x 16, AdamW at the CLI's clamped 1e-6):
    BiomedCLIP with its 256 captions cached through PubMedBERT's plain
    ``mlp_impl='xla'`` layers (K7 forward with the padding bias, one a layer
    and chunk; features against the plain path), then two updates against
    the plain path (K7 forward and backward once a block and microbatch,
    nothing else), timed; the OpenAI layout with ``--tune_text_encoder``
    (the causal text tower trained in the step: K7 twice as often, causal
    half of it); then ``--method mona --tune_text_encoder`` on the OpenAI
    layout, the frozen text tower in the step by its LN route (K5, K6
    causal and K10's forward once a layer and microbatch, no K7 of its own,
    no text backward), one update at lr 0 against the plain path
    (``check_update``), and its text tower forward alone at the 64-token
    bucket against the plain path (K5, K6 causal, K10 once a layer),
    profiled. Every update is timed. Returns the launch
    counts of the new JSON rows."""
    import dataclasses

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.losses import info_nce
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.ops import PLAIN
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model, get_text_tokenizer

    n_mb, launches = FT_ACCUM, {}
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.integers(0, 256, (FT_BATCH, IMG, IMG, 3), dtype=np.uint8))

    def loss_for(text):
        def make(ops, c):
            def fn(mb, g):
                img, _ = clip_mod.encode_image(params, c, mb["image"].float() / 255.0, ops=ops,
                                               gen=g)
                txt = (mb["txt_feat"] if text == "cached"
                       else clip_mod.encode_text(params, c, mb["tokens"], ops=ops))
                return info_nce(img, txt, temperature=args.temperature)
            return fn
        return make

    # BiomedCLIP, --method full (the CLI's defaults)
    _, params, cfg = converted["biomedclip"]
    cfg = cut_towers(params, cfg, FULL_DEPTH)
    args = ft._finetune_parser("biomedclip").parse_args(["--seed", "5"])
    require(args.method == "full" and args.lr > 1e-5 and args.tune_layers == "all"
            and args.batch_size == FT_BATCH and args.accumulation_steps == FT_ACCUM,
            f"biomedclip fine-tune defaults changed: {args}")
    lr = 1e-6  # finetune_main's clamp of any --lr above 1e-5 under full
    cfg = ft.full_cfg(cfg)
    trainable, frozen = partition(params, ft.full_ft_predicate(args, depth=cfg.vision.depth))
    params.to(dev)
    print(f"full: BiomedCLIP, {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values), {len(frozen)} frozen "
          f"(logit_scale and the text tower)")
    require("logit_scale" in frozen and not any(k.startswith("text/") for k in trainable),
            "the full predicate trains logit_scale or the text tower")
    with environ(NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK="1"):
        tokenizer = get_text_tokenizer(args, "biomedclip")
    captions = synthetic_captions(TEXT_CHUNK, 13)
    tokens = tokenizer(captions, cfg.text.context_length)
    encode = ft.make_text_encoder(params, cfg, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = encode(tokens)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    cache_counts = {k: v for k, v in read_counts().items() if v}
    ref = ft.make_text_encoder(params, cfg, dev, ops=PLAIN)(tokens)
    err, scale = (feats - ref).abs().max().item(), ref.abs().max().item()
    cache_ms = cuda_ms(lambda: encode(tokens), 3, warmup=1)
    print(f"full: BiomedCLIP text cache of {TEXT_CHUNK} captions by PubMedBERT's mlp_impl='xla' "
          f"layers: {cache_s:.3f} s first call, {cache_ms:.2f} ms (CUDA events); launches "
          f"{cache_counts}; features vs plain path max|d| {err:.3e} (<= "
          f"{BF16_BOUND * max(1.0, scale):.3e})")
    require(cache_counts == {"flash_attention": cfg.text.depth},
            f"the BERT cache under full launched {cache_counts}")
    require(bool(torch.isfinite(feats).all()) and err <= BF16_BOUND * max(1.0, scale),
            "BERT features under full disagree with the plain path")
    launches["flash_attention_bert_cache"] = cache_counts["flash_attention"]
    batch = T.stack_microbatches({"image": images.to(dev), "txt_feat": feats[:FT_BATCH]}, n_mb)
    k7 = cfg.vision.depth * n_mb
    check_two_updates("full (BiomedCLIP)", loss_for("cached"), cfg, trainable, args, batch, dev,
                      lr, {"flash_attention": k7, "flash_attention_backward": k7})
    launches.update(flash_attention_full=k7, flash_attention_full_backward=k7)
    time_update("full (BiomedCLIP)", loss_for("cached"), cfg, trainable, args, batch, dev, lr)

    # BiomedCLIP, --method full --tune_text_encoder: PubMedBERT trains in the step
    bert_tokens, clip_tokens = full_step_tokens()
    args = ft._finetune_parser("biomedclip").parse_args(["--seed", "5", "--tune_text_encoder"])
    trainable, frozen = partition(params, ft.full_ft_predicate(args, depth=cfg.vision.depth))
    require(list(frozen) == ["logit_scale"], f"full --tune_text_encoder freezes {list(frozen)}")
    batch = T.stack_microbatches({"image": images.to(dev),
                                  "tokens": torch.from_numpy(bert_tokens).to(dev)}, n_mb)
    kt = cfg.text.depth * n_mb
    print(f"full: BiomedCLIP with --tune_text_encoder, {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values); text trimmed to "
          f"{bert_tokens.shape[1]} tokens")
    check_two_updates("full --tune_text_encoder (BiomedCLIP)", loss_for("in-step"), cfg,
                      trainable, args, batch, dev, lr,
                      {"flash_attention": k7 + kt, "flash_attention_backward": k7 + kt})
    launches.update(flash_attention_bert=kt, flash_attention_bert_backward=kt)
    time_update("full --tune_text_encoder (BiomedCLIP)", loss_for("in-step"), cfg, trainable,
                args, batch, dev, lr)
    params.cpu()
    del params, trainable, frozen, batch
    torch.cuda.empty_cache()

    # the OpenAI layout, --method full --tune_text_encoder: the text trains
    _, params, cfg = converted["openai"]
    cfg = cut_towers(params, cfg, FULL_DEPTH)
    cut_cfg = cfg
    args = ft._finetune_parser("openai").parse_args(["--seed", "5", "--tune_text_encoder"])
    cfg = ft.full_cfg(cfg)
    trainable, frozen = partition(params, ft.full_ft_predicate(args, depth=cfg.vision.depth))
    params.to(dev)
    require(list(frozen) == ["logit_scale"], f"full --tune_text_encoder freezes {list(frozen)}")
    step_tokens = clip_tokens
    print(f"full: OpenAI layout with --tune_text_encoder, {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values); text trimmed to "
          f"{step_tokens.shape[1]} tokens")
    batch = T.stack_microbatches({"image": images.to(dev),
                                  "tokens": torch.from_numpy(step_tokens).to(dev)}, n_mb)
    kt = cfg.text.depth * n_mb
    check_two_updates("full --tune_text_encoder (OpenAI)", loss_for("in-step"), cfg, trainable,
                      args, batch, dev, lr, {"flash_attention": k7 + kt,
                                             "flash_attention_backward": k7 + kt})
    launches.update(flash_attention_causal=kt, flash_attention_causal_backward=kt)
    time_update("full --tune_text_encoder (OpenAI)", loss_for("in-step"), cfg, trainable, args,
                batch, dev, lr)

    # --method mona --tune_text_encoder: the frozen text tower's LN route in
    # the step (K5, K6 causal, K10 forward), MONA trained
    from nextgen_uia_tpu_torch.adapters.mona import inject_mona

    args = ft._finetune_parser("openai").parse_args(["--seed", "5", "--method", "mona",
                                                     "--tune_text_encoder"])
    cfg = cut_cfg.replace(vision=dataclasses.replace(cut_cfg.vision,
                                                     mona_variant=args.mona_variant))
    params.cpu()
    inject_mona(torch.Generator().manual_seed(6), params.visual, dim=cfg.vision.width,
                variant=args.mona_variant)
    trainable, _ = partition(params, by_keywords("mona"))
    params.to(dev)
    last = f"visual/blocks/{cfg.vision.depth - 1}/mona/"

    def reaches_no_feature(k):
        return k.startswith(last) and not k.startswith((last + "down/", last + "up/"))

    counts, _, _ = check_update("mona --tune_text_encoder (OpenAI)", loss_for("in-step"), cfg,
                                trainable, args, batch, dev, reaches_no_feature)
    launched = {k: v for k, v in counts.items() if v}
    require(launched.get("fused_ln_qkv") == k7 + kt
            and launched.get("fused_attn_o_residual") == k7 + kt
            and launched.get("fused_mlp") == kt and "flash_attention" not in launched
            and "flash_attention_backward" not in launched
            and "fused_mlp_backward" not in launched and "fused_block_infer" not in launched
            and launched.get("fused_attn_o_residual_backward", 0) <= k7
            and launched.get("fused_ln_qkv_backward", 0) <= k7,
            f"mona --tune_text_encoder launched {launched}: want K5, K6 causal and K10 "
            f"forward {kt} each beside the image tower's kernels, no K7 of its own and no "
            f"text backward")
    launches["fused_mlp_text"] = launches["fused_attn_o_residual_causal"] = kt
    # no path differentiates the frozen causal tower, in either package
    launches["fused_attn_o_residual_causal_backward"] = 0
    time_update("mona --tune_text_encoder (OpenAI)", loss_for("in-step"), cfg, trainable, args,
                batch, dev, args.lr)

    # the same frozen route at trim_token_padding's 64-token bucket (where
    # the JAX package's kernel path takes its LN+QKV and causal attn+o
    # kernels too), one microbatch forward against the plain path, profiled
    lengths = rng.integers(8, 65, FT_MICRO)
    lengths[0] = 64
    short = np.zeros((FT_MICRO, cfg.text.context_length), np.int32)
    for i, n in enumerate(lengths):
        short[i, :n - 1] = rng.integers(1, 49406, n - 1)
        short[i, n - 1] = 49407  # EOT, the largest id
    short = torch.from_numpy(ft.trim_token_padding(short)).to(dev)
    with torch.no_grad():
        reset_counts()
        got = clip_mod.encode_text(params, cfg, short)
        torch.cuda.synchronize()
        short_counts = {k: v for k, v in read_counts().items() if v}
        ref = clip_mod.encode_text(params, cfg, short, ops=PLAIN)
    err, scale = (got.float() - ref.float()).abs().max().item(), ref.abs().max().item()
    print(f"mona --tune_text_encoder (OpenAI): the frozen text tower at the "
          f"{short.shape[1]}-token bucket, [{FT_MICRO}, {short.shape[1]}]: launches "
          f"{short_counts}; features vs plain path max|d| {err:.3e} (<= "
          f"{BF16_BOUND * max(1.0, scale):.3e})")
    depth_t = cfg.text.depth
    want = {"fused_ln_qkv": depth_t, "fused_attn_o_residual": depth_t, "fused_mlp": depth_t}
    require(short.shape[1] == 64 and short_counts == want,
            f"the frozen text tower at {short.shape[1]} tokens launched {short_counts}: want "
            f"K5, K6 causal and K10 forward {depth_t} each, no K7 of its own")
    with torch.no_grad():
        short_ms = cuda_ms(lambda: clip_mod.encode_text(params, cfg, short), 5, warmup=1)
        seen = set()
        profile_steps(lambda: clip_mod.encode_text(params, cfg, short), 2, short_ms, seen)
    # K6's kernels: K7 causal into the concat, the o-product with the residual epilogue
    k6_seen = [any(part in k for k in seen) for part in ("flash_fwd_wgmma", "ResidualEpilogue")]
    print(f"mona --tune_text_encoder (OpenAI): the 64-token forward's profile shows K6's "
          f"attention and o-product: {k6_seen if seen else 'not checked (no device records)'}")
    require(not seen or all(k6_seen), "the 64-token forward's profile lacks K6's kernels")
    require(bool(torch.isfinite(got).all()) and err <= BF16_BOUND * max(1.0, scale),
            "the frozen text tower at the 64-token bucket disagrees with the plain path")
    params.cpu()
    torch.cuda.empty_cache()
    return launches


def full_finetune_cli_phase(work, converted):
    """``python -m nextgen_uia_tpu_torch.tasks.biomedclip.finetune`` with no
    ``--method`` (full) from the converted checkpoint (``--ckpt``), with
    NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK=1, one epoch on the seeded caption
    data (2 updates at batch 64): the learning rate clamped, K7 forward and
    backward in every update and no frozen-weight kernel, best_model.npz
    holding every tensor the converted checkpoint holds."""
    import numpy as np

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks.biomedclip.finetune import main as finetune_main

    data = caption_data(work)
    dst = converted["biomedclip"][0]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with environ(NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK="1"):
            reset_counts()
            t0 = time.perf_counter()
            out = finetune_main(["--epochs", "1", "--exp", "chip_full_ft", "--ckpt", dst,
                                 "--finetune_csvs", os.path.join(data, "captions.csv"),
                                 "--finetune_img_dirs", os.path.join(data, "images"),
                                 "--num_workers", "4", "--device", "cuda"])
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
    finally:
        os.chdir(cwd)
    run = os.path.join(work, "runs", "chip_full_ft")
    best = os.path.join(run, "best_model.npz")
    keys = ckpt.peek_keys(best) if os.path.exists(best) else []
    with open(os.path.join(run, "log.log")) as f:
        log = f.read()
    print(f"cli: biomedclip fine-tune at its default --method full from the converted "
          f"checkpoint, one epoch (2 updates + validation) in {seconds:.1f} s (host clock); "
          f"best val loss {out['best_val_loss']:.4f}; best_model.npz {len(keys)} tensors; "
          f"launches {counts}")
    require(np.isfinite(out["best_val_loss"]), f"full fine-tune CLI result {out}")
    require("Adjusted learning rate to 1e-06 for full fine-tuning" in log,
            "the CLI did not clamp the full fine-tune's learning rate")
    require(sorted(keys) == sorted(ckpt.peek_keys(dst)),
            "best_model.npz does not hold the whole model")
    require(set(counts) == {"flash_attention", "flash_attention_backward"}
            and counts["flash_attention_backward"] == 2 * 12 * FT_ACCUM,
            f"the full fine-tune CLI launched {counts}: want K7 alone, its backward "
            f"{2 * 12 * FT_ACCUM} times")


# --- K6's causal mode, K7 in float32 at head dim 16, CLIPSeg, LoRA in the
# supervised CLIs and the few-shot trainers ---

K6_CAUSAL_SHAPES = ((FT_MICRO, 64), (FT_MICRO, 77))  # the 64-token bucket, the full context


def k6_causal_rows(dev):
    """K6's causal mode (the frozen CLIP text tower in the step: width 512,
    8 heads of 64) at [16, 8, 64, 64] (trim_token_padding's 64-token bucket)
    and [16, 8, 77, 64], forward and dq/dk/dv backward: float32 against the
    plain version within 1e-4 * max|ref|, bf16 on the bf16-rounded inputs
    within 3e-2 * max(1, max|ref|), the bf16 backward bitwise equal over two
    calls; then in bf16 the op by CUDA events, its kernels alone (no WMMA
    GEMM, no SIMT attention), the plain version, the library (SDPA with
    is_causal, then torch.addmm for the o-projection and the residual and
    the bias added; backward: the doh product, then SDPA's autograd
    backward) and the bound (the lower triangle's attention). Returns the
    JSON rows, at the 64-token bucket."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
    from nextgen_uia_tpu_torch.ops import fused_attn_o as fao

    bf16 = torch.bfloat16
    d, h = 512, 8
    dh = d // h
    gen = torch.Generator().manual_seed(13)
    o = Block(gen, ViTConfig(width=d, heads=h)).attn.o.to(dev).requires_grad_(False)
    wo, wo_b, bo_b = o.w, o.w.to(bf16), o.b.to(bf16)
    ops = {
        "fused_attn_o_residual_causal": (
            lambda q, k, v, x, _g: fao.fused_attn_o_residual(q, k, v, x, o, heads=h, causal=True),
            lambda q, k, v, x, _g: fao.fused_attn_o_residual_plain(q, k, v, x, o, heads=h,
                                                                   causal=True)),
        "fused_attn_o_residual_causal_backward": (
            lambda q, k, v, _x, g: fao.fused_attn_o_residual_backward(q, k, v, wo.to(q.dtype), g,
                                                                      causal=True),
            lambda q, k, v, _x, g: fao.fused_attn_o_residual_backward_plain(q, k, v, wo, g,
                                                                            causal=True))}
    rows = {}
    for b, n in K6_CAUSAL_SHAPES:
        args32 = [torch.randn(*s, generator=gen).to(dev)
                  for s in [(b, h, n, dh)] * 3 + [(b, n, d)] * 2]
        args_b = [t.to(bf16) for t in args32]
        args_r = [t.float() for t in args_b]
        m, pairs = b * n, n * (n + 1) // 2
        attn = 4 * b * h * pairs * dh
        costs = {"fused_attn_o_residual_causal": (attn + 2 * m * d * d, 2 * (5 * m * d + d * d)),
                 "fused_attn_o_residual_causal_backward": (2.5 * attn + 2 * m * d * d,
                                                           2 * (7 * m * d + d * d))}
        qb, kb, vb, xb, gb = args_b

        def lib_fwd():
            att = F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
            return torch.addmm(xb.reshape(m, d), att.transpose(1, 2).reshape(m, d),
                               wo_b).add_(bo_b)

        leaves = [t.detach().requires_grad_() for t in (qb, kb, vb)]
        att = F.scaled_dot_product_attention(*leaves, is_causal=True)

        def lib_bwd():
            doh = (gb.reshape(m, d) @ wo_b.T).reshape(b, n, h, dh).transpose(1, 2)
            return torch.autograd.grad(att, leaves, doh, retain_graph=True)

        libs = {"fused_attn_o_residual_causal": lib_fwd,
                "fused_attn_o_residual_causal_backward": lib_bwd}
        for name, (kern, plain) in ops.items():
            with torch.no_grad():
                rel32 = max(e / s for e, s in errors(kern(*args32), plain(*args32)))
                errs = errors(kern(*args_b), plain(*args_r))
                err_b, scale_b = max(errs, key=lambda e: e[0] / max(1.0, e[1]))
                first, second = kern(*args_b), kern(*args_b)
                torch.cuda.synchronize()
                same = all(torch.equal(a, c) for a, c in
                           zip(first if isinstance(first, tuple) else (first,),
                               second if isinstance(second, tuple) else (second,)))
                op_ms = cuda_ms(lambda: kern(*args_b), 20)
                kern_ms, seen, check = hopper_kernels_ms(name, lambda: kern(*args_b))
                plain_ms = cuda_ms(lambda: plain(*args_b), 3, warmup=1)
            lib_ms = cuda_ms(libs[name], 20)
            b_ms, b_by = bound(*costs[name])
            print(f"{name}: [{b}, {h}, {n}, {dh}], width {d}: f32 rel max|d| {rel32:.3e} (<= "
                  f"1e-4); bf16 max|d| {err_b:.3e} (<= {BF16_BOUND * max(1.0, scale_b):.3e}, "
                  f"max|ref| {scale_b:.3e}); two bf16 calls bitwise equal: {same}; bf16 op "
                  f"{op_ms:.4f} ms, kernels alone {kern_ms:.4f} ms ({check}), plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            for key, ms_ in sorted(seen.items(), key=lambda kv: -kv[1]):
                print(f"{name}:   {ms_:.4f} ms {key[:100]}")
            require(rel32 <= F32_BOUND, f"{name} float32 mismatch at [{b}, {h}, {n}, {dh}]")
            require(err_b <= BF16_BOUND * max(1.0, scale_b),
                    f"{name} bfloat16 mismatch at [{b}, {h}, {n}, {dh}]")
            require(same or "backward" not in name,
                    f"{name} bf16 is not bitwise repeatable at [{b}, {h}, {n}, {dh}]")
            if name not in rows:
                rows[name] = dict(max_abs_err=err_b, ms=op_ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    return rows


# K7's float32 kernels (csrc/flash_attention.cu, namespace f32): the
# forward, then the backward's D pass, dK/dV and dQ kernels
F32_FLASH_KERNELS = ("flash_fwd_f32", "flash_bwd_delta_f32", "flash_bwd_dkdv_f32",
                     "flash_bwd_dq_f32")


def k7_f32_dh16_rows(dev):
    """K7's float32 path at the CLIPSeg decoder's head dim 16, [32, 197, 4,
    16] (batch, tokens, heads, head dim; reduce_dim 64 in 4 heads), q, k
    and v strided views of one packed [B, N, 3, H, 16] float32 product as
    ``mha`` hands them over: the output, its lse and dq, dk, dv against the
    plain versions within 1e-4 * max|ref|, the backward bitwise equal over
    two calls; the op and its kernels alone, forward and backward, SDPA's
    float32 forward and autograd backward on the same views, the plain
    versions, and the bound (the operations at the CUDA cores' float32
    rate: the kernels run no tensor-core product) with the kernels' share of
    it. The profiler windows must show the float32 kernels
    (``F32_FLASH_KERNELS``) and no SIMT attention kernel. Returns the two
    rows."""
    import torch
    import torch.nn.functional as F

    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    b, n, h, dh = BATCH, 197, 4, 16
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = torch.randn(b, n, 3, h, dh, generator=gen, device=dev).unbind(2)
    g = torch.randn(b, n, h, dh, generator=gen, device=dev)
    kw = dict(layout="bnhd")
    with torch.no_grad():
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        (err, scale), = errors(out, fa.flash_attention_plain(q, k, v, **kw))
        lse_ref = fa.flash_attention_lse_plain(q, k, **kw)
        lse_rel = (lse - lse_ref).abs().max().item() / lse_ref.abs().max().item()
        got = fa.flash_attention_backward(q, k, v, out, g, lse, bias_grad=False, **kw)[:3]
        again = fa.flash_attention_backward(q, k, v, out, g, lse, bias_grad=False, **kw)[:3]
        ref = fa.flash_attention_backward_plain(q, k, v, None, g, layout="bnhd")[:3]
        b_errs = errors(tuple(got), tuple(ref))
        b_rel = max(e / s for e, s in b_errs)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        torch.cuda.synchronize()
        fwd = lambda: fa.flash_attention_forward(q, k, v, **kw)  # noqa: E731
        bwd = lambda: fa.flash_attention_backward(q, k, v, out, g, lse,  # noqa: E731
                                                  bias_grad=False, **kw)
        sdpa_args = [t.transpose(1, 2) for t in (q, k, v)]
        f_seen, b_seen = set(), set()
        f_op, f_k = cuda_ms(fwd, 20), kernel_device_ms(fwd, "flash", 20, seen=f_seen)
        f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(*sdpa_args), 20)
        f_plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3, warmup=1)
        b_op, b_k = cuda_ms(bwd, 20), kernel_device_ms(bwd, "flash", 20, seen=b_seen)
        b_plain = cuda_ms(lambda: fa.flash_attention_backward_plain(q, k, v, None, g,
                                                                    layout="bnhd"), 3, warmup=1)
    leaves = [t.detach().requires_grad_() for t in sdpa_args]
    o = F.scaled_dot_product_attention(*leaves)
    b_lib = cuda_ms(lambda: torch.autograd.grad(o, leaves, g.transpose(1, 2), retain_graph=True),
                    20)
    head_io = 4 * b * h * n * dh  # one float32 [B, H, N, dh] tensor
    f_bound = bound(4 * b * h * n * n * dh, 4 * head_io + 4 * b * h * n, peak=CUDA_CORE_FLOPS)
    b_bound = bound(10 * b * h * n * n * dh, 8 * head_io + 4 * b * h * n, peak=CUDA_CORE_FLOPS)
    names = {"forward": (f_seen, F32_FLASH_KERNELS[:1]), "backward": (b_seen,
                                                                      F32_FLASH_KERNELS[1:])}
    for what, (seen, want) in names.items():
        old = sorted(k[:60] for k in seen if "simt" in k)
        missing = [w for w in want if not any(w in k for k in seen)]
        check = ("not made: the profiler recorded no device activity" if not seen else
                 f"{', '.join(want)} seen, no SIMT kernel")
        print(f"flash_attention_f32_dh16: {what} profiler names: {check}")
        require(not seen or (not old and not missing),
                f"K7 float32 {what} ran {old or 'without ' + ', '.join(missing)}")
    print(f"flash_attention_f32_dh16: K7 float32 [{b}, {n}, {h}, {dh}] packed: max|d| "
          f"{err:.3e} (<= {F32_BOUND * scale:.3e}), lse rel {lse_rel:.3e}; forward op "
          f"{f_op:.4f} ms, kernel {f_k:.4f} ms ({f_bound[0] / f_k:.1%} of its bound "
          f"{f_bound[0]:.4f} ms, {f_bound[1]}), SDPA {f_lib:.4f} ms, plain {f_plain:.4f} ms")
    print(f"flash_attention_f32_dh16_backward: max|d| / max|ref| {b_rel:.3e}, two calls "
          f"bitwise equal: {same}; op {b_op:.4f} ms, kernels {b_k:.4f} ms ({b_bound[0] / b_k:.1%} "
          f"of its bound {b_bound[0]:.4f} ms, {b_bound[1]}), SDPA backward {b_lib:.4f} ms, "
          f"plain {b_plain:.4f} ms")
    require(err <= F32_BOUND * scale and lse_rel <= F32_BOUND and b_rel <= F32_BOUND,
            "K7 float32 at head dim 16 disagrees with the plain versions")
    require(same, "K7's float32 backward at head dim 16 is not bitwise repeatable")
    return {"flash_attention_f32_dh16": dict(
                max_abs_err=err, ms=f_op, plain_ms=f_plain, library_ms=f_lib,
                bound_ms=f_bound[0], bound_by=f_bound[1]),
            "flash_attention_f32_dh16_backward": dict(
                max_abs_err=max(e for e, _ in b_errs), ms=b_op, plain_ms=b_plain,
                library_ms=b_lib, bound_ms=b_bound[0], bound_by=b_bound[1])}


def held_updates(tag, make_step, trainable, batch, n, own_exempt, seed=None,
                 dtypes=("bfloat16", "float32"), state=None):
    """``n`` updates of ``make_step(compute_dtype, ops)`` on one batch from
    the same weights, through the kernels and on the plain path, in each of
    ``dtypes`` (a fresh generator of ``seed`` on each run, else none; the
    weights, and the BatchNorm buffers of ``state`` if given, put back after
    each). Each bf16 update's loss is held to 3e-2 * max(1, |ref|) and its
    gradient norm to 3e-2; in float32 the losses and norms to 1e-4, the
    first update's gradient of every trainable tensor by ``worst_ratio``
    (``own_exempt``: the names whose exact gradient is zero), and each
    buffer of ``state`` after the updates to 1e-4 * its max|ref|. Returns
    (the first kernel update's launch counts, the kernel updates' metrics),
    both of the first of ``dtypes``."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    start = {k: p.detach().clone() for k, p in trainable.items()}
    buffers = {} if state is None else {k: v.clone() for k, v in state.state_dict().items()}
    dev = batch["image"].device

    def run(dtype, ops):
        step = make_step(dtype, ops)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        reset_counts()
        out = [step(batch, gen)]
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        grads = {k: p.grad.float().clone() for k, p in trainable.items()}
        out += [step(batch, gen) for _ in range(n - 1)]
        after = {} if state is None else {k: v.clone() for k, v in state.state_dict().items()}
        with torch.no_grad():
            for k, p in trainable.items():
                p.copy_(start[k])
            if state is not None:
                state.load_state_dict(buffers)
        return out, counts, grads, after

    first = None
    for dtype in dtypes:
        (got, counts, g_k, s_k), (ref, _, g_p, s_p) = run(dtype, KERNELS), run(dtype, PLAIN)
        first = first or (counts, got)
        line = (f"{tag}: the first {dtype} update's launches {counts}; losses kernel "
                + " ".join(f"{m['loss']:.7f}" for m in got) + " plain "
                + " ".join(f"{m['loss']:.7f}" for m in ref) + ", gradient norms "
                + " ".join(f"{a['grad_norm']:.5f}/{c['grad_norm']:.5f}"
                           for a, c in zip(got, ref)))
        for a, c in zip(got, ref):
            require(np.isfinite(a["loss"]) and a["skipped"] == 0,
                    f"a {dtype} {tag} update skipped or is not finite")
        if dtype == "bfloat16":
            print(line)
            for a, c in zip(got, ref):
                require(abs(a["loss"] - c["loss"]) <= BF16_BOUND * max(1.0, abs(c["loss"]))
                        and abs(a["grad_norm"] - c["grad_norm"]) <= BF16_BOUND * c["grad_norm"],
                        f"a bf16 {tag} update disagrees with the plain path")
            continue
        worst, worst_name = worst_ratio(g_k, g_p, own_exempt)
        state_ratio = max(((s_k[k] - v).abs().max().item()
                           / (F32_BOUND * max(v.abs().max().item(), 1e-30))
                           for k, v in s_p.items()), default=0.0)
        print(line + f"; the first update's gradients worst max|d| / min(1e-4 max|ref| of all, "
                     f"3e-2 its own) = {worst:.3f} ({worst_name})"
              + (f"; BatchNorm statistics after the updates worst max|d| / (1e-4 max|ref|) = "
                 f"{state_ratio:.3f}" if state is not None else ""))
        for a, c in zip(got, ref):
            require(abs(a["loss"] - c["loss"]) <= F32_BOUND * abs(c["loss"])
                    and abs(a["grad_norm"] - c["grad_norm"]) <= F32_BOUND * c["grad_norm"],
                    f"a float32 {tag} update disagrees with the plain path")
        require(worst <= 1.0, f"the float32 {tag} gradient of {worst_name} disagrees with the "
                              f"plain path")
        require(state_ratio <= 1.0, f"the {tag} BatchNorm statistics disagree with the plain "
                                    f"path")
    counts, got = first
    require(got[-1]["loss"] != got[0]["loss"], f"the {tag} loss did not move")
    return counts, got


def clipseg_args(*extra):
    """The CLIPSeg trainer's flags (its parser and defaults) with ``extra``."""
    from nextgen_uia_tpu_torch.tasks import other_tasks as ot
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    p = base_parser("clipseg_segmentation", epochs=1000, batch_size=32, strong_augs=True,
                    weak_augs=True)
    ot.add_clipseg_flags(p)
    return p.parse_args(["--dataset", "BUSI", *extra])


def clipseg_phase(dev):
    """CLIPSeg at full width (the frozen OpenAI ViT-B/16 at 224 px and the
    12-layer causal text tower through K1 and K1 causal, bf16; the FiLM
    decoder at reduce_dim 64, 3 layers of 4 heads, float32; seeded random
    weights), batch 32 with augmentation off: three AdamW updates at the
    CLI's lr through the kernels and on the plain path from the same
    weights, in bf16 and with float32 towers (``held_updates``: every
    decoder tensor's float32 gradient held; the key bias's exact gradient
    is zero), the first update's launches (K1 24: 12 image blocks and the
    prompt's 12 causal ones; K7 float32 at head dim 16 3 forward and 3
    backward; nothing else); ms per update and img/s, a profiler table;
    then one serving batch (the predict CLI's per-batch function) against
    the plain path (bf16 logits 3e-2 * max(1, max|ref|), float32 1e-4 *
    max|ref|), its launches, img/s and a profiler table. Returns the launch
    counts of an update."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks import other_tasks as ot
    from nextgen_uia_tpu_torch.tasks.serve import make_infer

    args = clipseg_args("--no-strong_augs", "--no-weak_augs", "--seed", "4")
    require((args.batch_size, args.img_size, args.reduce_dim, args.compute_dtype, args.epochs)
            == (BATCH, IMG, 64, "bfloat16", 1000), f"clipseg defaults changed: {args}")
    t0 = time.perf_counter()
    bundle = ot.build_clipseg_bundle(args, torch.Generator().manual_seed(4))
    # the same towers and decoder with float32 compute: only the forwards
    forwards = {"bfloat16": (bundle.forward_train, bundle.forward_eval),
                "float32": ot.clipseg_forwards(args, clip_mod.clip_config(
                    "openai", compute_dtype="float32"))}
    params = bundle.params.to(dev)
    trainable, frozen = partition(params, bundle.trainable_pred)
    start = {k: p.detach().clone() for k, p in trainable.items()}
    print(f"clipseg: built OpenAI CLIP + FiLM decoder in {time.perf_counter() - t0:.1f} s; "
          f"{len(trainable)} trainable tensors ({sum(p.numel() for p in trainable.values())} "
          f"values), {len(frozen)} frozen")
    imgs, masks = disc_batch(np.random.default_rng(9), BATCH)
    batch = {"image": torch.from_numpy(imgs).to(dev)[None],
             "mask": torch.from_numpy(masks).to(dev)[None]}
    tcfg = T.TrainConfig(lr=args.lr, lr_min=args.lr_min, weight_decay=args.weight_decay,
                         beta1=args.beta1, beta2=args.beta2, total_updates=10)

    def make_step(dtype, ops):
        forward = forwards[dtype][0]

        def loss(mb, gen):
            return dice_ce_loss(*forward(params, mb, gen, ops))
        return T.TrainStep(loss, T.make_optimizer(trainable.values(), tcfg), tcfg)

    counts, _ = held_updates("clipseg", make_step, trainable, batch, 3, is_key_bias)
    want = {"fused_block_infer": 24, "flash_attention": 3, "flash_attention_backward": 3}
    require(counts == want, f"clipseg's update launched {counts}, want {want}")

    step = make_step("bfloat16", KERNELS)
    ms = cuda_ms(lambda: step(batch), 3, warmup=1)
    print(f"clipseg: update at batch {BATCH} {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s")
    profile_steps(lambda: step(batch), 2, ms)
    with torch.no_grad():
        for k, p in trainable.items():
            p.copy_(start[k])

    images = batch["image"][0]
    infer = make_infer(bundle.forward_eval, params, dev)
    reset_counts()
    logits = infer(images)
    torch.cuda.synchronize()
    serve_counts = {k: v for k, v in read_counts().items() if v}
    infer32 = make_infer(forwards["float32"][1], params, dev)
    (err, scale), = errors(logits, infer(images, PLAIN))
    (err32, scale32), = errors(infer32(images), infer32(images, PLAIN))
    serve_ms = cuda_ms(lambda: infer(images), 5, warmup=1)
    print(f"clipseg: serving batch {tuple(logits.shape)} launches {serve_counts}; bf16 logits "
          f"max|d| {err:.3e} (<= {BF16_BOUND * max(1.0, scale):.3e}, max|ref| {scale:.3e}); "
          f"float32 {err32:.3e} (<= {F32_BOUND * scale32:.3e}); {serve_ms:.2f} ms = "
          f"{BATCH * 1000 / serve_ms:.1f} img/s")
    require(tuple(logits.shape) == (BATCH, 2, IMG, IMG) and bool(torch.isfinite(logits).all()),
            f"clipseg logits {tuple(logits.shape)}")
    require(serve_counts == {"fused_block_infer": 24, "flash_attention": 3},
            f"clipseg serving launched {serve_counts}")
    require(err <= BF16_BOUND * max(1.0, scale) and err32 <= F32_BOUND * scale32,
            "clipseg's logits disagree with the plain path")
    profile_steps(lambda: infer(images), 2, serve_ms)
    params.cpu()
    torch.cuda.empty_cache()
    return {"flash_attention_f32_dh16": counts["flash_attention"],
            "flash_attention_f32_dh16_backward": counts["flash_attention_backward"]}


# per update: the head taps blocks {3, 6, 9}, so blocks 10 and 11 have no backward
SUP_LORA_LAUNCHES = {"flash_attention": 12, "flash_attention_backward": 10,
                     "fused_ln_mlp_residual": 12, "fused_ln_mlp_residual_backward": 10}


def lora_file(path, width, depth, r=16, seed=21):
    """A seeded LoRA component checkpoint as the fine-tune writes it (q, k,
    v, o pairs in every block, b nonzero)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    np.savez(path, **{f"visual/blocks/{i}/attn/lora/{t}/{ab}": (
        rng.standard_normal((width, r)) * width ** -0.5 if ab == "a"
        else rng.standard_normal((r, width)) * 0.02).astype(np.float32)
        for i in range(depth) for t in "qkvo" for ab in "ab"})
    return path


def supervised_lora_phase(dev, work, files):
    """The BiomedCLIP seg trainer's model with ``--lora_weights`` at full
    width (slice_phase's backbone and head, a seeded LoRA file, r 16 in all
    12 blocks, dropout 0.1, bf16, batch 32, augmentation off): two AdamW
    updates at the CLI's lr through the kernels and on the plain path from
    the same weights and the same dropout generator, in bf16 and float32
    (``held_updates``: every head and LoRA tensor's float32 gradient held),
    the first update's launches (K7 and K8 forward 12 each, backward 10:
    the taps end at block 9; nothing else), ms per update, img/s and a
    profiler table; then one eval batch (the predict CLI's per-batch
    function): K1 absent, K7 and K8 12 each, the logits against the plain
    path, img/s and a profiler table. Returns the LoRA file's path."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, make_forward
    from nextgen_uia_tpu_torch.tasks.common import base_parser
    from nextgen_uia_tpu_torch.tasks.serve import make_infer

    lora = lora_file(os.path.join(work, "lora.npz"), 768, 12)
    args = base_parser("biomedclip_seg").parse_args([
        "--num_classes", str(SEG_CLASSES), "--img_size", str(IMG), "--backbone_ckpt",
        files["backbone"], "--head_weights", files["head"], "--lora_weights", lora])
    cfg, hcfg, params = _build_supervised(args, "biomedclip", "seg",
                                          torch.Generator().manual_seed(3))
    require(cfg.vision.lora_dropout == 0.1 and all(hasattr(b.attn, "lora")
                                                   for b in params.backbone.visual.blocks),
            "--lora_weights did not inject LoRA with dropout into every block")
    params.to(dev)
    trainable, _ = partition(params, by_keywords("head", "mona", "lora"))
    start = {k: p.detach().clone() for k, p in trainable.items()}
    imgs, masks = disc_batch(np.random.default_rng(10), BATCH)
    batch = {"image": torch.from_numpy(imgs).to(dev)[None],
             "mask": torch.from_numpy(masks).to(dev)[None]}
    tcfg = T.TrainConfig(lr=args.lr, lr_min=args.lr_min, weight_decay=args.weight_decay,
                         beta1=args.beta1, beta2=args.beta2, total_updates=10)

    def make_step(dtype, ops):
        fwd = make_forward(cfg.replace(compute_dtype=dtype), hcfg, train=True)

        def loss(mb, gen):
            return dice_ce_loss(*fwd(params, mb["image"], mb["mask"], gen, ops))
        return T.TrainStep(loss, T.make_optimizer(trainable.values(), tcfg), tcfg)

    counts, _ = held_updates("supervised LoRA", make_step, trainable, batch, 2, is_key_bias,
                             seed=7)
    require(counts == SUP_LORA_LAUNCHES,
            f"the supervised LoRA update launched {counts}, want {SUP_LORA_LAUNCHES}")
    step, gen = make_step("bfloat16", KERNELS), torch.Generator(device=dev).manual_seed(8)
    ms = cuda_ms(lambda: step(batch, gen), 3, warmup=1)
    print(f"supervised LoRA: update at batch {BATCH} {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s")
    profile_steps(lambda: step(batch, gen), 2, ms)
    with torch.no_grad():
        for k, p in trainable.items():
            p.copy_(start[k])

    infer = make_infer(make_forward(cfg, hcfg, train=False), params, dev)
    images = batch["image"][0]
    reset_counts()
    logits = infer(images)
    torch.cuda.synchronize()
    eval_counts = {k: v for k, v in read_counts().items() if v}
    (err, scale), = errors(logits, infer(images, PLAIN))
    eval_ms = cuda_ms(lambda: infer(images), 5, warmup=1)
    print(f"supervised LoRA: eval batch launches {eval_counts}; logits vs plain path max|d| "
          f"{err:.3e} (<= {BF16_BOUND * max(1.0, scale):.3e}); {eval_ms:.2f} ms = "
          f"{BATCH * 1000 / eval_ms:.1f} img/s")
    require(eval_counts == {"flash_attention": 12, "fused_ln_mlp_residual": 12},
            f"the LoRA eval batch launched {eval_counts}: want the composed route, no K1")
    require(bool(torch.isfinite(logits).all()) and err <= BF16_BOUND * max(1.0, scale),
            "the LoRA eval logits disagree with the plain path")
    profile_steps(lambda: infer(images), 2, eval_ms)
    params.cpu()
    torch.cuda.empty_cache()
    return lora


def adapter_cli_phase(work, files, lora):
    """This slice's CLIs on cli_phase's dataset (64 train, 8 val, 8 test
    images at 224 px; listed as BUSI, whose dense prompt CLIPSeg reads),
    one epoch each at their default augmentation: clipseg.segmentation
    (batch 32: 2 updates, each K7's float32 backward 3 times), clipseg
    predict on its best_model.npz (8 images: K1 24, K7 3),
    biomedclip.fewshot_segmentation with ``lora`` as --lora_weights (10% of
    the train split: 6 images, one update at the clamped batch 6, through
    supervised_main's LoRA route: K7 and K8 backward 10 each, no K1; the
    LoRA tensors of its best_model.npz moved and load back),
    biomedclip.fewshot_classification with MONA (one update), and
    biomedclip.predict --task seg with that best_model.npz as
    --lora_weights and --head_weights (K7 and K8 12 each, no K1)."""
    import csv
    import glob
    import re

    import numpy as np

    from nextgen_uia_tpu_torch.tasks.biomedclip import fewshot_classification
    from nextgen_uia_tpu_torch.tasks.biomedclip import fewshot_segmentation
    from nextgen_uia_tpu_torch.tasks.biomedclip import predict as biomedclip_predict
    from nextgen_uia_tpu_torch.tasks.clipseg import predict as clipseg_predict
    from nextgen_uia_tpu_torch.tasks.clipseg import segmentation as clipseg_segmentation

    data, listing = os.path.join(work, "data"), os.path.join(work, "predict.txt")
    common = ["--num_workers", "4", "--device", "cuda"]
    best = os.path.join(work, "runs", "chip_clipseg", "BUSI", "train", "best_model.npz")
    lora_best = os.path.join(work, "lora_best_model.npz")
    rows = (
        ("clipseg seg", clipseg_segmentation.main,
         ["--dataset", "BUSI", "--data_root", data, "--exp", "chip_clipseg", "--epochs", "1",
          "--val_interval", "1", *common]),
        ("clipseg predict", clipseg_predict.main,
         ["--images", listing, "--head_weights", best, "--out",
          os.path.join(work, "clipseg_out"), *common]),
        ("biomedclip few-shot seg with LoRA", fewshot_segmentation.main,
         ["--dataset", "SYNTH", "--data_root", data, "--exp", "chip_fewshot_seg", "--epochs",
          "1", "--val_interval", "1", "--backbone_ckpt", files["backbone"], "--lora_weights",
          lora, *common]),
        ("biomedclip few-shot cls", fewshot_classification.main,
         ["--dataset", "SYNTH", "--data_root", data, "--exp", "chip_fewshot_cls", "--epochs",
          "1", "--val_interval", "1", "--mona_variant", "hybrid", "--backbone_ckpt",
          files["backbone"], "--mona_weights", files["mona"], *common]),
        ("biomedclip predict with LoRA", biomedclip_predict.main,
         ["--task", "seg", "--images", listing, "--backbone_ckpt", files["backbone"],
          "--head_weights", lora_best, "--lora_weights", lora_best, "--out",
          os.path.join(work, "lora_out"), *common]))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, fn, argv in rows:
            reset_counts()
            t0 = time.perf_counter()
            out = fn(argv)
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
            shown = {k: round(float(v), 4) for k, v in out.items() if np.isscalar(v)
                     and not isinstance(v, str)}
            print(f"cli: {name} in {seconds:.1f} s (host clock: data decode included); "
                  f"{shown}; launches {counts}")
            if name == "clipseg seg":
                require(np.isfinite(out["loss"]) and counts.get("flash_attention_backward") == 6
                        and counts.get("fused_block_infer", 0) > 0
                        and set(counts) <= {"fused_block_infer", "flash_attention",
                                            "flash_attention_backward", "equalize"},
                        f"the clipseg trainer launched {counts}")
                require(os.path.exists(best), "clipseg best_model.npz missing")
            elif name.startswith("biomedclip few-shot"):
                exp = "chip_fewshot_seg" if "seg" in name else "chip_fewshot_cls"
                run = glob.glob(os.path.join(work, "runs", exp, "**", "log.log"), recursive=True)
                log = "".join(open(f).read() for f in run)
                sampled = re.findall(r"Few-shot training subset: (\d+) samples", log)
                require(np.isfinite(out["loss"]) and len(sampled) == 1
                        and 1 <= int(sampled[0]) <= BATCH,
                        f"the {name} trainer sampled {sampled}: want one subset, one update")
                if "seg" in name:
                    require(counts.get("flash_attention_backward") == 10
                            and counts.get("fused_ln_mlp_residual_backward") == 10
                            and "fused_block_infer" not in counts
                            and set(counts) <= {"flash_attention", "flash_attention_backward",
                                                "fused_ln_mlp_residual",
                                                "fused_ln_mlp_residual_backward", "equalize"},
                            f"the few-shot LoRA trainer launched {counts}: want one update "
                            f"and its eval by the LoRA route")
                    found = glob.glob(os.path.join(work, "runs", exp, "**", "best_model.npz"),
                                      recursive=True)
                    require(len(found) == 1, f"few-shot best_model.npz: {found}")
                    shutil.copy(found[0], lora_best)
                    lora_back_check(lora, lora_best, files)
                else:
                    require(counts.get("fused_ln_qkv_backward", 0) > 0
                            and counts.get("fused_block_infer", 0) > 0,
                            f"the few-shot cls trainer launched {counts}")
            else:
                want = ({"fused_block_infer": 24, "flash_attention": 3} if "clipseg" in name
                        else {"flash_attention": 12, "fused_ln_mlp_residual": 12})
                require(counts == want, f"{name} launched {counts}, want {want}")
                with open(os.path.join(out["out"], "index.csv")) as f:
                    served = list(csv.DictReader(f))
                require(len(served) == 8 and all(r["status"] == "ok" for r in served),
                        f"{name} wrote {len(served)} masks")
    finally:
        os.chdir(cwd)


def lora_back_check(lora, best, files):
    """The supervised trainer's best_model.npz holds every LoRA tensor of
    ``lora`` (under params/backbone/), those of blocks 0-9 (the head's taps
    end at block 9) moved by the update, and ``_build_supervised`` with it
    as --lora_weights and --head_weights loads each one back unchanged."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    start, saved = np.load(lora), np.load(best)
    keys = {k: "params/backbone/" + k for k in start.files}
    require(all(v in saved.files for v in keys.values()),
            f"best_model.npz lacks LoRA tensors: {sorted(set(keys.values()) - set(saved.files))[:4]}")
    moved = sum(not np.array_equal(start[k], saved[v]) for k, v in keys.items()
                if int(k.split("/")[2]) <= 9)
    args = base_parser("biomedclip_seg").parse_args([
        "--img_size", str(IMG), "--backbone_ckpt", files["backbone"], "--head_weights", best,
        "--lora_weights", best])
    _, _, params = _build_supervised(args, "biomedclip", "seg", torch.Generator().manual_seed(0))
    state = params.state_dict()
    same = sum(np.array_equal(state["backbone." + k.replace("/", ".")].numpy(), saved[v])
               for k, v in keys.items())
    print(f"cli: best_model.npz holds {len(keys)} LoRA tensors, {moved} of blocks 0-9's moved "
          f"by the update; {same} load back unchanged")
    require(moved == 8 * 10 and same == len(keys) == 8 * 12,
            "the trained LoRA tensors did not round-trip through best_model.npz")


# --- the ResNet/UNet baselines and CLIP's ModifiedResNet ---

# (tag, task, flags): the baselines trainers' models at their CLI defaults
BASELINE_MODELS = (("resnet18", "cls", ["--version", "resnet18"]),
                   ("resnet50", "cls", ["--version", "resnet50"]),
                   ("unet", "seg", []))


def baseline_args(task, *extra):
    """The baselines trainer's flags (its parser and defaults) with ``extra``."""
    from nextgen_uia_tpu_torch.tasks import other_tasks as ot
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    p = base_parser("baselines", epochs=200, batch_size=32, strong_augs=True, weak_augs=True)
    (ot.add_baseline_cls_flags if task == "cls" else ot.add_baseline_seg_flags)(p)
    return p.parse_args(["--dataset", "BUSI", *extra])


def is_bn_fed_bias(name):
    """The UNet's conv biases ahead of a train-mode BatchNorm, which the
    batch mean removes: their exact gradient is zero, so both paths give
    rounding noise, held only to 1e-4 * the largest max|ref|."""
    import re

    return re.fullmatch(r"model/(enc|dec)\d/conv[12]/b", name) is not None


def equalize_records(fn):
    """(device records of K13's equalize kernel in one call of fn, whether
    the profiler recorded any device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in device if "equalize" in e.key), bool(device)


def baselines_phase(dev):
    """The baselines at their CLIs' defaults (float32, batch 32, 224 px,
    strong+weak augmentation, AdamW at the CLI's lr; seeded random
    weights): ResNet-18 and ResNet-50 classifiers (3 channels, 2 classes)
    and the UNet segmenter (1 channel, init_channels 16). Each takes 2
    updates through the kernels (K13's equalize in the augmentation) and on
    the plain path (``equalize_plain``) under one generator, cuDNN's
    algorithms deterministic
    (``held_updates``: losses 1e-4 relative, every first-update gradient by
    ``worst_ratio``, the BatchNorm statistics after the updates 1e-4 *
    max|ref|; equalize launched once per slot that drew it, and as many
    device records in a profiled update); then the update and the eval
    batch timed by CUDA events, with peak memory and the profiler's busy
    share, with TF32 off and with PyTorch's default cuDNN TF32 on, as the
    CLIs run. Then CLIP's ModifiedResNet RN50 forward at [32, 224, 224, 3]
    on the card against the same module on the CPU in float32 (1e-4 *
    max|ref|), timed both ways."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.data.augment import sample_plan
    from nextgen_uia_tpu_torch.losses import dice_ce_loss, focal_loss
    from nextgen_uia_tpu_torch.models import clip_resnet as cr
    from nextgen_uia_tpu_torch.ops import KERNELS
    from nextgen_uia_tpu_torch.tasks import other_tasks as ot
    from nextgen_uia_tpu_torch.tasks.serve import make_infer

    all_slots = 0
    for tag, task, extra in BASELINE_MODELS:
        args = baseline_args(task, "--seed", "6", *extra)
        require((args.batch_size, args.img_size, args.strong_augs, args.weak_augs,
                 args.in_channels, args.num_classes) == (BATCH, IMG, True, True,
                                                         3 if task == "cls" else 1, 2)
                and (task == "cls" or args.init_channels == 16),
                f"baselines {task} defaults changed: {args}")
        t0 = time.perf_counter()
        build = ot.build_baseline_cls_bundle if task == "cls" else ot.build_baseline_seg_bundle
        bundle = build(args, torch.Generator().manual_seed(6))
        params, bn = bundle.params.to(dev), bundle.bn_state.to(dev)
        trainable, _ = partition(params, bundle.trainable_pred)
        imgs, masks = disc_batch(np.random.default_rng(10), BATCH)
        batch = {"image": torch.from_numpy(imgs).to(dev)[None]}
        if task == "cls":
            batch["label"] = (torch.arange(BATCH, device=dev) % 2)[None]
        else:
            batch["mask"] = torch.from_numpy(masks).to(dev)[None]
        print(f"baselines {tag}: built in {time.perf_counter() - t0:.1f} s; {len(trainable)} "
              f"trainable tensors ({sum(p.numel() for p in trainable.values())} values), "
              f"{len(bn.state_dict())} BatchNorm buffers")
        tcfg = T.TrainConfig(lr=args.lr, lr_min=args.lr_min, weight_decay=args.weight_decay,
                             beta1=args.beta1, beta2=args.beta2, total_updates=10)

        def make_step(dtype, ops):  # the baselines compute in float32 alone
            def loss(mb, gen):
                logits, m = bundle.forward_train(params, mb, gen, ops)
                return focal_loss(logits, mb["label"]) if task == "cls" else dice_ce_loss(logits, m)
            return T.TrainStep(loss, T.make_optimizer(trainable.values(), tcfg), tcfg)

        slots = int((sample_plan(torch.Generator(device=dev).manual_seed(11), BATCH).strong_ids
                     == 2).any(0).sum())
        # cuDNN's default algorithms sum in an order that varies between
        # runs, and Adam's first step moves a weight whose gradient is
        # rounding noise by +-lr in a direction that noise sets: the routes'
        # second updates then part by more than rounding (ResNet-50's
        # gradient norm by 3.0e-4 on an H100). Deterministic algorithms leave the
        # kernel (equalize, bitwise equal to its plain version) as the only
        # difference between the routes.
        torch.backends.cudnn.deterministic = True
        try:
            counts, _ = held_updates(f"baselines {tag}", make_step, trainable, batch, 2,
                                     is_bn_fed_bias, seed=11, dtypes=("float32",), state=bn)
        finally:
            torch.backends.cudnn.deterministic = False
        require(counts == ({"equalize": slots} if slots else {}),
                f"baselines {tag}: the first update launched {counts} for {slots} equalize "
                f"slots")
        step = make_step("float32", KERNELS)
        gen = torch.Generator(device=dev).manual_seed(12)
        twin = torch.Generator(device=dev)
        twin.set_state(gen.get_state())
        prof_slots = int((sample_plan(twin, BATCH).strong_ids == 2).any(0).sum())
        records, seen = equalize_records(lambda: step(batch, gen))
        print(f"baselines {tag}: equalize slots {slots} (held updates), {prof_slots} (profiled "
              f"update): {records if seen else 'not measured'} equalize device records")
        require(not seen or records == prof_slots,
                f"baselines {tag}: {records} equalize device records for {prof_slots} slots")
        all_slots += slots + prof_slots

        infer = make_infer(bundle.forward_eval, params, dev)
        images = batch["image"][0]
        logits = infer(images)
        want = (BATCH, 2) if task == "cls" else (BATCH, 2, IMG, IMG)
        require(tuple(logits.shape) == want and bool(torch.isfinite(logits).all()),
                f"baselines {tag} eval logits {tuple(logits.shape)}")
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: step(batch, gen), 5, warmup=2)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                busy = profile_steps(lambda: step(batch, gen), 2, ms)
                eval_ms = cuda_ms(lambda: infer(images), 5, warmup=2)
                eval_busy = profile_steps(lambda: infer(images), 2, eval_ms)
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            print(f"baselines {tag}: TF32 {'on (the CLI default)' if tf32 else 'off (held)'}: "
                  f"update at batch {BATCH} {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s, busy "
                  f"{busy:.1f}%, peak device memory {peak_gb:.2f} GB; eval batch {eval_ms:.2f} "
                  f"ms = {BATCH * 1000 / eval_ms:.1f} img/s, busy {eval_busy:.1f}%")
        params.cpu()
        bn.cpu()
        del bundle, params, bn, trainable, step, infer
        torch.cuda.empty_cache()
    require(all_slots > 0, "no baselines update drew equalize: K13 went unchecked there")

    params, state = cr.modified_resnet_init(torch.Generator().manual_seed(14), cr.RN50)
    x = torch.from_numpy(np.random.default_rng(15).random((BATCH, IMG, IMG, 3),
                                                          dtype=np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cr.modified_resnet_apply(params, state, x, cr.RN50)
        cpu_s = time.perf_counter() - t0
        params.to(dev)
        state.to(dev)
        xd = x.to(dev)
        got = cr.modified_resnet_apply(params, state, xd, cr.RN50)
        (err, scale), = errors(got.cpu(), ref)
        ms = cuda_ms(lambda: cr.modified_resnet_apply(params, state, xd, cr.RN50), 5)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(lambda: cr.modified_resnet_apply(params, state, xd, cr.RN50), 5)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"ModifiedResNet RN50: features {tuple(got.shape)} vs the CPU float32 forward "
          f"({cpu_s:.1f} s) max|d| {err:.3e} (<= {F32_BOUND * scale:.3e}, max|ref| "
          f"{scale:.3e}); forward at batch {BATCH} {ms:.2f} ms = {BATCH * 1000 / ms:.1f} img/s "
          f"with TF32 off, {tf32_ms:.2f} ms = {BATCH * 1000 / tf32_ms:.1f} img/s on")
    require(tuple(got.shape) == (BATCH, cr.RN50.output_dim) and scale > 0
            and bool(torch.isfinite(got).all()) and err <= F32_BOUND * scale,
            "ModifiedResNet RN50 on the card disagrees with the CPU")
    params.cpu()
    torch.cuda.empty_cache()


def baselines_cli_phase(work):
    """The baselines CLIs on cli_phase's dataset (64 train images at 224 px)
    at their defaults: segmentation, one epoch (2 updates at batch 32,
    equalize the only kernel), then predict --task seg on its
    best_model.npz; classification, one epoch, from a seeded torchvision
    resnet18 (``reference_state_dict``) converted by ``python -m
    nextgen_uia_tpu_torch.convert resnet18`` in a process of its own (the
    1000-way fc left at init, the ``__state__/`` statistics loaded), then
    predict --task cls; both few-shot trainers, one update each."""
    import csv
    import glob
    import re

    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.tasks.baselines import classification, fewshot_classification
    from nextgen_uia_tpu_torch.tasks.baselines import fewshot_segmentation, predict, segmentation

    data, listing = os.path.join(work, "data"), os.path.join(work, "predict.txt")
    src, dst = (os.path.join(work, f"resnet18.{ext}") for ext in ("pt", "npz"))
    torch.save(reference_state_dict("resnet18", 23), src)
    proc = subprocess.run([sys.executable, "-m", "nextgen_uia_tpu_torch.convert", "resnet18", src,
                           dst], cwd=ROOT, capture_output=True, text=True)
    require(proc.returncode == 0, f"the converter failed on resnet18: {proc.stderr[-2000:]}")
    print(f"cli: `python -m nextgen_uia_tpu_torch.convert resnet18`: {proc.stdout.strip()}")
    common = ["--dataset", "SYNTH", "--data_root", data, "--epochs", "1", "--val_interval", "1",
              "--num_workers", "4", "--device", "cuda"]
    runs = os.path.join(work, "runs")
    best_seg = os.path.join(runs, "chip_bl_seg", "SYNTH", "train", "best_model.npz")
    best_cls = os.path.join(runs, "chip_bl_cls", "SYNTH", "train", "best_model.npz")
    serve = ["--images", listing, "--num_workers", "4", "--device", "cuda"]
    rows = (
        ("baselines seg", segmentation.main, ["--exp", "chip_bl_seg", *common]),
        ("baselines predict seg", predict.main,
         ["--task", "seg", "--head_weights", best_seg, "--out", os.path.join(work, "bl_seg_out"),
          *serve]),
        ("baselines cls from a converted resnet18", classification.main,
         ["--exp", "chip_bl_cls", "--backbone_ckpt", dst, *common]),
        ("baselines predict cls", predict.main,
         ["--head_weights", best_cls, "--out", os.path.join(work, "bl_cls_out"), *serve]),
        ("baselines few-shot cls", fewshot_classification.main, ["--exp", "chip_bl_fs_cls",
                                                                 *common]),
        ("baselines few-shot seg", fewshot_segmentation.main, ["--exp", "chip_bl_fs_seg",
                                                               *common]))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, fn, argv in rows:
            reset_counts()
            t0 = time.perf_counter()
            out = fn(argv)
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
            shown = {k: round(float(v), 4) for k, v in out.items() if np.isscalar(v)
                     and not isinstance(v, str)}
            print(f"cli: {name} in {seconds:.1f} s (host clock: data decode included); "
                  f"{shown}; launches {counts}")
            require(set(counts) <= {"equalize"}, f"{name} launched {counts}: want equalize alone")
            if "predict" in name:
                index = "index.csv" if "seg" in name else "predictions.csv"
                with open(os.path.join(out["out"], index)) as f:
                    served = list(csv.DictReader(f))
                require(not counts and len(served) == 8
                        and all(r["status"] == "ok" for r in served),
                        f"{name} served {len(served)} images, launches {counts}")
                continue
            exp = argv[argv.index("--exp") + 1]
            log = "".join(open(f).read() for f in glob.glob(
                os.path.join(runs, exp, "**", "log.log"), recursive=True))
            metric = "acc" if "cls" in name else "dice_mean"
            require(np.isfinite(out["loss"]) and np.isfinite(out[metric]),
                    f"{name} stats {out}")
            if "few-shot" in name:
                sampled = re.findall(r"Few-shot training subset: (\d+) samples", log)
                require(len(sampled) == 1 and 1 <= int(sampled[0]) <= BATCH,
                        f"the {name} trainer sampled {sampled}: want one subset, one update")
            elif "converted" in name:
                require("reinitializing fc" in log
                        and "Loaded 60 ResNet tensors (+40 BN state)" in log,
                        f"{name}: the converted resnet18 did not load with its BatchNorm "
                        f"statistics and a fresh fc")
                keys = ckpt.peek_keys(best_cls)
                require(len(keys) == 62 + 40, f"{name}: best_model.npz holds {len(keys)} tensors")
            else:
                keys = ckpt.peek_keys(best_seg)
                require(any(k.startswith("bn/") for k in keys)
                        and all(k.startswith(("params/model/", "bn/")) for k in keys),
                        f"{name}: best_model.npz holds {keys[:4]}...")
    finally:
        os.chdir(cwd)
        os.remove(src)


EXPORT_BATCH = 16


def export_cases(files):
    """(label, family, predict argv, the nextgen_uia ops the exported graph
    holds, whether its program must weigh under 1% of its weights): the
    served forwards the export phase writes. The UNet's 7.3 MB of weights
    are smaller than 100 times its graph (576 nodes) and the align-corners
    taps it holds as constants (0.27 MB at 224 px): its program is held to
    holding no weight instead."""
    return (("BiomedCLIP cls, hybrid MONA", "biomedclip",
             ["--task", "cls", "--mona_variant", "hybrid", "--backbone_ckpt", files["backbone"],
              "--mona_weights", files["mona"]], ["block_fwd", "mona_spatial"], True),
            ("DINOv2 seg, 518 px", "dino", ["--task", "seg"], ["flash_fwd", "mlp"], True),
            ("CLIPSeg seg", "clipseg", ["--task", "seg"], ["block_fwd", "flash_fwd"], True),
            ("UNet seg, BatchNorm statistics as arguments", "baselines", ["--task", "seg"], [],
             False))


FRESH_LOAD = r"""
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
import nextgen_uia_tpu_torch.ops  # the documented import: the nextgen_uia:: ops
from nextgen_uia_tpu_torch.ops import fused_block
from nextgen_uia_tpu_torch.tasks.serve import load_exported_params
with open(sys.argv[2], "rb") as f:
    program = torch.export.load(f)
weights = load_exported_params(sys.argv[2] + ".params.npz", device="cuda")
images = torch.from_numpy(np.load(sys.argv[3])).cuda()
with torch.no_grad():
    out = program.module()(weights, images)
np.save(sys.argv[4], out.float().cpu().numpy())
print(f"launches {fused_block.fused_block_infer.launches}")
"""


def export_phase(dev, work, files):
    """Each of ``export_cases`` through the predict CLI's own model and
    export (tasks/serve.py::build_served, export_program) on the card at
    batch EXPORT_BATCH: the program loaded back, the nextgen_uia:: ops in its
    graph exactly the expected set, its bytes under 1% of its weights', its
    output on a seeded batch against the live make_infer forward (kernels)
    and the plain route, export seconds, the exported call against the live
    call (CUDA events); then the first program loaded in a fresh process
    with only the documented import."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.ops import PLAIN, registry
    from nextgen_uia_tpu_torch.tasks import serve
    from nextgen_uia_tpu_torch.tasks.common import seed_everything

    first = None
    for label, family, argv, want_ops, small in export_cases(files):
        args = serve.predict_args(family, ["--images", work, "--device", "cuda",
                                           "--batch_size", str(EXPORT_BATCH),
                                           "--export", f"{family}.pt2", *argv])
        served = serve.build_served(family, args, dev, seed_everything(args.seed))
        infer = serve.make_infer(served.forward, served.params, dev)
        reset_counts()
        t0 = time.perf_counter()
        path, wpath, size = serve.export_program(
            lambda x: served.forward(served.params, x), served.export_tree, args, work, dev)
        export_s = time.perf_counter() - t0
        launched = {k: v for k, v in read_counts().items() if v}
        with open(path, "rb") as f:
            program = torch.export.load(f)
        ops = registry.graph_ops(program.graph)
        state = served.export_tree.state_dict()
        wbytes = sum(t.numel() * t.element_size() for t in state.values())
        shapes = {tuple(t.shape) for t in state.values() if t.dim()}
        consts = [tuple(t.shape) for t in program.constants.values() if torch.is_tensor(t)]
        weights = serve.load_exported_params(wpath, device=dev)
        x = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, (EXPORT_BATCH, args.img_size, args.img_size), dtype=np.uint8)).to(dev)
        with torch.no_grad():
            call = program.module()
            got = call(weights, x).float()
            live = infer(x).float()
            plain = infer(x, ops=PLAIN).float()
        scale = max(1.0, plain.abs().max().item())
        d_live = (got - live).abs().max().item()
        d_plain = (got - plain).abs().max().item()
        with torch.no_grad():
            ms = cuda_ms(lambda: call(weights, x), 5)
        live_ms = cuda_ms(lambda: infer(x), 5)
        print(f"export {label}: {export_s:.1f} s (host clock: trace, save, load-back probe; "
              f"the probe's launches {launched}), {size} bytes = {100 * size / wbytes:.4f}% of "
              f"its {wbytes} bytes of weights, constants {consts}; nextgen_uia ops {ops}; output "
              f"{tuple(got.shape)} vs live max|d| {d_live:.3e}, vs plain max|d| {d_plain:.3e} "
              f"(max|ref| {scale:.3f}); exported call {ms:.2f} ms, live {live_ms:.2f} ms "
              f"(CUDA events)")
        require(ops == sorted(want_ops), f"{label}: exported ops {ops}, want {sorted(want_ops)}")
        require(not program.state_dict and not shapes & set(consts),
                f"{label}: the program holds weights")
        require(size < 0.01 * wbytes or not small, f"{label}: the program weighs {size} bytes")
        require(torch.isfinite(got).all().item(), f"{label}: non-finite exported output")
        require(d_live <= BF16_BOUND * scale, f"{label}: exported output disagrees with live")
        require(d_plain <= BF16_BOUND * scale, f"{label}: exported output disagrees with plain")
        if first is None:
            first = (path, x, got)
        del served, infer, program, call, weights
        torch.cuda.empty_cache()

    path, x, got = first
    np.save(os.path.join(work, "images.npy"), x.cpu().numpy())
    out_npy = os.path.join(work, "fresh.npy")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", FRESH_LOAD, ROOT, path,
                          os.path.join(work, "images.npy"), out_npy],
                         capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"fresh-process load failed: {res.stderr[-2000:]}")
    d = float(np.abs(np.load(out_npy) - got.cpu().numpy()).max())
    print(f"export: fresh process (import nextgen_uia_tpu_torch.ops only) loaded {path}, "
          f"{res.stdout.strip()}, max|d| vs this process {d:.3e}, "
          f"{time.perf_counter() - t0:.1f} s (host clock, the library built again)")
    require(d <= BF16_BOUND * max(1.0, float(got.abs().max())),
            "the fresh-process output disagrees")


def distributed_phase(dev, files):
    """The sharded train step (core/train.py::make_sharded_train_step) on a
    world of 1 under NCCL, forced sharded, on the supervised BiomedCLIP seg
    step with the kernels and no dropout: its loss, gradient norm and
    updated adapters held against the plain TrainStep on the same batch
    from the same weights. Several ranks or a model axis need more cards
    than this machine has."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nextgen_uia_tpu_torch.core import mesh as M
    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, make_forward
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    args = base_parser("chip_smoke").parse_args([
        "--mona_variant", "hybrid", "--num_classes", str(SEG_CLASSES), "--img_size", str(IMG),
        "--backbone_ckpt", files["backbone"], "--mona_weights", files["mona"],
        "--head_weights", files["head"]])
    cfg, hcfg, params = _build_supervised(args, "biomedclip", "seg",
                                          torch.Generator().manual_seed(1))
    trainable, _ = partition(params, by_keywords("head", "mona", "lora"))
    params.to(dev)
    start = {k: p.detach().clone() for k, p in trainable.items()}
    forward = make_forward(cfg, hcfg, train=True)
    imgs, masks = disc_batch(np.random.default_rng(3), BATCH)
    batch = {"image": torch.from_numpy(imgs).to(dev)[None],
             "mask": torch.from_numpy(masks).to(dev)[None]}

    def loss_fn(mb, gen):
        logits, m = forward(params, mb["image"], mb["mask"], None)
        return dice_ce_loss(logits, m)

    tcfg = T.TrainConfig(lr=1e-4, total_updates=10)
    results = {}
    with environ(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(29500 + os.getpid() % 1000)):
        t0 = time.perf_counter()
        mesh = M.make_mesh(1, 1, device="cuda")
        init_s = time.perf_counter() - t0
        try:
            require(mesh.distributed and dist.get_backend() == "nccl" and mesh.world == 1,
                    "the distributed phase did not start an NCCL group of one")
            steps = {}
            for kind in ("plain", "repeat", "sharded"):
                with torch.no_grad():
                    for k, p in trainable.items():
                        p.copy_(start[k])
                opt = T.make_optimizer(trainable.values(), tcfg)
                step = steps[kind] = (T.make_sharded_train_step(loss_fn, opt, tcfg, mesh)
                                      if kind == "sharded" else T.TrainStep(loss_fn, opt, tcfg))
                reset_counts()
                m = step(batch)
                torch.cuda.synchronize()
                counts = read_counts()
                results[kind] = (m, {k: p.detach().float().clone()
                                     for k, p in trainable.items()}, counts,
                                 {k: p.grad.float().clone() for k, p in trainable.items()})
            # host-bound steps spread: time the two in turns
            times = [(kind, cuda_ms(lambda: steps[kind](batch), 5, warmup=1))
                     for _ in range(3) for kind in ("plain", "sharded")]
        finally:
            dist.destroy_process_group()
    (mp, wp, cp, gp), (ms_, ws, cs, gs) = results["plain"], results["sharded"]
    dg = max((gs[k] - gp[k]).abs().max().item() for k in gp)
    # the same plain step twice: bf16 rounding after the seg head's
    # upsampling backward, which sums with atomics, in any order
    repeat = max((results["repeat"][3][k] - gp[k]).abs().max().item() for k in gp)
    g_max = max(g.abs().max().item() for g in gp.values())
    # AdamW's first step moves a weight by about the rate times its
    # gradient's sign, so a gradient that is zero but for rounding (the seg
    # head's upsampling backward sums with atomics) may move either way:
    # the updates are held on the mean
    dw = np.mean([(ws[k] - wp[k]).abs().mean().item() for k in wp])
    moved = np.mean([(wp[k] - start[k].float()).abs().mean().item() for k in wp])
    print(f"distributed: NCCL group of 1 in {init_s:.2f} s; sharded step loss {ms_['loss']:.6f} "
          f"grad norm {ms_['grad_norm']:.6f}, plain {mp['loss']:.6f} / {mp['grad_norm']:.6f}; "
          f"gradients max|d| {dg:.3e} (the plain step again: {repeat:.3e}; max|g| {g_max:.3e}); "
          f"updated trainables mean|d| "
          f"{dw:.3e} (the update moved them {moved:.3e} on the mean); launches "
          f"{({k: v for k, v in cs.items() if v})}; steps in turns (CUDA events, 5 a window) "
          + ", ".join(f"{k} {t:.2f}" for k, t in times) + " ms (world 1: the all-reduce of one "
          "rank). FSDP (n_model > 1) and world > 1 need more than one card")
    require(cs == cp and sum(cs.values()) > 0, f"launches differ: sharded {cs}, plain {cp}")
    require(abs(ms_["loss"] - mp["loss"]) <= 1e-6 * abs(mp["loss"]), "sharded loss disagrees")
    require(abs(ms_["grad_norm"] - mp["grad_norm"]) <= 1e-5 * mp["grad_norm"],
            "sharded gradient norm disagrees")
    require(dg <= max(3 * repeat, 1e-3 * g_max), "sharded gradients disagree with the plain step")
    require(dw <= 1e-2 * moved, "sharded update disagrees with the plain step")


def main():
    if not os.path.isfile(os.path.join(ROOT, "nextgen_uia_tpu_torch", "__init__.py")):
        raise SystemExit("chip_smoke: the nextgen_uia_tpu_torch package is not beside "
                         "this script; run it from a checkout of the repository")
    preset = [k for k in ("NEXTGEN_UIA_FUSED_MONA", "NEXTGEN_UIA_FUSED_BLOCK_BERT")
              if k in os.environ]
    if preset:
        raise SystemExit(f"chip_smoke: unset {', '.join(preset)}: each phase selects its own "
                         f"routes and checks what they launch")
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

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s (host clock)")
        return out

    results = timed("kernels", kernel_phase, dev)
    timed("augment", augment_phase, dev)
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches, files = timed("slice", slice_phase, dev, work)
        launches = {**timed("train", train_phase, dev, files), **launches}
        dino = timed("dino", dino_phase, dev)
        launches.update({k: dino[k] for k in NEW_KERNELS})
        finetune = timed("finetune", finetune_phase, dev)
        launches.update({k: finetune[k] for k in ("flash_attention_backward",
                                                  "fused_block_infer_causal")})
        launches.update(timed("biomedclip", biomedclip_finetune_phase, dev))
        # both at 6 of the 12 blocks and layers, to keep the run's time
        launches["fused_mlp_backward"] = timed(
            "text LoRA 6 of 6", text_lora_phase, dev, 6)["fused_mlp_backward"]
        launches["fused_ln_qkv_rawx_backward"] = timed(
            "text LoRA 3 of 6", text_lora_phase, dev, 3)["fused_ln_qkv_rawx_backward"]
        # K4: no product path calls it, in either package
        launches.update(dwconv7_per_sample=0, dwconv7_per_sample_backward=0)
        launches["fused_block_infer_quick_gelu"] = timed("zero-shot", zero_shot_phase, dev)
        launches.update(timed("bench", bench_phase, dev))
        timed("bench modes", bench_modes_phase, dev)
        launches.update(timed("clipseg", clipseg_phase, dev))
        lora = timed("supervised LoRA", supervised_lora_phase, dev, work, files)
        timed("baselines", baselines_phase, dev)
        converted = timed("convert", convert_phase, work)
        launches.update(timed("full", full_finetune_phase, dev, converted))
        timed("trainer CLIs", cli_phase, dev, work, files)
        timed("finetune CLIs", lambda: [finetune_cli_phase(work),
                                        biomedclip_finetune_cli_phase(work),
                                        text_lora_cli_phase(work),
                                        full_finetune_cli_phase(work, converted)])
        timed("CLIP family CLIs", clip_cli_phase, work)
        timed("CLIPSeg, few-shot and LoRA CLIs", adapter_cli_phase, work, files, lora)
        timed("baselines CLIs", baselines_cli_phase, work)
        timed("export", export_phase, dev, work, files)
        timed("distributed", distributed_phase, dev, files)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    csrc, jax_ops = "nextgen_uia_tpu_torch/csrc/", "nextgen_uia_tpu/ops/"
    source = {"fused_block_infer": ("fused_block.cu", "fused_block.py:78"),
              "fused_block_infer_quick_gelu": ("fused_block.cu", "fused_block.py:78"),
              "mona_spatial": ("mona_spatial.cu", "dwconv.py:156"),
              "mona_spatial_backward": ("mona_spatial.cu", "dwconv.py:171"),
              "fused_ln_qkv": ("fused_ln_qkv.cu", "fused_ln_qkv.py:36"),
              "fused_ln_qkv_backward": ("fused_ln_qkv.cu", "fused_ln_qkv.py:60"),
              "fused_attn_o_residual": ("fused_attn_o.cu", "fused_attn_o.py:51"),
              "fused_attn_o_residual_backward": ("fused_attn_o.cu", "fused_attn_o.py:83"),
              "fused_ln_mlp_residual": ("fused_ln_mlp.cu", "fused_ln_mlp.py:29"),
              "fused_ln_mlp_residual_backward": ("fused_ln_mlp.cu", "fused_ln_mlp.py:49"),
              "flash_attention": ("flash_attention.cu", "flash_attention.py:64"),
              "flash_attention_backward": ("flash_attention.cu", "flash_attention.py:73"),
              "fused_block_infer_causal": ("fused_block.cu", "fused_block.py:78"),
              "fused_mlp": ("fused_mlp.cu", "fused_mlp.py:64"),
              "lut_apply": ("lut.cu", "lut.py:53"),
              "hist256": ("lut.cu", "lut.py:143"),
              "equalize": ("lut.cu", "lut.py:53, " + jax_ops + "lut.py:143"),
              "fused_ln_qkv_rawx": ("hopper_gemm.cuh", "fused_ln_qkv.py:36"),
              "fused_attn_o_residual_postln": ("fused_attn_o.cu", "fused_attn_o.py:73"),
              "fused_postnorm_mlp_ln": ("fused_ln_mlp.cu", "fused_ln_mlp.py:144"),
              "fused_block_infer_postnorm": ("fused_block.cu", "fused_block.py:78"),
              "mona_block_fused": ("fused_mona.cu", "fused_mona.py:132"),
              "mona_block_fused_backward": ("fused_mona.cu", "fused_mona.py:155"),
              "fused_attn_block": ("fused_attention.cu", "fused_attention.py:52"),
              "fused_attn_block_backward": ("fused_attention.cu", "fused_attention.py:73"),
              "fused_mlp_backward": ("fused_mlp.cu", "fused_mlp.py:79"),
              "fused_ln_qkv_rawx_backward": ("hopper_gemm.cuh", "fused_ln_qkv.py:60"),
              "dwconv7_per_sample": ("mona_spatial.cu", "dwconv.py:60"),
              "dwconv7_per_sample_backward": ("mona_spatial.cu", "dwconv.py:72"),
              "flash_attention_full": ("flash_attention.cu", "flash_attention.py:64"),
              "flash_attention_full_backward": ("flash_attention.cu", "flash_attention.py:73"),
              "flash_attention_causal": ("flash_attention.cu", "flash_attention.py:64"),
              "flash_attention_causal_backward": ("flash_attention.cu",
                                                  "flash_attention.py:73"),
              "flash_attention_bert": ("flash_attention.cu", "flash_attention.py:64"),
              "flash_attention_bert_backward": ("flash_attention.cu", "flash_attention.py:73"),
              "flash_attention_bert_cache": ("flash_attention.cu", "flash_attention.py:64"),
              "fused_mlp_text": ("fused_mlp.cu", "fused_mlp.py:64"),
              "fused_attn_o_residual_causal": ("fused_attn_o.cu", "fused_attn_o.py:51"),
              "fused_attn_o_residual_causal_backward": ("fused_attn_o.cu", "fused_attn_o.py:83"),
              "flash_attention_f32_dh16": ("flash_attention.cu", "flash_attention.py:64"),
              "flash_attention_f32_dh16_backward": ("flash_attention.cu",
                                                    "flash_attention.py:73")}
    kernels = [dict(name=name, route="cuda", source=csrc + src, replaces=jax_ops + rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in source.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
