#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the toolchain.
2. Builds the port's CUDA kernels (nextgen_uia_tpu_torch/csrc, one nvcc
   per source, sm_90a, all started together).
3. Kernel phase: each kernel, forward and backward, against its plain
   PyTorch version on the card, at the main paths' shapes ([32, 197, 768],
   12 heads, hidden 3072; MONA [32, 14, 14, 64]; flash attention [24, 12,
   1370, 64] and the fused MLP [32880, 768] x 3072, DINOv2-B/14 at 518 px;
   the flash-attention backward at the LoRA fine-tune's [16, 197, 12, 64]
   and at [24, 12, 1370, 64]; the causal text block [256, 77, 512], 8
   heads; the lookup and histogram [24, 518, 518]; BERT's post-norm
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
   post-LN, on K7 and the Hopper GEMM core in bf16, with their kernels'
   device time alone and no WMMA GEMM and no SIMT attention kernel in a
   bf16 call, K1 beside torch.nn.TransformerEncoderLayer holding the same
   weights under inference_mode, and whether its fast path ran; K5
   pre-norm, on the Hopper GEMM core in bf16, at [64, 197, 768], [32, 197,
   768], [3, 37, 768] and [1, 1, 768], its bf16 backward bitwise equal over
   two calls, timed op and kernels alone; K12 in each of its four variants,
   its bf16 products on wgmma, the hybrid one timed op and kernels alone;
   no bf16 call of K5 or K12 reaching the WMMA GEMM, colgemm_kernel or
   mona_down_kernel), with
   CUDA-event times and the bound from the card's peak rates:
   float32 max|d| <= 1e-4 * max|ref| for every output; bfloat16 against
   the float32 plain version on the bf16-rounded inputs max|d| <= 3e-2 *
   max(1, max|ref|) (3e-2 * max|ref| for the flash-attention output and
   gradients); the lookup and histogram exactly equal. K12 and K11 against
   their plain versions on the same inputs (float32 1e-4 * max|ref|, bf16
   3e-2 * max|ref|; K12's parameter gradients min(1e-4 * the largest
   max|ref|, 3e-2 * their own) in float32), K12's backward bitwise equal
   over two calls. The post-norm epilogues' backwards, plain
   recompositions with no kernel of their own, timed per layer.
4. Augmentation phase: one strong+weak plan at [32, 224, 224] and at [24,
   518, 518] through the kernels and through the plain versions (images and
   masks equal; lookup/histogram launches = the slots that drew equalize).
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
   ``--tune_text_encoder`` with LoRA (r=16, alpha 32, dropout 0.1) in all
   12 blocks and layers of both towers, and in the first 6: one update
   with the text in the step (seeded ids with a padded tail, a 256-token
   bucket): launch counts derived from the code (K10's backward 48 and
   24, K5 raw-x's backward 0 and 24), loss and gradient norm against the
   plain path, in float32 the loss and every LoRA and bias gradient, the
   loss falling over 10 updates, ms per update, a profiler table.
10. Bench phase: the port's headline step (nextgen_uia_tpu_torch/bench.py,
   the JAX bench.py's step: BiomedCLIP ViT-B/16 with hybrid MONA in 12
   blocks, cached text, batch 64 as one microbatch, bf16) by the composed
   route, the fused MONA route (K12), and with it the fused (K11) and the
   hybrid attention block: launch counts, ms and img/s, the device's busy
   share, peak memory, no WMMA GEMM, colgemm_kernel or mona_down_kernel in
   the profile; in float32 the fused route on the kernels against
   the composed plain path (loss, every MONA tensor); bench.main's JSON.
11. CLI phase: the BiomedCLIP and DINOv2 seg trainers at their default
   augmentation, the predict CLIs on their best_model.npz, both cls
   trainers, the OpenAI LoRA fine-tune CLI, the BiomedCLIP MONA fine-tune
   CLI and the BiomedCLIP LoRA fine-tune CLI with --tune_text_encoder
   --lora_layers 6 (one epoch each).
12. Prints each phase's host seconds, one JSON line of per-kernel results
   (27 rows), then the final status line.

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
BF16_BOUND, F32_BOUND = 3e-2, 1e-4


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of flops at the bf16 tensor-core peak
    and bytes at the memory rate."""
    t_ops, t_mem = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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

    # K2/K3: the MONA spatial op, forward and backward, [32, 14, 14, 64] and
    # an odd [3, 9, 11, 24]
    def mona_args(bb, hh, ww, c, last):
        return [randn(bb, hh, ww, c), 1 + randn(c, scale=0.3), randn(bb, 7, 7, c, scale=0.2),
                randn(*last(bb, hh, ww, c))]

    g2 = cfg.grid
    px = b * g2 * g2 * 64
    check("mona_spatial", dwconv.mona_spatial, dwconv.mona_spatial_plain,
          mona_args(b, g2, g2, 64, lambda bb, hh, ww, c: (bb, c)),
          mona_args(3, 9, 11, 24, lambda bb, hh, ww, c: (bb, c)),
          (2 * 49 * px, 2 * (2 * px + b * 50 * 64 + 64)),
          library=lambda s, f, k, _: F.conv2d(
              s.permute(3, 0, 1, 2).reshape(1, -1, g2, g2),
              k.permute(3, 0, 1, 2).reshape(-1, 1, 7, 7), padding=3, groups=s.shape[0] * 64))
    check("mona_spatial_backward", dwconv.mona_spatial_backward,
          dwconv.mona_spatial_backward_plain,
          mona_args(b, g2, g2, 64, lambda *sh: sh), mona_args(3, 9, 11, 24, lambda *sh: sh),
          (4 * 49 * px, 2 * 3 * px + 4 * b * 51 * 64 + 2 * 64))

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

    # K13: the table lookup and the histogram, exactly equal to their plain
    # versions at [24, 518, 518] and an odd [3, 37, 41]
    def exact(name, kern, plain, inputs, odd_inputs, nbytes):
        with torch.no_grad():
            for args in (inputs, odd_inputs):
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"{name} differs from its plain version")
            ms = cuda_ms(lambda: kern(*inputs), 20)
            plain_ms = cuda_ms(lambda: plain(*inputs), 5, warmup=1)
        b_ms, b_by = bound(0, nbytes)
        print(f"{name}: equal to the plain version (main and odd shape); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library -, bound {b_ms:.4f} ms ({b_by})")
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by)

    def images(shape):
        x = torch.rand(shape, generator=gen).to(dev)
        return torch.round(x * 255) / 255  # on the byte grid, as augmentation keeps them

    big, odd = images((db, DINO_IMG, DINO_IMG)), images((3, 37, 41))
    hw = DINO_IMG * DINO_IMG
    exact("hist256", lut.hist256, lut.hist256_plain, [big], [odd], db * hw * 4 + db * 256 * 4)
    tables = [torch.randint(0, 256, (n, 256), generator=gen, dtype=torch.int32).to(dev)
              for n in (db, 3)]
    exact("lut_apply", lut.lut_apply, lut.lut_apply_plain, [big, tables[0]], [odd, tables[1]],
          2 * db * hw * 4 + db * 256 * 4)
    bert_kernel_rows(dev, gen, check)
    text_lora_kernel_rows(dev, gen, check)
    fused_kernel_rows(dev, gen, results)
    k6_k8_rows(dev, block(d, h))
    k5_rows(dev, block(d, h))
    return results


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


def hopper_kernels_ms(name, fn, kernels=("gemm", "flash", "layernorm")):
    """(device ms per call of fn's kernels alone, {kernel: ms per call},
    what the check saw): the profiler's kernels whose names hold one of
    ``kernels``. A bf16 call must run its products on hopper_gemm.cuh's core
    (or another wgmma kernel) and its attention on K7's wgmma kernels: a
    kernel of OLD_KERNELS (the WMMA GEMM, a SIMT attention, K12's SIMT
    products) fails the run; a window with no device activity leaves that
    check unmade and says so."""
    seen = {}
    ms = kernel_device_ms(fn, kernels, seen=seen)
    bad = sorted(k[:60] for k in seen if any(old in k for old in OLD_KERNELS))
    require(not bad and (not seen or any("hopper::gemm_kernel" in k for k in seen)),
            f"{name} bf16 ran {bad or 'no Hopper GEMM'}: every product must run on "
            f"wgmma and the attention on K7's wgmma kernels")
    return ms, seen, ("no WMMA GEMM, no SIMT product or attention" if seen else
                      "WMMA check not made: the profiler recorded no device activity")


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
          (2 * 49 * px, 2 * (2 * px + kb * 49 * kc)), library=grouped_conv)
    xg, kg, gg = (t.to(torch.bfloat16).requires_grad_() for t in conv_args(kb, kh, kh, kc, True))
    y = grouped_conv(xg, kg)
    g_conv = gg.detach().permute(3, 0, 1, 2).reshape(y.shape)
    check("dwconv7_per_sample_backward", dwconv.dwconv7_per_sample_backward,
          dwconv.dwconv7_per_sample_backward_plain, conv_args(kb, kh, kh, kc, True),
          conv_args(3, 9, 11, 24, True), (4 * 49 * px, 2 * (3 * px + 2 * kb * 49 * kc)),
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
    plain versions: images and masks equal, the lookup and histogram
    launched once per slot that drew equalize; ms per batch (CUDA events
    around augment_batch, the plan's host read included)."""
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
        require(counts["lut_apply"] == counts["hist256"] == slots,
                f"augmentation at {size} px launched lut_apply {counts['lut_apply']} and "
                f"hist256 {counts['hist256']} times for {slots} equalize slots")
        gen = torch.Generator(device=dev).manual_seed(1)
        ms = cuda_ms(lambda: aug.augment_batch(gen, x, m, out_size=size), 10)
        plain_ms = cuda_ms(lambda: aug.augment_batch(gen, x, m, out_size=size, ops=PLAIN), 5,
                           warmup=1)
        print(f"augment [{b}, {size}, {size}]: kernel path equals plain path; {slots} equalize "
              f"slots, lookup/histogram launches {counts['lut_apply']}/{counts['hist256']}; "
              f"{ms:.2f} ms per batch (plain lookups {plain_ms:.2f} ms)")


def slice_phase(dev, work):
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.core import checkpoint as ckpt
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
    from nextgen_uia_tpu_torch.ops import PLAIN
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
NEW_KERNELS = ("flash_attention", "fused_mlp", "lut_apply", "hist256")  # the DINOv2 path's
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
           fused_mlp.fused_mlp, lut.lut_apply, lut.hist256, fused_ln_qkv.fused_ln_qkv_rawx,
           fused_attn_o.fused_attn_o_residual_postln, fused_ln_mlp.fused_postnorm_mlp_ln,
           fused_block.fused_block_infer_postnorm, fused_mona.mona_block_fused,
           fused_mona.mona_block_fused_backward, fused_attention.fused_attn_block,
           fused_attention.fused_attn_block_backward, fused_mlp.fused_mlp_backward,
           fused_ln_qkv.fused_ln_qkv_rawx_backward, dwconv.dwconv7_per_sample,
           dwconv.dwconv7_per_sample_backward]
    return {f.__name__: f for f in fns}


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
    from nextgen_uia_tpu_torch.data.augment import augment_batch
    from nextgen_uia_tpu_torch.losses import dice_ce_loss
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.tasks.clip_tasks import _build_supervised, _make_forward
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    args = base_parser("chip_smoke").parse_args([
        "--mona_variant", "hybrid", "--num_classes", str(SEG_CLASSES), "--img_size", str(IMG),
        "--backbone_ckpt", files["backbone"], "--mona_weights", files["mona"],
        "--head_weights", files["head"]])
    cfg, hcfg, params = _build_supervised(args, "biomedclip", "seg",
                                          torch.Generator().manual_seed(1))
    trainable, frozen = partition(params, by_keywords("head", "mona", "lora"))
    params.to(dev)
    forward = _make_forward(cfg, hcfg, train=True)
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
    forward = _make_forward(cfg.replace(compute_dtype="float32"), hcfg, train=True)
    loss32_k, g32_k = grads(KERNELS)
    loss32_p, g32_p = grads(PLAIN)
    forward = _make_forward(cfg, hcfg, train=True)
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
    forward_aug = _make_forward(cfg, hcfg, train=True, strong=True, weak=True)

    def aug_loss(mb, gen_):
        logits, m = forward_aug(params, mb["image"], mb["mask"], gen_)
        return dice_ce_loss(logits, m)

    aug_step = T.TrainStep(aug_loss, opt, tcfg)
    reset_counts()
    aug_loss_value = aug_step(batch, gen)["loss"]
    torch.cuda.synchronize()
    aug_counts = read_counts()
    require(np.isfinite(aug_loss_value), "non-finite augmented train loss")
    for name, want in TRAIN_LAUNCHES.items():
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
    (K7 and K10 12 each, K5 0, the lookup and histogram once per slot that
    drew equalize), the first step's loss and every head gradient against
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
    want = {**DINO_LAUNCHES, "lut_apply": eq_slots, "hist256": eq_slots}
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
    and the 12-layer PubMedBERT (ctx 256) with LoRA r=16, alpha 32, dropout
    0.1 in the first ``lora_layers`` blocks and layers of both towers (built
    through build_clip_model as the CLI builds it, the b matrices drawn
    nonzero), bf16, batch 64 as 4 x 16, AdamW (0.9, 0.95), clip 1.0, the
    text of seeded ids (lengths 16-256, padded tail) encoded in the step
    and trimmed to its 32-token bucket. One update's launch counts against
    text_lora_launches; its loss and gradient norm against the plain path
    (bf16), and in float32 the loss and each LoRA and bias gradient; the
    loss falling over 10 updates with dropout on; ms per update, img/s,
    peak memory, the busy share. Returns the launch counts."""
    import numpy as np
    import torch

    from nextgen_uia_tpu_torch.core import train as T
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.losses import info_nce
    from nextgen_uia_tpu_torch.models import clip as clip_mod
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model

    tag = f"text LoRA ({lora_layers} layers)"
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
    attns = [blk.attn for blk in params.visual.blocks] + [ly.attn for ly in params.text.layers]
    with torch.no_grad():
        for attn in attns:
            for pair in (attn.lora.children() if "lora" in attn._modules else ()):
                pair.b.normal_(0.0, 0.02, generator=gen)
    n_lora = sum("lora" in a._modules for a in attns)
    require(n_lora == 2 * lora_layers, f"LoRA in {n_lora} attentions, want {2 * lora_layers}")
    trainable, frozen = partition(params, ft.lora_trainable_predicate(params))
    params.to(dev)
    print(f"{tag}: built ViT-B/16 and the 12-layer PubMedBERT with LoRA in {n_lora} "
          f"attentions in {time.perf_counter() - t0:.1f} s; {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values())} values), {len(frozen)} frozen")

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
        launches["fused_mlp_backward"] = timed(
            "text LoRA 12", text_lora_phase, dev, 12)["fused_mlp_backward"]
        launches["fused_ln_qkv_rawx_backward"] = timed(
            "text LoRA 6", text_lora_phase, dev, 6)["fused_ln_qkv_rawx_backward"]
        # K4: no product path calls it, in either package
        launches.update(dwconv7_per_sample=0, dwconv7_per_sample_backward=0)
        launches.update(timed("bench", bench_phase, dev))
        timed("trainer CLIs", cli_phase, dev, work, files)
        timed("finetune CLIs", lambda: [finetune_cli_phase(work),
                                        biomedclip_finetune_cli_phase(work),
                                        text_lora_cli_phase(work)])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    csrc, jax_ops = "nextgen_uia_tpu_torch/csrc/", "nextgen_uia_tpu/ops/"
    source = {"fused_block_infer": ("fused_block.cu", "fused_block.py:78"),
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
              "dwconv7_per_sample_backward": ("mona_spatial.cu", "dwconv.py:72")}
    kernels = [dict(name=name, route="cuda", source=csrc + src, replaces=jax_ops + rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in source.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
