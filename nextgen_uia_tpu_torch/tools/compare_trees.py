"""Time a kernel in this checkout and in another one, in turns, on one card:

    python -m nextgen_uia_tpu_torch.tools.compare_trees OTHER_CHECKOUT [k1|k6|k7|k8|k11|bench]

OTHER_CHECKOUT is a second copy of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Each turn is a fresh
process that builds that tree's kernels, in the order other, this, this,
other. ``k1`` (the default) prints three CUDA-event means of 20 calls of
``fused_block_infer`` at [32, 197, 768] bf16, 12 heads. ``k7`` prints, for
the flash-attention forward and backward at each of ``K7_SHAPES`` in bf16:
the op's CUDA-event mean over back-to-back calls through the wrapper (its
host time included) and its kernels' device time alone (torch.profiler,
the sum of every kernel whose name holds "flash" per call). ``k11`` prints
the same for the attention block's forward and dx backward
(``fused_attn_block``, ``fused_attn_block_backward``) at each of
``K11_SHAPES`` in bf16, its kernels being every one whose name holds
"gemm" or "flash". ``k6`` and ``k8`` print the same for K6 (attention +
o-projection + residual, ``fused_attn_o_residual`` and its backward) and K8
(LayerNorm + MLP + residual, ``fused_ln_mlp_residual`` and its backward) at
each of ``BLOCK_SHAPES`` in bf16, their kernels being every one whose name
holds "gemm", "flash", "attention" or "layernorm". ``bench`` prints the
port's bench step (batch 64, bf16) by each of ``BENCH_ROUTES``: the default
route (``attn_impl='auto'``, composed MONA), ``auto`` with fused MONA, and
with fused MONA the K11 and the hybrid attention block, CUDA-event ms per
step over three 10-step windows each. The timing scripts import nothing of
this module, since they run in the other tree.
"""

from __future__ import annotations

import os
import subprocess
import sys

K7_SHAPES = (  # (B, H, N, layout, key bias): DINOv2 at 518 px, then the path shapes
    (24, 12, 1370, "bhnd", False),  # the yardstick: DINOv2's N > 512 route
    (16, 12, 197, "bnhd", True),    # OpenAI/MetaCLIP LoRA microbatch (mha's LoRA route)
    (64, 12, 197, "bhnd", False),   # the bench step's K11 and hybrid routes
    (16, 12, 256, "bnhd", True))    # --tune_text_encoder's PubMedBERT LoRA layers

K11_SHAPES = (  # (B, N, D, heads, causal, key bias): the bench step's, the causal case
    (64, 197, 768, 12, False, True),
    (16, 77, 512, 8, True, False))

BLOCK_SHAPES = ((64, 197, 768, 12), (32, 197, 768, 12))  # the bench step's, the supervised step's

BENCH_ROUTES = (("auto", "0"), ("auto", "1"), ("fused_block", "1"), ("hybrid_block", "1"))

K1 = r'''
import sys, torch
sys.path.insert(0, ".")
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import build, fused_block as fb
build.build(); build.library()
g = torch.Generator().manual_seed(0)
blk = Block(g, ViTConfig(width=768, heads=12)).cuda()
x = torch.randn(32, 197, 768, generator=g).cuda().to(torch.bfloat16)
kw = dict(heads=12, act="gelu", eps=1e-6)
with torch.no_grad():
    for _ in range(3):
        fb.fused_block_infer(x, blk, **kw)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    res = []
    for _ in range(3):
        s.record()
        for _ in range(20):
            fb.fused_block_infer(x, blk, **kw)
        e.record()
        torch.cuda.synchronize()
        res.append(s.elapsed_time(e) / 20)
print("K1_MS", " ".join(f"{r:.4f}" for r in res))
'''

TIMERS = r'''
import sys, torch
sys.path.insert(0, ".")
from torch.profiler import ProfilerActivity, profile
from nextgen_uia_tpu_torch.ops import build
build.build(); build.library()
dev, bf16 = torch.device("cuda"), torch.bfloat16

def op_ms(fn, iters):
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters

def kernel_ms(fn, iters, names):
    # a window with no device records (the first in a process can lose
    # them) is profiled again, up to three in all; 0.0 if all came back empty
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and any(name in ev.key for name in names))
        if us > 0:
            break
    return us / 1e3 / iters
'''

K7 = f"SHAPES = {K7_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.ops import flash_attention as fa
for b, h, n, layout, bias in SHAPES:
    g = torch.Generator().manual_seed(n)
    shape = (b, h, n, 64) if layout == "bhnd" else (b, n, h, 64)
    q, k, v, go = (torch.randn(shape, generator=g).to(dev).to(bf16) for _ in range(4))
    kb = torch.randn(b, n, generator=g).to(dev) if bias else None
    iters = 10 if n > 1000 else 50
    with torch.no_grad():
        out, lse = fa.flash_attention_forward(q, k, v, bias=kb, layout=layout)
        fwd = lambda: fa.flash_attention_forward(q, k, v, bias=kb, layout=layout)
        bwd = lambda: fa.flash_attention_backward(q, k, v, out, go, lse, bias=kb, layout=layout,
                                                  bias_grad=False)
        print(f"K7 [{b}, {h}, {n}, 64] {layout} bias={bias}: fwd op {op_ms(fwd, iters):.4f} "
              f"kernel {kernel_ms(fwd, iters, ('flash',)):.4f}; bwd op {op_ms(bwd, iters):.4f} "
              f"kernel {kernel_ms(bwd, iters, ('flash',)):.4f} ms", flush=True)
'''

K11 = f"SHAPES = {K11_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.nn.attention import Attention
from nextgen_uia_tpu_torch.ops import fused_attention as fa
for b, n, d, heads, causal, bias in SHAPES:
    g = torch.Generator().manual_seed(n)
    att = Attention(g, d).to(dev)
    x, go = (torch.randn(b, n, d, generator=g).to(dev).to(bf16) for _ in range(2))
    kb = torch.randn(b, n, generator=g).to(dev) if bias else None
    kw = dict(heads=heads, bias=kb, causal=causal)
    kernels = ("gemm", "flash")
    with torch.no_grad():
        fwd = lambda: fa.fused_attn_block(x, att, **kw)
        bwd = lambda: fa.fused_attn_block_backward(x, att, go, **kw)
        print(f"K11 [{b}, {n}, {d}] {heads} heads causal={causal} bias={bias}: fwd op "
              f"{op_ms(fwd, 20):.4f} kernel {kernel_ms(fwd, 20, kernels):.4f}; bwd op "
              f"{op_ms(bwd, 20):.4f} kernel {kernel_ms(bwd, 20, kernels):.4f} ms", flush=True)
'''

K6 = f"SHAPES = {BLOCK_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_attn_o as fao
for b, n, d, heads in SHAPES:
    g = torch.Generator().manual_seed(n)
    blk = Block(g, ViTConfig(width=d, heads=heads)).to(dev)
    q, k, v = (torch.randn(b, heads, n, d // heads, generator=g).to(dev).to(bf16)
               for _ in range(3))
    x, go = (torch.randn(b, n, d, generator=g).to(dev).to(bf16) for _ in range(2))
    wo = blk.attn.o.w.to(bf16)
    kernels = ("gemm", "flash", "attention")
    with torch.no_grad():
        fwd = lambda: fao.fused_attn_o_residual(q, k, v, x, blk.attn.o, heads=heads)
        bwd = lambda: fao.fused_attn_o_residual_backward(q, k, v, wo, go)
        print(f"K6 [{b}, {n}, {d}] {heads} heads: fwd op {op_ms(fwd, 20):.4f} kernel "
              f"{kernel_ms(fwd, 20, kernels):.4f}; bwd op {op_ms(bwd, 20):.4f} kernel "
              f"{kernel_ms(bwd, 20, kernels):.4f} ms", flush=True)
'''

K8 = f"SHAPES = {BLOCK_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_ln_mlp as flm
for b, n, d, heads in SHAPES:
    g = torch.Generator().manual_seed(n)
    blk = Block(g, ViTConfig(width=d, heads=heads)).to(dev)
    x, go = (torch.randn(b, n, d, generator=g).to(dev).to(bf16) for _ in range(2))
    gamma, beta, w1, b1, w2, _ = flm._weights(blk.ln2, blk.mlp, bf16)
    kernels = ("gemm", "layernorm")
    with torch.no_grad():
        fwd = lambda: flm.fused_ln_mlp_residual(x, blk.ln2, blk.mlp)
        bwd = lambda: flm.fused_ln_mlp_residual_backward(x, gamma, beta, w1, b1, w2, go)
        print(f"K8 [{b}, {n}, {d}] hidden {4 * d}: fwd op {op_ms(fwd, 20):.4f} kernel "
              f"{kernel_ms(fwd, 20, kernels):.4f}; bwd op {op_ms(bwd, 20):.4f} kernel "
              f"{kernel_ms(bwd, 20, kernels):.4f} ms", flush=True)
'''

BENCH = f"ROUTES = {BENCH_ROUTES!r}" + r'''
import dataclasses, os, sys, torch
sys.path.insert(0, ".")
from nextgen_uia_tpu_torch import bench
dev = torch.device("cuda")
bn = bench.build(dev, bench.Knobs())
vision = bn.cfg.vision
for attn, fused in ROUTES:
    os.environ["NEXTGEN_UIA_FUSED_MONA"] = fused
    bn.cfg = bn.cfg.replace(vision=dataclasses.replace(vision, attn_impl=attn))
    step = bn.train_step()
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        step(bn.batch, gen)
    res = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(10):
            step(bn.batch, gen)
        e.record()
        torch.cuda.synchronize()
        res.append(s.elapsed_time(e) / 10)
    mona = "fused MONA" if fused == "1" else "composed MONA"
    print(f"BENCH step, {mona} + {attn}: " + " ".join(f"{r:.2f}" for r in res) + " ms",
          flush=True)
'''

TIMINGS = {"k1": (K1, "K1_MS"), "k6": (K6, "K6 "), "k7": (K7, "K7 "), "k8": (K8, "K8 "),
           "k11": (K11, "K11 "), "bench": (BENCH, "BENCH ")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2 or not os.path.isdir(argv[0]) or (
            len(argv) == 2 and argv[1] not in TIMINGS):
        raise SystemExit("usage: python -m nextgen_uia_tpu_torch.tools.compare_trees "
                         "OTHER_CHECKOUT [k1|k6|k7|k8|k11|bench]")
    script, tag = TIMINGS[argv[1] if len(argv) == 2 else "k1"]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name, tree in (("other", argv[0]), ("this", here), ("this", here),
                       ("other", argv[0])):
        res = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True,
                             text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith(tag)]
        for ln in lines or [res.stderr[-2000:]]:
            print(name, ln, flush=True)


if __name__ == "__main__":
    main()
