"""Time a kernel in this checkout and in another one, in turns, on one card:

    python -m nextgen_uia_tpu_torch.tools.compare_trees OTHER_CHECKOUT [k1|k5|k6|k7|k8|k11|k12|mlp|text|bench]

OTHER_CHECKOUT is a second copy of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Each turn is a fresh
process that builds that tree's kernels, in the order other, this, this,
other. ``k1`` (the default) prints, for the whole-block forward
(``fused_block_infer``) in bf16 at each of ``K1_SHAPES`` (pre-norm at
serving's [32, 197, 768], causal at the CLIP text cache's [256, 77, 512],
post-norm at BERT's [256, 256, 768] with a key-padding bias): the op's
CUDA-event mean, its kernels' device time alone (every kernel whose name
holds "gemm", "flash", "attention" or "layernorm"; the weight copies left
out) and ``torch.nn.TransformerEncoderLayer``'s time holding the same
weights under ``torch.inference_mode``. ``text`` prints the same op and
kernel times for BERT's layer at ``TEXT_SHAPE`` with a key-padding bias: K5
raw-x, K6 post-LN, K9, the three-kernel chain they make, and K1 post-norm.
``k7`` prints, for
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
holds "gemm", "flash", "attention" or "layernorm". ``mlp`` prints the same
for K10 (the MLP with frozen weights, ``fused_mlp``) at each of
``MLP_SHAPES`` in bf16: the forward at DINOv2's [24 * 1370, 768] x 3072 and
the dx backward (``fused_mlp_backward``, W1^T built in the call) at the
BERT LoRA layers' [16 * 256, 768] x 3072, its kernels being every one whose
name holds "gemm". ``k5`` prints the same for K5 pre-norm (LayerNorm + q/k/v,
``fused_ln_qkv`` and its dx backward) at each of ``BLOCK_SHAPES``, its
kernels being every one whose name holds "gemm" or "layernorm". ``k12``
prints the same for K12 (the whole MONA adapter, hybrid, a dropout mask,
``mona_block_fused_forward`` and its full backward) at ``K12_SHAPE``, its
kernels being every one whose name holds "gemm", "mona" or "sum_splits"
(the parameter packing and weight copies left out). ``bench`` prints the
port's bench step (batch 64, bf16) by each of ``BENCH_ROUTES``: the default
route (``attn_impl='auto'``, composed MONA), ``auto`` with fused MONA, and
with fused MONA the K11 and the hybrid attention block, CUDA-event ms per
step over three 10-step windows each. The timing scripts import nothing of
this module, since they run in the other tree.
"""

from __future__ import annotations

import inspect
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

def encoder_layer(p, layout, heads, act, eps):
    """``torch.nn.TransformerEncoderLayer`` (bf16, eval, on the block's
    device) holding the weights of a ViT Block (``layout="prenorm"``,
    ``norm_first``) or a BertLayer: the one library call that computes K1,
    timed beside it and used nowhere in the port."""
    import torch

    pre = layout == "prenorm"
    ln_a, att, ln_b, mlp = ((p.ln1, p.attn, p.ln2, p.mlp) if pre
                            else (p.attn_ln, p.attn, p.ffn_ln, p.ffn))
    d, hid = att.q.w.shape[0], mlp.fc1.w.shape[1]
    fn = "gelu" if act == "gelu" else (lambda t: t * torch.sigmoid(1.702 * t))
    enc = torch.nn.TransformerEncoderLayer(
        d, heads, hid, dropout=0.0, activation=fn, layer_norm_eps=eps, batch_first=True,
        norm_first=pre, device=att.q.w.device, dtype=torch.bfloat16).eval()
    pairs = ((enc.self_attn.in_proj_weight, torch.cat([att.q.w.T, att.k.w.T, att.v.w.T])),
             (enc.self_attn.in_proj_bias, torch.cat([att.q.b, att.k.b, att.v.b])),
             (enc.self_attn.out_proj.weight, att.o.w.T), (enc.self_attn.out_proj.bias, att.o.b),
             (enc.linear1.weight, mlp.fc1.w.T), (enc.linear1.bias, mlp.fc1.b),
             (enc.linear2.weight, mlp.fc2.w.T), (enc.linear2.bias, mlp.fc2.b),
             (enc.norm1.weight, ln_a.scale), (enc.norm1.bias, ln_a.bias),
             (enc.norm2.weight, ln_b.scale), (enc.norm2.bias, ln_b.bias))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return enc


K1_SHAPES = (  # (layout, B, N, D, heads, act, eps, causal): serving, the CLIP and BERT caches
    ("prenorm", 32, 197, 768, 12, "gelu", 1e-6, False),
    ("prenorm", 256, 77, 512, 8, "quick_gelu", 1e-5, True),
    ("postnorm", 256, 256, 768, 12, "gelu", 1e-12, False))

TEXT_SHAPE = (256, 256, 768, 12)  # the BERT text cache's chunk, 12 heads

MLP_SHAPES = (  # (pass, M, D, hidden, act): DINOv2's encoder, the BERT LoRA layers' backward
    ("fwd", 24 * 1370, 768, 3072, "gelu"),
    ("bwd", 16 * 256, 768, 3072, "gelu"))

K12_SHAPE = (64, 197, 768, 14)  # the bench step's: B, N, D, the h = w grid

BENCH_ROUTES = (("auto", "0"), ("auto", "1"), ("fused_block", "1"), ("hybrid_block", "1"))

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

ENCODER = inspect.getsource(encoder_layer) + r'''
def pad_bias(b, n, g):
    # -1e9 on each caption's padded keys, seeded lengths, the last row wholly padded
    lengths = torch.randint(2, n + 1, (b,), generator=g)
    lengths[-1] = 0
    return ((torch.arange(n)[None] >= lengths[:, None]).float() * -1e9).to(dev)
'''

K1 = f"SHAPES = {K1_SHAPES!r}" + TIMERS + ENCODER + r'''
from nextgen_uia_tpu_torch.models.bert import BertConfig, BertLayer
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_block as fb
for layout, b, n, d, heads, act, eps, causal in SHAPES:
    g = torch.Generator().manual_seed(n)
    if layout == "prenorm":
        p = Block(g, ViTConfig(width=d, heads=heads)).to(dev)
    else:
        p = BertLayer(g, BertConfig(width=d, heads=heads, intermediate=4 * d)).to(dev)
    x = torch.randn(b, n, d, generator=g).to(dev).to(bf16)
    kb = pad_bias(b, n, g) if layout == "postnorm" else None
    kw = dict(heads=heads, act=act, eps=eps, key_bias=kb, causal=causal, layout=layout)
    enc = encoder_layer(p, layout, heads, act, eps)
    mask = (torch.nn.Transformer.generate_square_subsequent_mask(n, device=dev, dtype=bf16)
            if causal else None)
    kernels = ("gemm", "flash", "attention", "layernorm")
    with torch.inference_mode():
        op = lambda: fb.fused_block_infer(x, p, **kw)
        lib = lambda: enc(x, src_mask=mask, src_key_padding_mask=kb, is_causal=causal)
        print(f"K1 {layout} [{b}, {n}, {d}] {heads} heads {act} causal={causal}: op "
              f"{op_ms(op, 20):.4f} kernels {kernel_ms(op, 20, kernels):.4f}; "
              f"TransformerEncoderLayer {op_ms(lib, 20):.4f} ms", flush=True)
'''

TEXT = f"SHAPE = {TEXT_SHAPE!r}" + TIMERS + ENCODER + r'''
from nextgen_uia_tpu_torch.models.bert import BertConfig, BertLayer
from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_block, fused_ln_mlp, fused_ln_qkv
b, n, d, heads = SHAPE
g = torch.Generator().manual_seed(n)
layer = BertLayer(g, BertConfig(width=d, heads=heads, intermediate=4 * d)).to(dev)
x = torch.randn(b, n, d, generator=g).to(dev).to(bf16)
kb = pad_bias(b, n, g)
with torch.no_grad():
    q, k, v = fused_ln_qkv.fused_ln_qkv(x, None, layer.attn, heads=heads)
    ops = {
        "K5 raw-x": lambda: fused_ln_qkv.fused_ln_qkv(x, None, layer.attn, heads=heads),
        "K6 post-LN": lambda: fused_attn_o.fused_attn_o_residual(
            q, k, v, x, layer.attn.o, heads=heads, bias=kb, post_ln=layer.attn_ln,
            ln_eps=1e-12),
        "K9": lambda: fused_ln_mlp.fused_postnorm_mlp_ln(x, layer.ffn, layer.ffn_ln, eps=1e-12),
        "the chain": lambda: fused_ln_mlp.fused_postnorm_mlp_ln(
            fused_attn_o.fused_attn_o_residual(
                *fused_ln_qkv.fused_ln_qkv(x, None, layer.attn, heads=heads), x, layer.attn.o,
                heads=heads, bias=kb, post_ln=layer.attn_ln, ln_eps=1e-12),
            layer.ffn, layer.ffn_ln, eps=1e-12),
        "K1 post-norm": lambda: fused_block.fused_block_infer(
            x, layer, heads=heads, eps=1e-12, key_bias=kb, layout="postnorm")}
    kernels = ("gemm", "flash", "attention", "layernorm")
    for name, fn in ops.items():
        print(f"TEXT {name} [{b}, {n}, {d}] + padding bias: op {op_ms(fn, 10):.4f} kernels "
              f"{kernel_ms(fn, 10, kernels):.4f} ms", flush=True)
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

MLP = f"SHAPES = {MLP_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.ops import fused_mlp as fm
for what, m, d, hid, act in SHAPES:
    g = torch.Generator().manual_seed(m)
    x, go = (torch.randn(m, d, generator=g).to(dev).to(bf16) for _ in range(2))
    w1 = (torch.randn(d, hid, generator=g) / d ** 0.5).to(dev).to(bf16)
    w2 = (torch.randn(hid, d, generator=g) / hid ** 0.5).to(dev).to(bf16)
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(dev) for n in (hid, d))
    with torch.no_grad():
        if what == "fwd":
            fn = lambda: fm.fused_mlp(x, w1, b1, w2, b2, act=act)
        else:
            fn = lambda: fm.fused_mlp_backward(x, w1, b1, w2, go, act=act)
        print(f"K10 {what} [{m}, {d}] x {hid} {act}: op {op_ms(fn, 20):.4f} kernels "
              f"{kernel_ms(fn, 20, ('gemm',)):.4f} ms", flush=True)
'''

K5 = f"SHAPES = {BLOCK_SHAPES!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_ln_qkv as flq
for b, n, d, heads in SHAPES:
    g = torch.Generator().manual_seed(n)
    blk = Block(g, ViTConfig(width=d, heads=heads)).to(dev)
    x = torch.randn(b, n, d, generator=g).to(dev).to(bf16)
    dy = [torch.randn(b, heads, n, d // heads, generator=g).to(dev).to(bf16) for _ in range(3)]
    gamma, _, w_qkv, _ = flq._weights(blk.ln1, blk.attn, bf16)
    kernels = ("gemm", "layernorm")
    with torch.no_grad():
        fwd = lambda: flq.fused_ln_qkv(x, blk.ln1, blk.attn, heads=heads)
        bwd = lambda: flq.fused_ln_qkv_backward(x, gamma, w_qkv, *dy)
        print(f"K5 pre-norm [{b}, {n}, {d}] {heads} heads: fwd op {op_ms(fwd, 20):.4f} kernel "
              f"{kernel_ms(fwd, 20, kernels):.4f}; bwd op {op_ms(bwd, 20):.4f} kernel "
              f"{kernel_ms(bwd, 20, kernels):.4f} ms", flush=True)
'''

K12 = f"SHAPE = {K12_SHAPE!r}" + TIMERS + r'''
from nextgen_uia_tpu_torch.adapters.mona import Mona
from nextgen_uia_tpu_torch.ops import fused_mona as fm
b, n, d, grid = SHAPE
g = torch.Generator().manual_seed(n)
mona = Mona(g, d, 64, "hybrid")
with torch.no_grad():
    mona.gamma.copy_(0.5 * torch.randn(d, generator=g))
mona = mona.to(dev)
x, go = (torch.randn(b, n, d, generator=g).to(dev).to(bf16) for _ in range(2))
kw = dict(variant="hybrid", mask=((torch.rand(b, n, 64, generator=g) < 0.9).float() / 0.9).to(dev))
kernels = ("gemm", "mona", "sum_splits")
with torch.no_grad():
    _, saved = fm.mona_block_fused_forward(mona, x, (grid, grid), **kw)
    fwd = lambda: fm.mona_block_fused_forward(mona, x, (grid, grid), **kw)
    bwd = lambda: fm.mona_block_fused_backward(mona, x, (grid, grid), go, saved, **kw)
    print(f"K12 hybrid [{b}, {n}, {d}] grid {grid}: fwd op {op_ms(fwd, 20):.4f} kernel "
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

TIMINGS = {"k1": (K1, "K1 "), "k5": (K5, "K5 "), "k6": (K6, "K6 "), "k7": (K7, "K7 "),
           "k8": (K8, "K8 "), "k11": (K11, "K11 "), "k12": (K12, "K12 "), "mlp": (MLP, "K10 "),
           "text": (TEXT, "TEXT "), "bench": (BENCH, "BENCH ")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2 or not os.path.isdir(argv[0]) or (
            len(argv) == 2 and argv[1] not in TIMINGS):
        raise SystemExit("usage: python -m nextgen_uia_tpu_torch.tools.compare_trees "
                         "OTHER_CHECKOUT [k1|k5|k6|k7|k8|k11|k12|mlp|text|bench]")
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
