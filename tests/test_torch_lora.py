"""The port's LoRA route and the K7 backward against the JAX package, on
the CPU.

(a) ``flash_attention_backward_plain`` against ``jax.grad`` of the JAX
``flash_attention`` (Pallas, interpret mode, as tests/test_flash_attention.py
runs it): float32, with a key bias, causal, a ragged N, the CUDA kernels'
tile edges (N = 1, 64, 65, 129), both layouts, ``bias_grad=True`` (the
bias's gradient too), head dim 64 and the CLIPSeg decoder's 16; the port's
autograd through
``flash_attention`` on CPU tensors gives the same; max|d| <= 2e-5 *
max(1, max|ref|). (b) ``mha``'s LoRA route (LayerNorm given, residual,
nonzero b, a key bias) against the JAX ``mha`` (its CPU einsum route): the
output, and the gradients of x, every LoRA pair and the q/k/v/o biases,
<= 2e-5 * max(1, max|ref|); with the JAX package's own dropout masks
(drawn from its key, handed to the port) the same; an all-zero mask leaves
exactly the frozen projections. (c) ``lora_pair_init``/``inject_lora``'s
shapes, bounds and zeros, and the tiny OpenAI-layout ViT with LoRA in every
block (the train route and the eval route, which the whole-block kernel
declines) against the JAX ``vit_apply``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters import lora as jax_lora
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.models import vit as jax_vit
from nextgen_uia_tpu.nn import attention as jax_attn
from nextgen_uia_tpu.ops.flash_attention import flash_attention as jax_flash
from nextgen_uia_tpu_torch.adapters.lora import inject_lora
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core.partition import partition
from nextgen_uia_tpu_torch.models import vit
from nextgen_uia_tpu_torch.nn.attention import Attention, mha
from nextgen_uia_tpu_torch.nn.layers import LayerNorm
from nextgen_uia_tpu_torch.ops import flash_attention as fa


def _close(got, want, rel=2e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(1.0, scale), f"max|d| {err:.3e} (max|ref| {scale:.3e})"


@pytest.mark.parametrize("layout,b,h,n,bias,causal,bias_grad,dh", [
    ("bnhd", 2, 2, 33, False, False, False, 64),
    ("bhnd", 2, 3, 20, True, False, False, 64),
    ("bnhd", 1, 2, 37, False, True, False, 64),
    ("bhnd", 2, 2, 29, True, True, True, 64),
    ("bnhd", 2, 4, 33, True, False, True, 64),
    # the CUDA kernels' tile edges (64-row boxes, 128-row tiles)
    ("bnhd", 2, 2, 1, True, True, True, 64),
    ("bhnd", 1, 2, 64, True, True, False, 64),
    ("bnhd", 1, 2, 65, True, True, True, 64),
    ("bhnd", 1, 2, 129, True, True, True, 64),
    # the CLIPSeg decoder's head dim (4 heads of 16)
    ("bnhd", 1, 4, 33, True, True, True, 16),
    ("bnhd", 1, 4, 33, False, False, False, 16)])
def test_flash_backward_plain_matches_jax(layout, b, h, n, bias, causal, bias_grad, dh):
    rng = np.random.default_rng(n + h)
    shape = (b, n, h, dh) if layout == "bnhd" else (b, h, n, dh)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    kb = (0.5 * rng.standard_normal((b, n))).astype(np.float32) if bias else None

    def loss(q_, k_, v_, kb_):
        out = jax_flash(q_, k_, v_, bias=kb_, causal=causal, layout=layout, bias_grad=bias_grad)
        return jnp.sum(out * cot)

    args = [jnp.asarray(t) for t in (q, k, v)] + [None if kb is None else jnp.asarray(kb)]
    want = jax.grad(loss, argnums=(0, 1, 2, 3) if bias_grad else (0, 1, 2))(*args)

    t = [torch.from_numpy(a) for a in (q, k, v, cot)]
    tb = None if kb is None else torch.from_numpy(kb)
    got = fa.flash_attention_backward_plain(*t[:3], tb, t[3], causal=causal, layout=layout)
    for g, w in zip(got, want):
        _close(g, w)

    # the port's autograd on CPU tensors runs the same formulas
    leaves = [x.clone().requires_grad_() for x in t[:3]]
    tb_leaf = tb.clone().requires_grad_() if bias_grad else tb
    out = fa.flash_attention(*leaves, bias=tb_leaf, causal=causal, layout=layout,
                             bias_grad=bias_grad)
    (out * t[3]).sum().backward()
    for leaf, w in zip(leaves + ([tb_leaf] if bias_grad else []), want):
        _close(leaf.grad, w)
    assert fa.flash_attention_backward.launches == 0  # the CPU path launches nothing


def _jax_attention(seed, dim, r):
    p = jax_attn.attention_init(jax.random.key(seed), dim)
    p["lora"] = {t: jax_lora.lora_pair_init(jax.random.key(seed + 1 + i), dim, dim, r)
                 for i, t in enumerate("qkvo")}
    rng = np.random.default_rng(seed)
    for t in "qkvo":
        p["lora"][t]["b"] = jnp.asarray(0.1 * rng.standard_normal((r, dim)), jnp.float32)
    ln = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(dim), jnp.float32),
          "bias": jnp.asarray(0.1 * rng.standard_normal(dim), jnp.float32)}
    return p, ln


def _port_attention(tmp_path, p, ln, dim, r):
    jax_ckpt.save(str(tmp_path / "attn.npz"), {"attn": p, "ln": ln})
    holder = torch.nn.Module()
    holder.attn, holder.ln = Attention(torch.Generator().manual_seed(0), dim), LayerNorm(dim)
    vit_like = torch.nn.Module()
    vit_like.blocks = torch.nn.ModuleList([torch.nn.Module()])
    vit_like.blocks[0].attn = holder.attn
    inject_lora(torch.Generator().manual_seed(1), vit_like, dim=dim, r=r)
    _, n = ckpt.load_into(str(tmp_path / "attn.npz"), holder)
    assert n == len(holder.state_dict())
    return holder


def _jax_masks(key, rate, shape):
    """The masks the JAX mha draws for q, k, v, o, pre-scaled by 1/keep."""
    keys = jax.random.split(key, 4)
    return {t: np.asarray(jax.random.bernoulli(keys[i], 1 - rate, shape),
                          np.float32) / (1 - rate) for i, t in enumerate("qkvo")}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_mha_lora_route_matches_jax(tmp_path, dropout):
    dim, heads, r, b, n = 128, 2, 4, 2, 19
    p, ln = _jax_attention(5, dim, r)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    kb = np.where(rng.random((b, n)) < 0.8, 0.0, -1e9).astype(np.float32)
    cot = rng.standard_normal((b, n, dim)).astype(np.float32)
    key = jax.random.key(9)

    def f(p_, x_):
        return jax_attn.mha(p_, x_, num_heads=heads, ln=ln, residual=x_,
                            key_padding_bias=jnp.asarray(kb), lora_alpha=32.0,
                            lora_dropout=dropout, lora_rng=key if dropout else None)

    out_j, vjp = jax.vjp(f, p, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(cot))

    holder = _port_attention(tmp_path, p, ln, dim, r)
    trainable, _ = partition(holder.attn, lambda path: "lora" in path or path.endswith("/b"))
    masks = ({t: torch.from_numpy(m) for t, m in _jax_masks(key, dropout, (b, n, dim)).items()}
             if dropout else None)
    xt = torch.from_numpy(x).requires_grad_()
    out = mha(holder.attn, xt, num_heads=heads, ln=holder.ln, residual=xt,
              key_padding_bias=torch.from_numpy(kb), lora_alpha=32.0, lora_dropout=dropout,
              lora_masks=masks)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j)
    _close(xt.grad, gx_j)
    want = dict(jax_flatten(gp_j))
    assert len(trainable) == 4 * 2 + 4
    for path, prm in trainable.items():
        _close(prm.grad, want[path])


def test_lora_dropout_reaches_only_the_branch_input(tmp_path):
    """With every LoRA input dropped the route is the frozen projections
    alone (the JAX mha without its lora slot); with no dropout the LoRA
    update moves the output."""
    dim, heads, r = 128, 2, 4
    p, ln = _jax_attention(11, dim, r)
    x = np.random.default_rng(12).standard_normal((2, 9, dim)).astype(np.float32)
    plain = {k: v for k, v in p.items() if k != "lora"}
    want = jax_attn.mha(plain, jnp.asarray(x), num_heads=heads, ln=ln, residual=jnp.asarray(x))
    holder = _port_attention(tmp_path, p, ln, dim, r)
    xt = torch.from_numpy(x)
    zeros = {t: torch.zeros(2, 9, dim) for t in "qkvo"}
    with torch.no_grad():
        dropped = mha(holder.attn, xt, num_heads=heads, ln=holder.ln, residual=xt,
                      lora_alpha=32.0, lora_dropout=0.1, lora_masks=zeros)
        kept = mha(holder.attn, xt, num_heads=heads, ln=holder.ln, residual=xt, lora_alpha=32.0)
        drawn = mha(holder.attn, xt, num_heads=heads, ln=holder.ln, residual=xt,
                    lora_alpha=32.0, lora_dropout=0.5, gen=torch.Generator().manual_seed(0))
    _close(dropped, want)
    assert np.abs(kept.numpy() - np.asarray(want)).max() > 1e-2
    assert not torch.allclose(drawn, kept) and not torch.allclose(drawn, dropped)


def test_lora_init_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    cfg = vit.ViTConfig(image_size=32, width=96, depth=3, heads=4)
    model = vit.vit_init(gen, cfg)
    _, n = inject_lora(gen, model, dim=96, r=8, num_layers=2)
    assert n == 2 and not hasattr(model.blocks[2].attn, "lora")
    pair = model.blocks[0].attn.lora.q
    assert pair.a.shape == (96, 8) and pair.b.shape == (8, 96)
    assert pair.a.abs().max() <= 96 ** -0.5 and pair.a.std() > 0.3 * 96 ** -0.5
    assert torch.count_nonzero(pair.b) == 0
    want = jax_lora.inject_lora(jax.random.key(0), jax_vit.vit_init(
        jax.random.key(1), jax_vit.ViTConfig(image_size=32, width=96, depth=3, heads=4)),
        dim=96, r=8, num_layers=2)[0]
    want_keys = {k for k, _ in jax_flatten(want)}
    assert {k.replace(".", "/") for k in model.state_dict()} == want_keys


def test_openai_vit_with_lora_matches_jax(tmp_path):
    """The OpenAI layout (ln_pre, bias-free patch conv, ln_post on CLS,
    quick_gelu) with LoRA in every block, nonzero b: the train route's
    pooled output and LoRA/bias gradients, and the eval route (infer_cfg:
    LoRA blocks decline the whole-block kernel), against the JAX tower."""
    jcfg = dataclasses.replace(jax_vit.VIT_B16_OPENAI, image_size=32, width=128, depth=2,
                               heads=2, proj_dim=64)
    p = jax_vit.vit_init(jax.random.key(2), jcfg)
    p, _ = jax_lora.inject_lora(jax.random.key(3), p, dim=128, r=4)
    rng = np.random.default_rng(4)
    for blk in p["blocks"]:
        for t in "qkvo":
            blk["attn"]["lora"][t]["b"] = jnp.asarray(0.1 * rng.standard_normal((4, 128)),
                                                      jnp.float32)
    jax_ckpt.save(str(tmp_path / "vit.npz"), p)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 64)).astype(np.float32)

    def pooled(p_):
        return jax_vit.vit_apply(p_, jcfg, jnp.asarray(x))[0]

    out_j, vjp = jax.vjp(pooled, p)
    (g_j,) = vjp(jnp.asarray(cot))
    want = dict(jax_flatten(g_j))

    cfg = dataclasses.replace(vit.VIT_B16_OPENAI, image_size=32, width=128, depth=2, heads=2,
                              proj_dim=64)
    model = vit.vit_init(torch.Generator().manual_seed(0), cfg)
    inject_lora(torch.Generator().manual_seed(1), model, dim=128, r=4)
    _, n = ckpt.load_into(str(tmp_path / "vit.npz"), model)
    assert n == len(model.state_dict()) == len(want)
    trainable, _ = partition(model, lambda path: "lora" in path or "/attn/" in path
                             and path.endswith("/b"))
    out, _ = vit.vit_apply(model, cfg, torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j)
    assert len(trainable) == 2 * (8 + 4)
    for path, prm in trainable.items():
        _close(prm.grad, want[path])
    with torch.no_grad():
        ev, _ = vit.vit_apply(model, dataclasses.replace(cfg, block_impl="fused_infer"),
                              torch.from_numpy(x))
    _close(ev, out_j)
