"""K1 (the whole-block forward: pre-norm, causal, post-norm) and K6 post-LN
as their CUDA kernels compute them, composed on the CPU from the port's
plain functions, against the JAX package's Pallas kernels (interpret mode).

K1's kernels (``ops/fused_block.py``) run LN1 (pre-norm), one flat q|k|v
product into a row-major [B*N, 3D] buffer that K7 reads through
``fused_attention._packed_layout``'s strides, K7 writing the head concat
through ``fused_attn_o._layout``'s row-major [B*N, D] strides, keys >=
n_real folded into the float32 key bias (``fused_attn_o._key_bias``), the
o-product adding bo and x into the float32 residual stream (y32 pre-norm,
s32 post-norm), the MLP on ``_kernel_weights``' W1^T and W2^T adding the
float32 stream (post-norm into s32 and its LayerNorm). K6 post-LN is the
attention half of post-norm: K7 on head-major q, k, v (``_layout``), the
o-product with bo and x in float32, the LayerNorm. Inputs come from a numpy
seed at B 2, N 17 and 34, D 128, 2 heads of 64, hidden 512, float32 on both
sides; the JAX kernels need N % 8 == 0, so they take the tokens padded
(keys >= N masked by n_real). Bound: max|d| <= 2e-5 * max(1, max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.fused_attn_o import fused_attn_o_residual as jax_attn_o
from nextgen_uia_tpu.ops.fused_block import fused_block_infer as jax_block
from nextgen_uia_tpu_torch.models.bert import BertConfig, BertLayer
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.nn.layers import ACTIVATIONS
from nextgen_uia_tpu_torch.ops import fused_attn_o as fao
from nextgen_uia_tpu_torch.ops import fused_block as fb
from nextgen_uia_tpu_torch.ops._frozen import layernorm_parts
from nextgen_uia_tpu_torch.ops.flash_attention import flash_attention_plain
from nextgen_uia_tpu_torch.ops.fused_attention import _packed_views

B, D, H, DH, HIDDEN = 2, 128, 2, 64, 512
F32 = torch.float32
LAYOUTS = {  # case -> (layout, act, eps, causal)
    "prenorm": ("prenorm", "gelu", 1e-6, False),
    "causal": ("prenorm", "quick_gelu", 1e-5, True),
    "postnorm": ("postnorm", "gelu", 1e-12, False)}


def _tree(m):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in m.named_parameters()}


def _layer(seed, layout):
    """A port ViT Block (pre-norm) or BertLayer (post-norm) with perturbed
    LayerNorms and biases, and the JAX package's dict of the same weights."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "prenorm":
        p = Block(gen, ViTConfig(width=D, heads=H))
    else:
        p = BertLayer(gen, BertConfig(width=D, heads=H, intermediate=HIDDEN))
    ln_a, att, ln_b, mlp = fb._parts(p, layout)
    with torch.no_grad():
        for ln in (ln_a, ln_b):
            ln.scale.add_(0.2 * torch.randn(D, generator=gen))
            ln.bias.add_(0.2 * torch.randn(D, generator=gen))
        for lin in (att.q, att.k, att.v, att.o, mlp.fc1, mlp.fc2):
            lin.b.add_(0.1 * torch.randn(lin.b.shape, generator=gen))
    names = ("ln1", "ln2", "mlp") if layout == "prenorm" else ("attn_ln", "ffn_ln", "ffn")
    jp = {names[0]: _tree(ln_a), names[1]: _tree(ln_b),
          "attn": {k: _tree(getattr(att, k)) for k in "qkvo"},
          names[2]: {k: _tree(getattr(mlp, k)) for k in ("fc1", "fc2")}}
    return p, jp


def _padded(n):
    return -(-n // 8) * 8


def _pad(a, axis, to):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, to - a.shape[axis])
    return np.pad(a, pad)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _ln(t, gamma, beta, eps):
    return layernorm_parts(t, eps)[0] * gamma + beta


def _attention_f32(q, k, v, x2, wo_t, bo, bias, n_real, causal):
    """K1's and K6 post-LN's attention half (csrc/block_products.cuh::
    attn_o_f32): K7 writes the head concat through the concat strides, the
    o-product adds bo and the residual, the sum stays float32."""
    b, h, n, dh = q.shape
    _, cat_strides = fao._layout(b, n, h, dh)
    kb = fao._key_bias(bias, b, n, n_real, q.device)
    cat = torch.empty(b * n, h * dh)
    cat.as_strided((b, h, n, dh), (*cat_strides, 1)).copy_(
        flash_attention_plain(q, k, v, bias=kb, causal=causal, layout="bhnd"))
    return cat @ wo_t.T + bo + x2


def _k1_dataflow(x, p, layout, act, eps, key_bias, n_real, causal):
    """The kernel sequence of csrc/fused_block.cu::nx_block_fwd in plain
    PyTorch, on the weights and layouts the wrapper hands over."""
    b, n, d = x.shape
    w = fb._kernel_weights(p, layout, F32)
    x2 = x.reshape(b * n, d)
    a = _ln(x2, w["ga"], w["ba"], eps) if layout == "prenorm" else x2
    qkv = torch.empty(fb._packed_layout(b, n, H, d // H)[0])
    qkv.copy_(a @ w["wqkv_t"].T + w["bqkv"])
    q, k, v = _packed_views(qkv, b, n, H)
    s32 = _attention_f32(q, k, v, x2, w["wo_t"], w["bo"], key_bias, n_real, causal)
    if layout == "prenorm":
        y32, z2 = s32, _ln(s32, w["gb"], w["bb"], eps)
    else:
        y32 = z2 = _ln(s32, w["ga"], w["ba"], eps)
    hdn = ACTIVATIONS[act](z2 @ w["w1_t"].T + w["b1"])
    out = hdn @ w["w2_t"].T + w["b2"] + y32
    if layout == "postnorm":
        out = _ln(out, w["gb"], w["bb"], eps)
    return out.reshape(b, n, d)


@pytest.mark.parametrize("n", [17, 34])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_k1_dataflow_matches_jax_kernel(case, n):
    """prenorm: gelu, the port on the padded tokens with keys >= n masked by
    n_real; causal: quick_gelu and a key bias; postnorm: a -1e9 padding bias
    that leaves the last row wholly padded. The JAX kernel takes the padded
    tokens with n_real = n."""
    layout, act, eps, causal = LAYOUTS[case]
    p, jp = _layer(n + len(case), layout)
    rng = np.random.default_rng(n)
    npad = _padded(n)
    n_port = npad if case == "prenorm" else n
    x = rng.standard_normal((B, n_port, D)).astype(np.float32)
    bias = None
    if case == "causal":
        bias = rng.standard_normal((B, n)).astype(np.float32)
    elif case == "postnorm":
        bias = np.zeros((B, n), np.float32)
        bias[0, n // 3:], bias[-1] = -1e9, -1e9
    want = jax_block(jnp.asarray(_pad(x, 1, npad)), jp, heads=H, act=act, eps=eps,
                     key_bias=None if bias is None else jnp.asarray(_pad(bias, 1, npad)),
                     n_real=n, causal=causal, layout=layout)
    assert want is not None  # the JAX kernel took the shape
    with torch.no_grad():
        got = _k1_dataflow(torch.from_numpy(x), p, layout, act, eps,
                           None if bias is None else torch.from_numpy(bias), n, causal)
    _close(got.numpy(), np.asarray(want)[:, :n_port], f"{case} output")


@pytest.mark.parametrize("layout", ["prenorm", "postnorm"])
def test_k1_kernel_weights_are_the_transposes(layout):
    """One copy of each weight: q|k|v as [3D, D] = [Wq|Wk|Wv]^T, Wo^T, W1^T,
    W2^T (the core's [cols, K]), the biases and LayerNorms float32."""
    p, _ = _layer(5, layout)
    ln_a, att, ln_b, mlp = fb._parts(p, layout)
    w = fb._kernel_weights(p, layout, torch.bfloat16)
    bf = torch.bfloat16
    assert torch.equal(w["wqkv_t"], torch.cat([att.q.w.T, att.k.w.T, att.v.w.T]).to(bf))
    assert torch.equal(w["bqkv"], torch.cat([att.q.b, att.k.b, att.v.b]))
    for key, t in (("wo_t", att.o.w), ("w1_t", mlp.fc1.w), ("w2_t", mlp.fc2.w)):
        assert torch.equal(w[key], t.T.to(bf)) and w[key].is_contiguous()
    for key, t in (("ga", ln_a.scale), ("ba", ln_a.bias), ("gb", ln_b.scale),
                   ("bb", ln_b.bias), ("bo", att.o.b), ("b1", mlp.fc1.b), ("b2", mlp.fc2.b)):
        assert w[key].dtype == F32 and torch.equal(w[key], t.detach())


@pytest.mark.parametrize("n", [17, 34])
def test_k6_postln_dataflow_matches_jax_kernel(n):
    """K6 post-LN's kernels: the attention half above on head-major q, k, v
    (``_layout``'s strides), then the LayerNorm, against the JAX kernel with
    ``post_ln``; a -1e9 padding bias leaves the last row wholly padded."""
    layer, jp = _layer(7 * n, "postnorm")
    rng = np.random.default_rng(3 * n)
    npad = _padded(n)
    q, k, v = (rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(3))
    x = rng.standard_normal((B, n, D)).astype(np.float32)
    bias = np.zeros((B, n), np.float32)
    bias[0, :n // 2], bias[-1] = -1e9, -1e9
    want = jax_attn_o(*(jnp.asarray(_pad(a, 2, npad)) for a in (q, k, v)),
                      jnp.asarray(_pad(x, 1, npad)), jp["attn"]["o"], heads=H,
                      bias=jnp.asarray(_pad(bias, 1, npad)), n_real=n, post_ln=jp["attn_ln"],
                      ln_eps=1e-12)
    heads, _ = fao._layout(B, n, H, DH)
    qv, kv, vv = (torch.from_numpy(a).contiguous().as_strided((B, H, n, DH), (*heads, 1))
                  for a in (q, k, v))
    wo_t, bo = fao._kernel_weights(layer.attn.o, F32)
    with torch.no_grad():
        y32 = _attention_f32(qv, kv, vv, torch.from_numpy(x).reshape(B * n, D), wo_t, bo,
                             torch.from_numpy(bias), n, False)
        got = _ln(y32, layer.attn_ln.scale, layer.attn_ln.bias, 1e-12).reshape(B, n, D)
    _close(got.numpy(), np.asarray(want)[:, :n], "output")


@pytest.mark.parametrize("dh", [32, 48])
@pytest.mark.parametrize("op", ["fused_block_infer", "fused_attn_o_residual_postln"])
def test_bf16_refuses_head_dim_not_64(op, dh):
    """The bf16 paths are K7's wgmma kernels (head dim 64): another head dim
    raises a ValueError naming the shape, with no fallback; float32 takes
    it."""
    x = torch.zeros(2, 17, 4 * dh, dtype=torch.bfloat16)
    if op == "fused_block_infer":
        mlp = Block(torch.Generator().manual_seed(0), ViTConfig(width=4 * dh, heads=4)).mlp
        with pytest.raises(ValueError, match=rf"x \(2, 17, {4 * dh}\).*head dim {dh}"):
            fb._check_cuda_shapes(x, mlp, 4, None, 17)
        fb._check_cuda_shapes(x.float(), mlp, 4, None, 17)
    else:
        q = torch.zeros(2, 4, 17, dh, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=rf"{op}.*q \(2, 4, 17, {dh}\).*head dim {dh}"):
            fao._check_cuda(q, x, None, 17, op)
        fao._check_cuda(q.float(), x.float(), None, 17, op)


@pytest.mark.parametrize("n", [197, 256, 577, 1370])
def test_k1_and_k6_postln_take_any_token_count(n):
    """K7 computes K1's and K6 post-LN's attention and takes any N, so
    neither bounds the tokens: ``fused_block_eligible`` accepts a bf16
    block of head dim 64 at 197, 256, 577 and 1370 tokens, and neither
    wrapper's check refuses them."""
    blk = Block(torch.Generator().manual_seed(n), ViTConfig(width=128, heads=2))
    x = torch.zeros(1, n, 128, dtype=torch.bfloat16)
    assert fb.fused_block_eligible(x, blk, heads=2, act="gelu")
    fb._check_cuda_shapes(x, blk.mlp, 2, None, n)
    q = torch.zeros(1, 2, n, 64, dtype=torch.bfloat16)
    fao._check_cuda(q, x, None, n, "fused_attn_o_residual_postln")


def test_block_apply_runs_the_composed_route_where_k1_refuses():
    """A bf16 block of head dim 32, which K1 does not take: ``block_apply``
    with ``block_impl='fused_infer'`` returns the composed route's output
    (as the JAX package's block_apply does where its fused_block_infer
    returns None), not the whole-block kernel's; float32 (head dim 1..64)
    is taken, contiguous or not (``block_apply`` hands K1 a contiguous
    copy), and an activation K1 lacks is not."""
    from nextgen_uia_tpu_torch.models import vit

    gen = torch.Generator().manual_seed(5)
    cfg = ViTConfig(width=128, heads=4, depth=1, block_impl="fused_infer")
    blk = Block(gen, cfg)
    x = torch.randn(2, 17, 128, generator=gen).to(torch.bfloat16)
    assert not fb.fused_block_eligible(x, blk, heads=4, act=cfg.act)
    assert fb.fused_block_eligible(x.float(), blk, heads=4, act=cfg.act)
    assert fb.fused_block_eligible(x.float().transpose(0, 1).contiguous().transpose(0, 1),
                                   blk, heads=4, act=cfg.act)
    assert not fb.fused_block_eligible(x.float(), blk, heads=4, act="relu")
    with torch.no_grad():
        got = vit.block_apply(blk, x, cfg)
        composed = vit.block_apply(blk, x, ViTConfig(width=128, heads=4, depth=1))
        whole = fb.fused_block_infer_plain(x, blk, heads=4, act=cfg.act, eps=cfg.ln_eps)
    assert torch.equal(got, composed)
    assert not torch.equal(got, whole)
