"""The train path's block ops of the port, forward and backward, against the
JAX package's Pallas kernels (interpret mode on the CPU) and against
torch.autograd of their own plain forwards.

Each case feeds the same numpy inputs to both sides. The port runs 17
tokens unpadded; the JAX kernels need N % 8, so they take the tokens padded
to 32 (zero rows, and for attention keys past 17 masked by ``n_real`` or a
-1e9 key bias) with zero cotangents on the padded rows, and their first 17
rows are compared. Bounds: forward max|d| <= 2e-5, gradients max|d| <=
1e-4 * max|ref| (float32 on both sides, products in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.dwconv import mona_spatial as jax_mona_spatial
from nextgen_uia_tpu.ops.fused_attn_o import fused_attn_o_residual as jax_attn_o
from nextgen_uia_tpu.ops.fused_ln_mlp import fused_ln_mlp_residual as jax_ln_mlp
from nextgen_uia_tpu.ops.fused_ln_qkv import fused_ln_qkv as jax_ln_qkv
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import KERNELS, dwconv, fused_attn_o, fused_ln_mlp, fused_ln_qkv

B, N, NP, D, H = 2, 17, 32, 128, 2
DH = D // H


def _block(seed):
    """A port Block with perturbed LayerNorms, and the same weights as the
    JAX package's parameter dicts."""
    gen = torch.Generator().manual_seed(seed)
    blk = Block(gen, ViTConfig(width=D, heads=H))
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2):
            ln.scale.add_(0.2 * torch.randn(D, generator=gen))
            ln.bias.add_(0.2 * torch.randn(D, generator=gen))

    def tree(m):
        return {k: jnp.asarray(v.numpy()) for k, v in m.named_parameters()}

    return blk, {"ln1": tree(blk.ln1), "ln2": tree(blk.ln2),
                 "attn": {k: tree(getattr(blk.attn, k)) for k in "qkvo"},
                 "mlp": {k: tree(getattr(blk.mlp, k)) for k in ("fc1", "fc2")}}


def _pad_tokens(a, axis):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, NP - N)
    return np.pad(a, pad)


def _close(got, want, *, grad):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = 1e-4 * np.abs(want).max() if grad else 2e-5
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def test_ln_qkv_matches_jax_kernel():
    blk, jp = _block(1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    cots = [rng.standard_normal((B, H, N, DH)).astype(np.float32) for _ in range(3)]

    out_j, vjp = jax.vjp(lambda xx: jax_ln_qkv(xx, jp["ln1"], jp["attn"], heads=H),
                         jnp.asarray(_pad_tokens(x, 1)))
    (dx_j,) = vjp(tuple(jnp.asarray(_pad_tokens(c, 2)) for c in cots))

    xt = torch.from_numpy(x).requires_grad_()
    out_t = fused_ln_qkv.fused_ln_qkv(xt, blk.ln1, blk.attn, heads=H)
    sum(((o * torch.from_numpy(c)).sum() for o, c in zip(out_t, cots))).backward()
    for o_t, o_j in zip(out_t, out_j):
        _close(o_t.detach().numpy(), np.asarray(o_j)[:, :, :N], grad=False)
    _close(xt.grad.numpy(), np.asarray(dx_j)[:, :N], grad=True)


@pytest.mark.parametrize("mask", ["n_real", "key_bias"])
def test_attn_o_residual_matches_jax_kernel(mask):
    blk, jp = _block(2)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, H, N, DH)).astype(np.float32) for _ in range(3))
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    bias = rng.standard_normal((B, N)).astype(np.float32) if mask == "key_bias" else None
    if mask == "key_bias":
        kw_j = {"bias": jnp.asarray(np.pad(bias, ((0, 0), (0, NP - N)), constant_values=-1e9))}
    else:
        kw_j = {"n_real": N}

    def f(qq, kk, vv, xx):
        return jax_attn_o(qq, kk, vv, xx, jp["attn"]["o"], heads=H, **kw_j)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(_pad_tokens(a, 2)) for a in (q, k, v)),
                         jnp.asarray(_pad_tokens(x, 1)))
    grads_j = vjp(jnp.asarray(_pad_tokens(g, 1)))

    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, x)]
    out_t = fused_attn_o.fused_attn_o_residual(
        *ins, blk.attn.o, heads=H, bias=None if bias is None else torch.from_numpy(bias))
    (out_t * torch.from_numpy(g)).sum().backward()
    _close(out_t.detach().numpy(), np.asarray(out_j)[:, :N], grad=False)
    for t, gj, axis in zip(ins, grads_j, (2, 2, 2, 1)):
        _close(t.grad.numpy(), np.take(np.asarray(gj), np.arange(N), axis=axis), grad=True)


@pytest.mark.parametrize("n", [32, 77])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attn_o_residual_causal_matches_jax_kernel(n, with_bias):
    """K6's causal mode (the frozen CLIP text tower's): the port's plain
    forward and backward against the JAX kernel with ``causal=True``. N = 77
    runs unpadded here and padded to 80 there (keys past 77 masked by
    ``n_real`` or a -1e9 bias, which the causal mask hides from every real
    row anyway); outputs and dq/dk/dv within 1e-5 * max|ref|."""
    blk, jp = _block(4)
    rng = np.random.default_rng(n + with_bias)
    npad = -(-n // 8) * 8
    q, k, v = (rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(3))
    x, g = (rng.standard_normal((B, n, D)).astype(np.float32) for _ in range(2))
    bias = (np.where(rng.random((B, n)) < 0.8, 0.0, -1e9) + 0.3 * rng.standard_normal((B, n))
            ).astype(np.float32) if with_bias else None
    kw_j = ({"bias": jnp.asarray(np.pad(bias, ((0, 0), (0, npad - n)), constant_values=-1e9))}
            if with_bias else {"n_real": n})

    def pad(a, axis):
        width = [(0, 0)] * a.ndim
        width[axis] = (0, npad - n)
        return jnp.asarray(np.pad(a, width))

    out_j, vjp = jax.vjp(
        lambda qq, kk, vv, xx: jax_attn_o(qq, kk, vv, xx, jp["attn"]["o"], heads=H,
                                          causal=True, **kw_j),
        *(pad(a, 2) for a in (q, k, v)), pad(x, 1))
    grads_j = vjp(pad(g, 1))

    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, x)]
    out_t = fused_attn_o.fused_attn_o_residual(
        *ins, blk.attn.o, heads=H, causal=True,
        bias=None if bias is None else torch.from_numpy(bias))
    (out_t * torch.from_numpy(g)).sum().backward()

    def close(got, want):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(out_t.detach().numpy(), np.asarray(out_j)[:, :n])
    for t, gj, axis in zip(ins, grads_j, (2, 2, 2, 1)):
        close(t.grad.numpy(), np.take(np.asarray(gj), np.arange(n), axis=axis))
    # the wrapper's backward is the plain one on the CPU; the mask matters
    dq, _, _ = fused_attn_o.fused_attn_o_residual_backward(
        *(torch.from_numpy(a) for a in (q, k, v)), blk.attn.o.w.detach(), torch.from_numpy(g),
        bias=None if bias is None else torch.from_numpy(bias))
    assert np.abs(dq.numpy() - ins[0].grad.numpy()).max() > 1e-3


def test_mha_frozen_causal_route_matches_jax():
    """``mha`` with ``ln``, ``residual`` and ``causal=True``: the port's
    LN+QKV then K6 causal against the JAX ``mha``'s same route (its Pallas
    kernels in interpret mode, N = 32 tiles), output and dx."""
    from nextgen_uia_tpu.nn.attention import mha as jax_mha
    from nextgen_uia_tpu_torch.nn.attention import mha

    blk, jp = _block(5)
    n = 32
    rng = np.random.default_rng(5)
    x, g = (rng.standard_normal((B, n, D)).astype(np.float32) for _ in range(2))
    out_j, vjp = jax.vjp(lambda xx: jax_mha(jp["attn"], xx, num_heads=H, ln=jp["ln1"],
                                            residual=xx, causal=True, impl="flash"),
                         jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    blk.requires_grad_(False)
    seen = []

    def k6(*a, **kw):
        seen.append(kw["causal"])
        return fused_attn_o.fused_attn_o_residual(*a, **kw)

    ops = dataclasses.replace(KERNELS, fused_attn_o_residual=k6)
    xt = torch.from_numpy(x).requires_grad_()
    out_t = mha(blk.attn, xt, num_heads=H, ln=blk.ln1, residual=xt, causal=True, ops=ops)
    (out_t * torch.from_numpy(g)).sum().backward()
    assert seen == [True]
    for got, want in ((out_t.detach().numpy(), np.asarray(out_j)),
                      (xt.grad.numpy(), np.asarray(dx_j))):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_matches_jax_kernel(act):
    blk, jp = _block(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    rows = 40  # B * N = 34 rows, padded to a multiple of 8 for the JAX kernel

    def pad_rows(a):
        return jnp.asarray(np.pad(a.reshape(B * N, D), ((0, rows - B * N), (0, 0))))

    out_j, vjp = jax.vjp(lambda xx: jax_ln_mlp(xx, jp["ln2"], jp["mlp"], act=act), pad_rows(x))
    (dx_j,) = vjp(pad_rows(g))

    xt = torch.from_numpy(x).requires_grad_()
    out_t = fused_ln_mlp.fused_ln_mlp_residual(xt, blk.ln2, blk.mlp, act=act)
    (out_t * torch.from_numpy(g)).sum().backward()
    _close(out_t.detach().numpy().reshape(B * N, D), np.asarray(out_j)[:B * N], grad=False)
    _close(xt.grad.numpy().reshape(B * N, D), np.asarray(dx_j)[:B * N], grad=True)


@pytest.mark.parametrize("shape", [(2, 6, 7, 32), (3, 4, 4, 64)])
def test_mona_spatial_backward_matches_jax_kernel(shape):
    b, _, _, c = shape
    rng = np.random.default_rng(sum(shape))
    ins = [rng.standard_normal(shape), 1 + 0.3 * rng.standard_normal(c),
           0.2 * rng.standard_normal((b, 7, 7, c)), rng.standard_normal((b, c))]
    ins = [a.astype(np.float32) for a in ins]
    g = rng.standard_normal(shape).astype(np.float32)
    out_j, vjp = jax.vjp(jax_mona_spatial, *map(jnp.asarray, ins))
    grads_j = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out_t = dwconv.mona_spatial(*ts)
    (out_t * torch.from_numpy(g)).sum().backward()
    _close(out_t.detach().numpy(), np.asarray(out_j), grad=False)
    for t, gj in zip(ts, grads_j):
        _close(t.grad.numpy(), np.asarray(gj), grad=True)


def _autograd(fn, inputs, cot):
    ins = [t.clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, cot if isinstance(cot, tuple) else (cot,))
    return [t.grad for t in ins]


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("op", ["ln_qkv", "attn_o", "ln_mlp", "mona_spatial"])
def test_plain_backward_matches_autograd_of_plain_forward(op):
    """Each plain backward (the JAX _bwd_kernel's math) against
    torch.autograd of its plain forward, float32: max|d| <= 1e-5 max|ref|."""
    blk, _ = _block(4)
    if op == "ln_qkv":
        x = _randn(B, N, D)
        cot = tuple(_randn(B, H, N, DH, seed=i) for i in range(3))
        want = _autograd(lambda t: fused_ln_qkv.fused_ln_qkv_plain(t, blk.ln1, blk.attn,
                                                                   heads=H), [x], cot)
        gamma, _, w, _ = fused_ln_qkv._weights(blk.ln1, blk.attn, torch.float32)
        got = [fused_ln_qkv.fused_ln_qkv_backward_plain(x, gamma, w, *cot)]
    elif op == "attn_o":
        ins = [_randn(B, H, N, DH, seed=i) for i in range(3)] + [_randn(B, N, D, seed=3)]
        cot, bias = _randn(B, N, D, seed=4), _randn(B, N, seed=5)
        want = _autograd(lambda *t: fused_attn_o.fused_attn_o_residual_plain(
            *t, blk.attn.o, heads=H, bias=bias, n_real=13), ins, cot)
        got = [*fused_attn_o.fused_attn_o_residual_backward_plain(
            *ins[:3], blk.attn.o.w, cot, bias=bias, n_real=13), cot]
    elif op == "ln_mlp":
        x, cot = _randn(B, N, D), _randn(B, N, D, seed=1)
        want = _autograd(lambda t: fused_ln_mlp.fused_ln_mlp_residual_plain(
            t, blk.ln2, blk.mlp, act="gelu"), [x], cot)
        got = [fused_ln_mlp.fused_ln_mlp_residual_backward_plain(
            x, *fused_ln_mlp._weights(blk.ln2, blk.mlp, torch.float32)[:5], cot)]
    else:
        ins = [_randn(2, 5, 6, 16), 1 + 0.3 * _randn(16, seed=1),
               0.2 * _randn(2, 7, 7, 16, seed=2), _randn(2, 16, seed=3)]
        cot = _randn(2, 5, 6, 16, seed=4)
        want = _autograd(dwconv.mona_spatial_plain, ins, cot)
        got = list(dwconv.mona_spatial_backward_plain(*ins[:3], cot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


FROZEN = "frozen.*mlp_impl='xla'"


def test_frozen_weight_contract():
    """The split kernels give no weight gradients: a weight that trains is
    refused (NotImplementedError naming the models' mlp_impl='xla' routes,
    which train weights), on every device, before anything runs."""
    blk, _ = _block(5)
    x = _randn(B, N, D)
    blk.ln1.scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_ln_qkv.fused_ln_qkv(x, blk.ln1, blk.attn, heads=H)
    blk.attn.o.w.requires_grad_(True)
    q = _randn(B, H, N, DH)
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_attn_o.fused_attn_o_residual(q, q, q, x, blk.attn.o, heads=H)
    blk.mlp.fc2.b.requires_grad_(True)
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_ln_mlp.fused_ln_mlp_residual(x, blk.ln2, blk.mlp)
    # the forward-only post-norm variants hold the same contract
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_attn_o.fused_attn_o_residual(q, q, q, x, blk.attn.o, heads=H, post_ln=blk.ln2)
    blk.attn.v.b.requires_grad_(True)
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_ln_qkv.fused_ln_qkv(x, None, blk.attn, heads=H)
    with pytest.raises(NotImplementedError, match=FROZEN):
        fused_ln_mlp.fused_postnorm_mlp_ln(x, blk.mlp, blk.ln2)


def test_backward_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, D, device="meta")
    q = torch.zeros(1, H, 4, DH, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_ln_qkv.fused_ln_qkv_backward(x, torch.zeros(D), torch.zeros(D, 3 * D), q, q, q)
    with pytest.raises(ValueError, match="device"):
        fused_attn_o.fused_attn_o_residual_backward(q, q, q, torch.zeros(D, D), x)
    with pytest.raises(ValueError, match="device"):
        fused_ln_mlp.fused_ln_mlp_residual_backward(x, *[torch.zeros(1)] * 5, x)
    s = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        dwconv.mona_spatial_backward(s, s[0, 0, 0], torch.zeros(1, 7, 7, 8, device="meta"), s)
