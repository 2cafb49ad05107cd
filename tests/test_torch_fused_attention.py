"""The port's fused attention block (K11) and its hybrid route against the
JAX package, on the CPU.

On a CPU tensor ``fused_attn_block`` runs its plain forward and the explicit
plain dx backward (the formulas of the JAX ``_bwd_kernel``);
``hybrid_attn_block`` the plain products around the flash-attention plain
version, with the same backward. Float32 inputs from a numpy seed at b = 8,
d = 128, 4 heads and (n, causal, key bias) in {(25, no, no), (16, yes, no),
(40, no, yes)}: the forward within 2e-5 * max(1, max|ref|) of the JAX
kernel (interpret mode) and of the JAX hybrid forward, dx within the same
of ``jax.grad``. ``mha``'s 'fused_block' and 'hybrid_block' routes (the
LayerNorm first, the residual outside) against the JAX ``mha``; weights
that require grad are refused; 'einsum' and 'flash' (causal, key bias)
against the JAX ``mha``. The CUDA kernels' packed layout (``_packed_layout``): its strided
views of a [B*N, 3D] buffer equal the plain version's q, k, v and dq, dk,
dv exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.nn.attention import mha as jax_mha
from nextgen_uia_tpu.ops import fused_attention as jax_fa
from nextgen_uia_tpu_torch.nn.attention import Attention, mha
from nextgen_uia_tpu_torch.nn.layers import LayerNorm
from nextgen_uia_tpu_torch.ops import fused_attention as fa

B, D, HEADS = 8, 128, 4
CASES = [(25, False, False), (16, True, False), (40, False, True)]


def _weights(seed):
    rng = np.random.default_rng(seed)
    return {t: {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(D)).astype(np.float32)} for t in "qkvo"}


def _port_attention(w):
    p = Attention(torch.Generator().manual_seed(0), D)
    with torch.no_grad():
        for t, wb in w.items():
            getattr(p, t).w.copy_(torch.from_numpy(wb["w"]))
            getattr(p, t).b.copy_(torch.from_numpy(wb["b"]))
    return p


def _inputs(n, bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, D)).astype(np.float32)
    g = rng.standard_normal((B, n, D)).astype(np.float32)
    kb = None
    if bias:  # a key-padding bias: the last keys of some images masked
        kb = np.zeros((B, n), np.float32)
        kb[::2, -7:] = -1e9
        kb += (0.3 * rng.standard_normal((B, n))).astype(np.float32)
    return x, g, kb


def _close(got, want, what):
    want = np.asarray(want)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _port_run(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("route", ["fused_attn_block", "hybrid_attn_block"])
@pytest.mark.parametrize("n,causal,bias", CASES)
def test_attention_block_matches_jax(route, n, causal, bias):
    w = _weights(n)
    x, g, kb = _inputs(n, bias, seed=n + causal)
    jkb = None if kb is None else jnp.asarray(kb)
    jax_block = getattr(jax_fa, route)

    def jax_fn(xx):
        return jax_block(xx, jax.tree_util.tree_map(jnp.asarray, w), heads=HEADS, bias=jkb,
                         causal=causal)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    p = _port_attention(w)
    tkb = None if kb is None else torch.from_numpy(kb)
    out, dx = _port_run(lambda xx: getattr(fa, route)(xx, p, heads=HEADS, bias=tkb,
                                                      causal=causal), x, g)
    _close(out, want, f"{route} output")
    _close(dx, gx, f"{route} dx")
    if route == "hybrid_attn_block":
        with torch.no_grad():
            plain = fa.hybrid_attn_block_plain(torch.from_numpy(x), p, heads=HEADS, bias=tkb,
                                               causal=causal)
        _close(plain.numpy(), want, "hybrid_attn_block_plain output")


@pytest.mark.parametrize("impl", ["fused_block", "hybrid_block"])
def test_mha_routes_match_jax(impl):
    n = 25
    w = _weights(1)
    rng = np.random.default_rng(2)
    ln = {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    x, g, kb = _inputs(n, True, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    jln = jax.tree_util.tree_map(jnp.asarray, ln)

    def jax_fn(xx):
        return jax_mha(jp, xx, num_heads=HEADS, key_padding_bias=jnp.asarray(kb), impl=impl,
                       ln=jln, residual=xx)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    p, lnp = _port_attention(w), LayerNorm(D)
    with torch.no_grad():
        lnp.scale.copy_(torch.from_numpy(ln["scale"]))
        lnp.bias.copy_(torch.from_numpy(ln["bias"]))
    out, dx = _port_run(lambda xx: mha(p, xx, num_heads=HEADS, ln=lnp, residual=xx,
                                       key_padding_bias=torch.from_numpy(kb), impl=impl), x, g)
    _close(out, want, f"mha {impl} output")
    _close(dx, gx, f"mha {impl} dx")


def test_trainable_weights_are_refused():
    p = _port_attention(_weights(0))
    p.o.w.requires_grad_(True)
    x = torch.zeros(2, 5, D)
    for fn in (fa.fused_attn_block, fa.hybrid_attn_block):
        with pytest.raises(NotImplementedError, match="frozen"):
            fn(x, p, heads=HEADS)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_unported_impls_raise(impl):
    """'einsum' and 'flash' are ported: with a causal mask and a key bias,
    the output and dx against the JAX ``mha``'s einsum route."""
    n, w = 16, _weights(0)
    x, g, kb = _inputs(n, True, seed=4)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    want, vjp = jax.vjp(lambda xx: jax_mha(jp, xx, num_heads=HEADS, causal=True, impl="einsum",
                                           key_padding_bias=jnp.asarray(kb)), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    p = _port_attention(w)
    out, dx = _port_run(lambda xx: mha(p, xx, num_heads=HEADS, causal=True, impl=impl,
                                       key_padding_bias=torch.from_numpy(kb)), x, g)
    _close(out, want, f"mha {impl} output")
    _close(dx, gx, f"mha {impl} dx")


@pytest.mark.parametrize("b,n,heads,dh", [(2, 5, 3, 8), (1, 1, 2, 64), (3, 7, 1, 16)])
def test_packed_views_address_the_plain_head_split(b, n, heads, dh):
    """The kernels' [B, H, N, dh] views of a packed [B*N, 3D] buffer: filled
    by the plain projection they are ``_qkv_plain``'s q, k, v; filled as
    ``fused_attn_block_backward_plain`` lays out dq|dk|dv before the product
    with Wqkv^T, they are dq, dk, dv. Exact, in float32 and bfloat16."""
    d = heads * dh
    rng = np.random.default_rng(b * 100 + n)
    x32 = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
    wqkv = torch.from_numpy(rng.standard_normal((d, 3 * d)).astype(np.float32))
    bqkv = torch.from_numpy(rng.standard_normal(3 * d).astype(np.float32))
    grads = torch.from_numpy(rng.standard_normal((3, b, heads, n, dh)).astype(np.float32))
    shape, _, _ = fa._packed_layout(b, n, heads, dh)
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        buf = (x.reshape(b * n, d).float() @ wqkv.to(dt).float() + bqkv).to(dt)
        assert tuple(buf.shape) == shape
        for got, want in zip(fa._packed_views(buf, b, n, heads),
                             fa._qkv_plain(x, wqkv.to(dt), bqkv, heads)):
            assert torch.equal(got, want)
        dqkv = grads.to(dt).permute(1, 3, 0, 2, 4).reshape(b * n, 3 * d)
        for t, got in enumerate(fa._packed_views(dqkv, b, n, heads)):
            assert torch.equal(got, grads[t].to(dt))


@pytest.mark.parametrize("dim", [0, 1])
def test_cat_builds_the_weights_in_one_copy(dim):
    """``_cat``, which builds the kernels' weight operands ([Wq|Wk|Wv]^T
    from transposed views, [Wq|Wk|Wv] as stored): the concatenation in the
    requested dtype, contiguous, in new memory, its inputs untouched."""
    rng = np.random.default_rng(dim)
    ws = [torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)) for _ in range(3)]
    parts = [w.T for w in ws] if dim == 0 else ws
    for dt in (torch.float32, torch.bfloat16):
        got = fa._cat(parts, dt, dim=dim)
        assert got.dtype == dt and got.is_contiguous()
        assert torch.equal(got, torch.cat(parts, dim).to(dt))
        assert all(got.untyped_storage().data_ptr() != w.untyped_storage().data_ptr() for w in ws)
