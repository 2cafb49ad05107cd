"""K6 (attention + o-projection + residual) and K8 (LayerNorm + MLP +
residual) as their CUDA kernels compute them, composed on the CPU from the
port's plain functions, against the JAX package's Pallas kernels (interpret
mode).

K6's kernels run K7 (flash attention) and the Hopper GEMM core through the
layouts of ``ops/fused_attn_o.py``: here K7's plain forward writes the head
concat through ``_layout``'s row-major [B*N, D] strides, the o-product adds
bo and the residual to the wrapper's Wo^T (``_kernel_weights``); the backward writes
doh through the dense head-major strides, recomputes o (checked against the
forward's concat) and the lse, and K7's plain backward gives dq, dk, dv.
Keys >= n_real reach K7 folded into the key bias (``_key_bias``). K8's
products take the wrapper's W1^T and W2^T (``_kernel_weights``) in the
forward and W2, W1 as stored in the backward. Inputs come from a numpy seed
at B 2, N 17 and 34, D 128, 2 heads of 64, hidden 512, float32 on both
sides; the JAX kernels need N % 8 == 0, so they take the tokens padded
(keys masked by a -1e9 bias or by n_real, zero cotangents on padded rows).
Bound: max|d| <= 2e-5 * max(1, max|ref|) for the output and every gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.fused_attn_o import fused_attn_o_residual as jax_attn_o
from nextgen_uia_tpu.ops.fused_ln_mlp import fused_ln_mlp_residual as jax_ln_mlp
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.nn.layers import ACTIVATIONS
from nextgen_uia_tpu_torch.ops import fused_attn_o as fao
from nextgen_uia_tpu_torch.ops import fused_ln_mlp as flm
from nextgen_uia_tpu_torch.ops._frozen import layernorm_parts
from nextgen_uia_tpu_torch.ops.flash_attention import (flash_attention_backward_plain,
                                                       flash_attention_lse_plain,
                                                       flash_attention_plain)

B, D, H, DH = 2, 128, 2, 64
F32 = torch.float32


def _block(seed):
    """A port Block with perturbed LayerNorms and biases, and the JAX
    package's parameter dicts of the same weights."""
    gen = torch.Generator().manual_seed(seed)
    blk = Block(gen, ViTConfig(width=D, heads=H))
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2):
            ln.scale.add_(0.2 * torch.randn(D, generator=gen))
            ln.bias.add_(0.2 * torch.randn(D, generator=gen))
        for lin in (blk.attn.o, blk.mlp.fc1, blk.mlp.fc2):
            lin.b.add_(0.1 * torch.randn(lin.b.shape, generator=gen))

    def tree(m):
        return {k: jnp.asarray(v.numpy()) for k, v in m.named_parameters()}

    return blk, {"o": tree(blk.attn.o), "ln2": tree(blk.ln2),
                 "mlp": {k: tree(getattr(blk.mlp, k)) for k in ("fc1", "fc2")}}


def _padded(n):
    return -(-n // 8) * 8


def _pad(a, axis, to):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, to - a.shape[axis])
    return np.pad(a, pad)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _k6_dataflow(q, k, v, x, o, g, bias, n_real):
    """K6's forward and backward kernels' dataflow in plain PyTorch:
    returns (out, dq, dk, dv)."""
    b, h, n, dh = q.shape
    d = h * dh
    heads, cat_strides = fao._layout(b, n, h, dh)
    kb = fao._key_bias(bias, b, n, n_real, q.device)
    qv, kv, vv = (t.contiguous().as_strided((b, h, n, dh), (*heads, 1)) for t in (q, k, v))
    # forward: K7 writes the head concat row-major, the core adds bo and x
    cat = torch.empty(b * n, d)
    cat_heads = cat.as_strided((b, h, n, dh), (*cat_strides, 1))
    cat_heads.copy_(flash_attention_plain(qv, kv, vv, bias=kb, layout="bhnd"))
    wo_t, bo = fao._kernel_weights(o, F32)
    out = (cat @ wo_t.T + bo + x.reshape(b * n, d)).reshape(b, n, d)
    # backward: doh = g Wo^T stored head-major (the core's heads_matrix), o
    # and the lse recomputed, K7's backward at the head-major strides
    wo, _ = fao._weights(o, F32)
    doh = torch.empty(b, h, n, dh)
    doh.as_strided((b, h, n, dh), (*heads, 1)).copy_(
        (g.reshape(b * n, d) @ wo.T).reshape(b, n, h, dh).transpose(1, 2))
    o_again = flash_attention_plain(qv, kv, vv, bias=kb, layout="bhnd")
    lse = flash_attention_lse_plain(qv, kv, bias=kb, layout="bhnd")
    assert torch.equal(o_again, cat_heads) and bool(torch.isfinite(lse).all())
    dq, dk, dv, _ = flash_attention_backward_plain(qv, kv, vv, kb, doh, layout="bhnd")
    return out, dq, dk, dv


@pytest.mark.parametrize("n", [17, 34])
@pytest.mark.parametrize("mask", ["key_bias", "n_real"])
def test_k6_dataflow_matches_jax_kernel(n, mask):
    blk, jp = _block(n)
    rng = np.random.default_rng(n + len(mask))
    npad = _padded(n)
    # n_real: both sides take the padded tokens, keys >= n masked by n_real;
    # key_bias: the port takes n tokens, JAX the padded ones with -1e9 keys
    n_port = npad if mask == "n_real" else n
    q, k, v = (rng.standard_normal((B, H, n_port, DH)).astype(np.float32) for _ in range(3))
    x, g = (rng.standard_normal((B, n_port, D)).astype(np.float32) for _ in range(2))
    if mask == "key_bias":
        bias = rng.standard_normal((B, n)).astype(np.float32)
        bias[1, -5:] = -1e9
        kw_j = {"bias": jnp.asarray(_pad(bias, 1, npad) - 1e9 * (np.arange(npad) >= n))}
        port_bias, n_real = torch.from_numpy(bias), n
    else:
        kw_j, port_bias, n_real = {"n_real": n}, None, n

    ins_j = [jnp.asarray(_pad(a, 2, npad)) for a in (q, k, v)] + [jnp.asarray(_pad(x, 1, npad))]
    out_j, vjp = jax.vjp(lambda *t: jax_attn_o(*t, jp["o"], heads=H, **kw_j), *ins_j)
    dq_j, dk_j, dv_j, dx_j = vjp(jnp.asarray(_pad(g, 1, npad)))

    t = [torch.from_numpy(a) for a in (q, k, v, x, g)]
    out, dq, dk, dv = _k6_dataflow(*t[:4], blk.attn.o, t[4], port_bias, n_real)
    _close(out.numpy(), np.asarray(out_j)[:, :n_port], "output")
    for got, want, what in ((dq, dq_j, "dq"), (dk, dk_j, "dk"), (dv, dv_j, "dv")):
        _close(got.numpy(), np.asarray(want)[:, :, :n_port], what)
    _close(g, np.asarray(dx_j)[:, :n_port], "dx")  # d(x) = g, passed through


def test_key_bias_folds_n_real():
    bias = torch.tensor([[0.5, -1.0, 2.0, 0.0]])
    assert fao._key_bias(None, 1, 4, 4, "cpu") is None
    assert torch.equal(fao._key_bias(bias, 1, 4, 4, "cpu"), bias)
    kb = fao._key_bias(bias, 1, 4, 2, "cpu")
    assert torch.equal(kb[:, :2], bias[:, :2]) and bool((kb[:, 2:] <= -1e30).all())
    assert bool((fao._key_bias(None, 1, 4, 3, "cpu") == torch.tensor([[0, 0, 0, -1e30]])).all())


def _k8_dataflow(x, ln, mlp, g, act, eps):
    """K8's forward and backward kernels' dataflow in plain PyTorch, on the
    weights as the wrappers hand them over: returns (out, dx)."""
    gamma, beta, w1_t, b1, w2_t, b2 = flm._kernel_weights(ln, mlp, F32)
    w1, w2 = mlp.fc1.w.detach(), mlp.fc2.w.detach()
    z = flm._ln(x, gamma, beta, eps)
    a = z @ w1_t.T + b1
    out = x + ACTIVATIONS[act](a) @ w2_t.T + b2
    dpre = (g @ w2.T) * flm.act_grad(act, a)
    dz = dpre @ w1.T
    xhat, rstd = layernorm_parts(x, eps)
    dxhat = dz * gamma
    dx = g + (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    return out, dx


@pytest.mark.parametrize("n", [17, 34])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_k8_dataflow_matches_jax_kernel(n, act):
    blk, jp = _block(3 * n)
    gamma, beta, w1_t, b1, w2_t, b2 = flm._kernel_weights(blk.ln2, blk.mlp, F32)
    assert torch.equal(w1_t, blk.mlp.fc1.w.T) and torch.equal(w2_t, blk.mlp.fc2.w.T)
    assert w1_t.is_contiguous() and w2_t.is_contiguous()
    rng = np.random.default_rng(n)
    m = B * n
    x, g = (rng.standard_normal((m, D)).astype(np.float32) for _ in range(2))
    out_j, vjp = jax.vjp(lambda xx: jax_ln_mlp(xx, jp["ln2"], jp["mlp"], act=act),
                         jnp.asarray(_pad(x, 0, _padded(m))))
    (dx_j,) = vjp(jnp.asarray(_pad(g, 0, _padded(m))))
    with torch.no_grad():
        out, dx = _k8_dataflow(torch.from_numpy(x), blk.ln2, blk.mlp, torch.from_numpy(g), act,
                               1e-5)
    _close(out.numpy(), np.asarray(out_j)[:m], "output")
    _close(dx.numpy(), np.asarray(dx_j)[:m], "dx")


@pytest.mark.parametrize("dh", [32, 48])
def test_bf16_k6_refuses_head_dim_not_64(dh):
    """The bf16 path is K7's wgmma kernels (head dim 64); another head dim
    raises a ValueError naming the shape, with no fallback."""
    q = torch.zeros(2, 4, 17, dh, dtype=torch.bfloat16)
    x = torch.zeros(2, 17, 4 * dh, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=rf"q \(2, 4, 17, {dh}\).*head dim {dh}"):
        fao._check_cuda(q, x, None, 17)
    fao._check_cuda(q.float(), x.float(), None, 17)  # float32 takes 1..64
