"""K5 pre-norm (LayerNorm + q/k/v, forward and dx backward) as its CUDA
kernels compute it, composed on the CPU from the port's plain functions,
against the JAX package's Pallas kernels (interpret mode).

The kernels (csrc/fused_ln_qkv.cu): the forward runs the LayerNorm into z,
then one product z @ (W_qkv^T)^T + b on the Hopper GEMM core, which reads
``_weights(..., transposed=True)``'s W_qkv^T [3D, D] and writes q, k, v
head-major; the backward runs dz = [dq|dk|dv] @ W_qkv^T on W_qkv [D, 3D] as
stored, the float32 dz stored whole, then the LayerNorm backward with the
statistics recomputed from x. Inputs come from a numpy seed at B 3, N 37
(111 rows, an odd count), D 128, 2 heads of 64, float32 on both sides; the
JAX kernels need N % 8 == 0, so they take the tokens padded with zeros
(and zero gradients) to 40 and the first 37 are compared. Bound: max|d| <=
2e-5 * max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.fused_ln_qkv import fused_ln_qkv as jax_ln_qkv
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_ln_qkv as flq
from nextgen_uia_tpu_torch.ops._frozen import layernorm_parts

B, N, NP, D, H, EPS = 3, 37, 40, 128, 2, 1e-6
F32 = torch.float32


def _block(seed):
    """A port ViT Block with a perturbed LayerNorm and q/k/v biases, and
    the JAX package's dicts of the same weights."""
    gen = torch.Generator().manual_seed(seed)
    blk = Block(gen, ViTConfig(width=D, heads=H))
    with torch.no_grad():
        blk.ln1.scale.add_(0.2 * torch.randn(D, generator=gen))
        blk.ln1.bias.add_(0.2 * torch.randn(D, generator=gen))
        for lin in (blk.attn.q, blk.attn.k, blk.attn.v):
            lin.b.add_(0.1 * torch.randn(D, generator=gen))

    def j(t):
        return jnp.asarray(t.detach().numpy())

    jln = {"scale": j(blk.ln1.scale), "bias": j(blk.ln1.bias)}
    jattn = {k: {"w": j(getattr(blk.attn, k).w), "b": j(getattr(blk.attn, k).b)}
             for k in ("q", "k", "v")}
    return blk, jln, jattn


def _tokens(seed, *shape_tail):
    """[B, N, ...] from a numpy seed, and the same padded with zeros to NP
    tokens for the JAX kernels."""
    a = np.random.default_rng(seed).standard_normal((B, N, *shape_tail)).astype(np.float32)
    return a, np.pad(a, ((0, 0), (0, NP - N)) + ((0, 0),) * len(shape_tail))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def test_k5_prenorm_forward_dataflow_matches_jax_kernel():
    """z = LN(x); [q|k|v] = z @ (W_qkv^T)^T + b_qkv on the forward kernel's
    W_qkv^T, split into heads [B, H, N, 64]."""
    blk, jln, jattn = _block(1)
    x, xp = _tokens(2, D)
    want = jax_ln_qkv(jnp.asarray(xp), jln, jattn, heads=H, eps=EPS)
    assert want is not None  # the JAX kernel took the padded tokens
    gamma, beta, w_qkv_t, b_qkv = flq._weights(blk.ln1, blk.attn, F32, transposed=True)
    xhat, _ = layernorm_parts(torch.from_numpy(x), EPS)
    z = xhat * gamma + beta
    qkv = z.reshape(B * N, D) @ w_qkv_t.T + b_qkv
    got = qkv.reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
    for t, g_, w_ in zip("qkv", got, want):
        _close(g_.numpy(), np.asarray(w_)[:, :, :N], f"K5 pre-norm {t} [{B}, {N}, {D}]")


def test_k5_prenorm_backward_dataflow_matches_jax_kernel():
    """dz = [dq|dk|dv] @ W_qkv^T on W_qkv as stored (the float32 product the
    core stores), then the LayerNorm backward with the statistics
    recomputed from x; against jax.vjp of the JAX kernel (its custom VJP,
    the Pallas _bwd_kernel)."""
    blk, jln, jattn = _block(3)
    x, xp = _tokens(4, D)
    dys = [_tokens(5 + i, D)[0].reshape(B, N, H, D // H).transpose(0, 2, 1, 3)
           for i in range(3)]
    dyp = [np.pad(t, ((0, 0), (0, 0), (0, NP - N), (0, 0))) for t in dys]
    _, vjp = jax.vjp(lambda t: jax_ln_qkv(t, jln, jattn, heads=H, eps=EPS), jnp.asarray(xp))
    (want,) = vjp(tuple(jnp.asarray(t) for t in dyp))
    gamma, _, w_qkv, _ = flq._weights(blk.ln1, blk.attn, F32)
    dy = flq._head_cat(*(torch.from_numpy(t) for t in dys))
    dz = dy @ w_qkv.T
    xhat, rstd = layernorm_parts(torch.from_numpy(x).reshape(B * N, D), EPS)
    dxhat = dz * gamma
    got = (dxhat - dxhat.mean(-1, keepdim=True)
           - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    _close(got.reshape(B, N, D).numpy(), np.asarray(want)[:, :N], f"K5 pre-norm dx [{B}, {N}]")


def test_k5_weights_are_the_transpose():
    """The forward kernel's W_qkv^T [3D, D] and the backward's W_qkv [D,
    3D], contiguous in the working dtype, LayerNorm vectors float32."""
    blk, _, _ = _block(7)
    bf = torch.bfloat16
    gamma, beta, w_t, b = flq._weights(blk.ln1, blk.attn, bf, transposed=True)
    _, _, w, b2 = flq._weights(blk.ln1, blk.attn, bf)
    lins = (blk.attn.q, blk.attn.k, blk.attn.v)
    assert w.shape == (D, 3 * D) and torch.equal(w, torch.cat([lin.w for lin in lins], 1).to(bf))
    assert w_t.shape == (3 * D, D) and torch.equal(w_t, w.T)
    assert w_t.is_contiguous() and w.is_contiguous() and w_t.dtype == w.dtype == bf
    assert gamma.dtype == beta.dtype == b.dtype == F32 and torch.equal(b, b2)


@pytest.mark.parametrize("heads,ok", [(2, True), (4, False)])
def test_k5_prenorm_bf16_refuses_head_dim_not_a_multiple_of_64(heads, ok):
    """K5 pre-norm's bf16 products are the Hopper GEMM core's (a K step or
    an output box is one head's 64 columns): bf16 with dh = 32 raises
    before any launch, naming the limit; float32 (the SIMT GEMM) takes
    it."""
    x = torch.zeros(B, N, D)
    flq._check_hopper_cuda(x, heads, "fused_ln_qkv")
    if ok:
        flq._check_hopper_cuda(x.to(torch.bfloat16), heads, "fused_ln_qkv")
    else:
        with pytest.raises(ValueError, match=r"fused_ln_qkv bf16 .*head dim 32"):
            flq._check_hopper_cuda(x.to(torch.bfloat16), heads, "fused_ln_qkv")
