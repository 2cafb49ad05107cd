"""K12 (the whole MONA adapter) as its bf16 CUDA route computes it,
composed on the CPU from the port's plain stages, against the JAX
package's Pallas kernel (interpret mode).

The route (csrc/fused_mona.cu, bf16): forward (a) z1 and the row
statistics, then zd = z1 @ W_down + b_down on the Hopper GEMM core, which
reads ``_kernel_weights``' W_down^T [c, D]; (b) the per-image spatial
kernel through the masked GELU rows gd; (c) the up product on W_up^T [D,
c] with the two-rounding epilogue round(x + round(gd W_up + b_up)).
Backward: dgd = g @ W_up^T on W_up as stored; the per-image spatial
backward (d(zd)); d(z1) = d(zd) @ W_down^T on W_down as stored; the
LayerNorm backward over the row tiles ``_bwd_grid`` gives, the tiles'
column sums added in sum_splits' order; the weight gradients dW_up = gd^T
g and dW_down = (d(zd)^T z1)^T from per-split partials over 64-row chunks,
added in the same order. Here every stage runs in float32 (where the kernels
round to bf16 the values pass unchanged) on numpy-seeded inputs at D 128,
c 64, a 4 x 4 grid, B 3 and N 23 (69 rows, an odd count); the JAX kernel
takes N % 8 == 0, so it gets a 24th row of zeros (x, g and mask), a tail
row that adds nothing to any gradient, and the first 23 rows are compared.
All four variants, with and without a dropout mask. Bound: max|d| <= 2e-5
* max(1, max|ref|) for the output, dx and every parameter gradient.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.ops.fused_mona import mona_block_fused as jax_fused
from nextgen_uia_tpu_torch.adapters.mona import VARIANTS, Mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.ops import fused_mona as fm

B, N, H, W, D, C = 3, 23, 4, 4, 128, 64
SMS = 4  # a toy card: several row tiles and two weight splits at 69 rows
F32 = torch.float32


def _adapters(tmp_path, variant, seed):
    """(JAX adapter tree, the same weights as the port's {name: tensor})."""
    p = jax_mona.mona_init(jax.random.key(seed), D, C, variant)
    rng = np.random.default_rng(seed)
    # the init's gamma (1e-6) and unit filters would hide their paths
    p["gamma"] = jnp.asarray(0.5 * rng.standard_normal(D), jnp.float32)
    p["gammax"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(D), jnp.float32)
    p["norm"]["scale"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(D), jnp.float32)
    p["norm"]["bias"] = jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)
    if "freq_filter" in p:
        p["freq_filter"] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(C), jnp.float32)
    jax_ckpt.save(str(tmp_path / f"mona_{variant}.npz"), p)
    m = Mona(torch.Generator().manual_seed(seed), D, C, variant)
    ckpt.load_into(str(tmp_path / f"mona_{variant}.npz"), m)
    return p, m


def _jax_leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def _inputs(seed, with_mask):
    rng = np.random.default_rng(seed)
    x = (0.6 * rng.standard_normal((B, N, D))).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = (((rng.random((B, N, C)) < 0.9) / 0.9).astype(np.float32) if with_mask
            else np.ones((B, N, C), np.float32))
    return x, g, mask


def _pad_row(a):
    return np.pad(a, ((0, 0), (0, 1), (0, 0)))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _kernel_forward(q, x, mask, static):
    """Forward stages (a), (b), (c) on the kernels' weights: (out, the
    intermediates the backward reads)."""
    uw, uw_t, wd_t, wd = fm._kernel_weights(q, F32)
    z1, xhat, rstd, z0 = fm._z1_stage(x, q)
    zd = (z1 @ wd_t.T + q["down.b"]).reshape(B, N, C)
    iv = fm._spatial_forward(zd, mask, q, static, F32)
    u = iv["gd"].reshape(B * N, C) @ uw_t.T + q["up.b"]
    iv.update(xhat=xhat, rstd=rstd, z0=z0, z1=z1, zd=zd)
    return (x.reshape(B * N, D) + u).reshape(B, N, D), iv


def _in_order(parts, warps=8):
    """The partials summed in sum_splits' order: warp w adds partials w, w
    + 8, ... one after the other, then the warps' sums are added in warp
    order."""
    sums = []
    for w in range(warps):
        acc = torch.zeros_like(parts[0])
        for p in parts[w::warps]:
            acc = acc + p
        sums.append(acc)
    total = torch.zeros_like(parts[0])
    for acc in sums:
        total = total + acc
    return total


def _kernel_backward(q, x, g, mask, static, iv):
    """Backward stages on the kernels' weights, tiles and splits: (dx,
    {name: gradient})."""
    m = B * N
    uw, _, _, wd = fm._kernel_weights(q, F32)
    gf = g.reshape(m, D)
    dgd = gf @ uw.T
    dzd, grads = fm._spatial_backward(dgd, mask, q, static, iv, F32)
    dz1 = dzd @ wd.T
    dx, terms = fm._ln_terms(x, g, dz1, iv, q)
    tiles, rows, splits = fm._bwd_grid(m, D, torch.bfloat16, SMS)
    assert tiles > 1 and splits > 1  # the partials' order is exercised
    spans = [(t * rows, min(m, (t + 1) * rows)) for t in range(tiles)]
    grads.update(zip(fm.LN_TERMS, _in_order([terms[:, a:e].sum(1) for a, e in spans])))
    grads["down.b"] = _in_order([dzd[a:e].sum(0) for a, e in spans])
    per = 64 * math.ceil(math.ceil(m / 64) / splits)
    chunks = [(s * per, min(m, (s + 1) * per)) for s in range(splits)]
    gd = iv["gd"].reshape(m, C)
    grads["up.w"] = _in_order([gd[a:e].T @ gf[a:e] for a, e in chunks])
    grads["down.w"] = _in_order([dzd[a:e].T @ iv["z1"][a:e] for a, e in chunks]).T
    return dx.reshape(B, N, D), grads


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_k12_kernel_dataflow_matches_jax_kernel(tmp_path, variant, with_mask):
    p, m = _adapters(tmp_path, variant, seed=len(variant) + with_mask)
    x, g, mask = _inputs(len(variant) + 2 * with_mask, with_mask)
    jmask = jnp.asarray(_pad_row(mask))
    want, vjp = jax.vjp(lambda pp, xx: jax_fused(pp, xx, (H, W), variant=variant, mask=jmask),
                        p, jnp.asarray(_pad_row(x)))
    gp, gx = vjp(jnp.asarray(_pad_row(g)))
    static = fm._static(m, torch.from_numpy(x), (H, W), variant)
    q = {k: t.detach() for k, t in m.named_parameters()}
    xt, gt, mt = (torch.from_numpy(a) for a in (x, g, mask))
    out, iv = _kernel_forward(q, xt, mt, static)
    dx, grads = _kernel_backward(q, xt, gt, mt, static, iv)
    _close(out.numpy(), np.asarray(want)[:, :N], f"{variant} output")
    _close(dx.numpy(), np.asarray(gx)[:, :N], f"{variant} dx")
    assert set(grads) == set(q)
    for name, got in grads.items():
        _close(got.numpy(), _jax_leaf(gp, name), f"{variant} d{name}")


def test_kernel_weights_are_the_transposes():
    """The products' weights in bf16, contiguous copies: W_up [c, D] and
    W_down [D, c] as stored, W_up^T [D, c] and W_down^T [c, D] (the
    forward's K-major operands of the Hopper core, [cols, K])."""
    m = Mona(torch.Generator().manual_seed(0), D, C, "hybrid")
    q = dict(m.named_parameters())
    bf = torch.bfloat16
    uw, uw_t, wd_t, wd = fm._kernel_weights(q, bf)
    assert uw.shape == (C, D) and torch.equal(uw, q["up.w"].to(bf))
    assert wd.shape == (D, C) and torch.equal(wd, q["down.w"].to(bf))
    assert uw_t.shape == (D, C) and torch.equal(uw_t, q["up.w"].T.to(bf))
    assert wd_t.shape == (C, D) and torch.equal(wd_t, q["down.w"].T.to(bf))
    for t in (uw, uw_t, wd_t, wd):
        assert t.dtype == bf and t.is_contiguous()
    assert uw_t.data_ptr() != uw.data_ptr() and wd_t.data_ptr() != wd.data_ptr()


def test_up_epilogue_rounds_twice():
    """The up product's epilogue, round(x + round(v + b_up)) in bf16 (the
    Hopper core's RoundResidualEpilogue), is the plain version's bf16 up
    projection and residual bit for bit; rounding once, round(x + v +
    b_up) (ResidualEpilogue's), differs on these inputs."""
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((257, D)).astype(np.float32)).to(bf)
    v = torch.from_numpy(3 * rng.standard_normal((257, D)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    plain = x + (v + b).to(bf)            # _forward_core: u = (... + up.b).to(cdt); x + u
    two = (x.float() + (v + b).to(bf).float()).to(bf)
    one = (x.float() + v + b).to(bf)
    assert torch.equal(two, plain)
    assert not torch.equal(one, plain)


def test_bwd_grid_fills_the_card():
    """bf16 row tiles of the LayerNorm backward (a multiple of 16 rows, two
    per SM) and weight splits (the 128-column tiles times the splits fill
    the SMs; 64-column tiles where 128 does not divide the width), at the
    bench step's 64 x 197 rows on 132 SMs; float32 keeps 32-row tiles and
    32 splits."""
    assert fm._bwd_grid(64 * 197, 768, torch.bfloat16, 132) == (263, 48, 22)
    assert fm._bwd_grid(32 * 197, 768, torch.bfloat16, 132) == (197, 32, 22)
    assert fm._bwd_grid(64 * 197, 832, torch.bfloat16, 132) == (263, 48, 10)
    assert fm._bwd_grid(69, 128, torch.bfloat16, 132) == (5, 16, 2)
    assert fm._bwd_grid(64 * 197, 768, F32, 132) == (394, 32, 32)


@pytest.mark.parametrize("width,ok", [(1536, True), (1600, False)])
def test_bf16_refuses_widths_its_layernorm_backward_cannot_stage(width, ok):
    """The bf16 LayerNorm backward stages 16 rows of the width in shared
    memory: a bf16 width above 1536 raises before any launch and names the
    limit; float32 takes it."""
    m = Mona(torch.Generator().manual_seed(0), width, C, "baseline")
    q = dict(m.named_parameters())
    x = torch.zeros(2, 17, width)
    static = (4, 4, False, False)
    mask = torch.ones(2, 17, C)
    fm._check_cuda(x, mask, q, static)
    if ok:
        fm._check_cuda(x.to(torch.bfloat16), mask, q, static)
    else:
        with pytest.raises(ValueError, match=r"mona_block_fused.*bf16 width 1600"):
            fm._check_cuda(x.to(torch.bfloat16), mask, q, static)
