"""K9 (BERT's post-norm MLP + LayerNorm) and K10 (the MLP with frozen
weights, forward and dx backward) as their CUDA kernels compute them,
composed on the CPU from the port's plain functions, against the JAX
package's Pallas kernels (interpret mode).

The kernels (csrc/block_products.cuh::mlp and ::mlp_bwd) run each product
flat over the M rows on the weights the wrappers hand over: K9 and K10's
forward take ``_kernel_weights``' W1^T and W2^T (the Hopper GEMM core reads
a weight as [cols, K]), fc1 with bias + activation, fc2 with b2 (K9: and
the residual x, the sum float32 until its LayerNorm, eps 1e-12); K10's
backward recomputes a = x W1 + b1 from W1^T, then dpre = (g W2^T) *
act'(a) and dx = dpre W1^T on W2 and W1 as stored. Inputs come from a
numpy seed at D 128, hidden 512, float32 on both sides, with gelu and
quick_gelu, at M = 24 and at M = 37; the JAX kernels need M % 8 == 0 (at
37 rows ``fused_mlp`` would take its XLA fallback and
``fused_postnorm_mlp_ln`` returns None), so they take the rows padded with
zeros and the first M rows are compared. Bound: max|d| <= 2e-5 * max(1,
max|ref|).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.fused_ln_mlp import fused_postnorm_mlp_ln as jax_postnorm_mlp
from nextgen_uia_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from nextgen_uia_tpu_torch.nn.layers import ACTIVATIONS
from nextgen_uia_tpu_torch.ops import fused_ln_mlp as flm
from nextgen_uia_tpu_torch.ops import fused_mlp as fm
from nextgen_uia_tpu_torch.ops._frozen import layernorm_parts

D, HIDDEN, EPS = 128, 512, 1e-12
F32 = torch.float32
CASES = [(m, act) for m in (24, 37) for act in ("gelu", "quick_gelu")]


def _weights(seed):
    """numpy fc1/fc2 and LayerNorm weights: the port's module view
    (``.fc1.w`` [D, hidden] as stored) and the JAX package's dicts."""
    rng = np.random.default_rng(seed)
    w = {"w1": rng.standard_normal((D, HIDDEN)) / np.sqrt(D),
         "b1": 0.1 * rng.standard_normal(HIDDEN),
         "w2": rng.standard_normal((HIDDEN, D)) / np.sqrt(HIDDEN),
         "b2": 0.1 * rng.standard_normal(D),
         "scale": 1.0 + 0.2 * rng.standard_normal(D), "bias": 0.2 * rng.standard_normal(D)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    mlp = SimpleNamespace(fc1=SimpleNamespace(w=t["w1"], b=t["b1"]),
                          fc2=SimpleNamespace(w=t["w2"], b=t["b2"]))
    ln = SimpleNamespace(scale=t["scale"], bias=t["bias"])
    jmlp = {"fc1": {"w": jnp.asarray(w["w1"]), "b": jnp.asarray(w["b1"])},
            "fc2": {"w": jnp.asarray(w["w2"]), "b": jnp.asarray(w["b2"])}}
    jln = {"scale": jnp.asarray(w["scale"]), "bias": jnp.asarray(w["bias"])}
    return mlp, ln, jmlp, jln


def _rows(m, seed):
    """x [m, D] from a numpy seed, and the same rows zero-padded to a
    multiple of 8 for the JAX kernels."""
    x = np.random.default_rng(seed).standard_normal((m, D)).astype(np.float32)
    return x, np.pad(x, ((0, -(-m // 8) * 8 - m), (0, 0)))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _k10_forward(x, w, act):
    """csrc/fused_mlp.cu::nx_mlp_fwd (block_products.cuh::mlp with a
    bias-only fc2) on ``fused_mlp._kernel_weights``."""
    h = ACTIVATIONS[act](x @ w["w1_t"].T + w["b1"])
    return h @ w["w2_t"].T + w["b2"]


@pytest.mark.parametrize("m,act", CASES)
def test_k9_dataflow_matches_jax_kernel(m, act):
    """fc1 on W1^T with bias + activation, fc2 on W2^T adding b2 and the
    residual x in float32 (y32), the LayerNorm of y32 with eps 1e-12."""
    mlp, ln, jmlp, jln = _weights(m + len(act))
    x, xp = _rows(m, 3 * m)
    want = jax_postnorm_mlp(jnp.asarray(xp), jmlp, jln, act=act, eps=EPS)
    assert want is not None  # the JAX kernel took the padded rows
    gamma, beta, w1_t, b1, w2_t, b2 = flm._kernel_weights(ln, mlp, F32)
    xt = torch.from_numpy(x)
    y32 = xt + ACTIVATIONS[act](xt @ w1_t.T + b1) @ w2_t.T + b2
    got = layernorm_parts(y32, EPS)[0] * gamma + beta
    _close(got.numpy(), np.asarray(want)[:m], f"K9 {act} [{m}, {D}]")


@pytest.mark.parametrize("m,act", CASES)
def test_k10_forward_dataflow_matches_jax_kernel(m, act):
    mlp, _, jmlp, _ = _weights(2 * m + len(act))
    x, xp = _rows(m, 5 * m)
    want = jax_fused_mlp(jnp.asarray(xp), jmlp["fc1"]["w"], jmlp["fc1"]["b"],
                         jmlp["fc2"]["w"], jmlp["fc2"]["b"], act=act)
    w = fm._kernel_weights(mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, F32)
    got = _k10_forward(torch.from_numpy(x), w, act)
    _close(got.numpy(), np.asarray(want)[:m], f"K10 forward {act} [{m}, {D}]")


@pytest.mark.parametrize("m,act", CASES)
def test_k10_backward_dataflow_matches_jax_kernel(m, act):
    """a = x W1 + b1 recomputed on W1^T; dpre = (g W2^T) * act'(a) on W2
    as stored; dx = dpre W1^T on W1 as stored; against jax.vjp of the JAX
    kernel (its custom VJP, the Pallas _bwd_kernel)."""
    mlp, _, jmlp, _ = _weights(3 * m + len(act))
    x, xp = _rows(m, 7 * m)
    g, gp = _rows(m, 11 * m)
    args = [jmlp["fc1"]["w"], jmlp["fc1"]["b"], jmlp["fc2"]["w"], jmlp["fc2"]["b"]]
    _, vjp = jax.vjp(lambda x_: jax_fused_mlp(x_, *args, act=act), jnp.asarray(xp))
    (want,) = vjp(jnp.asarray(gp))
    w = fm._kernel_weights(mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, F32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    a = xt @ w["w1_t"].T + w["b1"]
    dpre = (gt @ mlp.fc2.w.T) * flm.act_grad(act, a)
    got = dpre @ mlp.fc1.w.T
    _close(got.numpy(), np.asarray(want)[:m], f"K10 dx {act} [{m}, {D}]")


@pytest.mark.parametrize("op", ["fused_mlp", "fused_postnorm_mlp_ln"])
def test_kernel_weights_are_the_transposes(op):
    """The forward kernels' weights: W1^T [hidden, D] and W2^T [D, hidden]
    in the working dtype, contiguous (the core's [cols, K]), the biases (and
    K9's LayerNorm) float32, one copy each."""
    mlp, ln, _, _ = _weights(1)
    bf = torch.bfloat16
    if op == "fused_mlp":
        w = fm._kernel_weights(mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, bf)
        w1_t, b1, w2_t, b2 = w["w1_t"], w["b1"], w["w2_t"], w["b2"]
    else:
        gamma, beta, w1_t, b1, w2_t, b2 = flm._kernel_weights(ln, mlp, bf)
        assert torch.equal(gamma, ln.scale) and torch.equal(beta, ln.bias)
    assert w1_t.shape == (HIDDEN, D) and w2_t.shape == (D, HIDDEN)
    assert torch.equal(w1_t, mlp.fc1.w.T.to(bf)) and w1_t.is_contiguous()
    assert torch.equal(w2_t, mlp.fc2.w.T.to(bf)) and w2_t.is_contiguous()
    assert w1_t.data_ptr() != mlp.fc1.w.data_ptr() and w2_t.data_ptr() != mlp.fc2.w.data_ptr()
    assert b1.dtype == F32 and torch.equal(b1, mlp.fc1.b)
    assert b2.dtype == F32 and torch.equal(b2, mlp.fc2.b)


# each wrapper -> its shape check, whose message names the op
CHECKS = {"fused_mlp": fm._check_cuda, "fused_mlp_backward": fm._check_cuda,
          "fused_postnorm_mlp_ln": lambda *a: flm._check_cuda(*a, "fused_postnorm_mlp_ln")}


@pytest.mark.parametrize("op", sorted(CHECKS))
def test_bf16_refuses_widths_not_multiples_of_64(op):
    """The bf16 products run on the Hopper GEMM core (K and the columns in
    64-wide boxes): a width or a hidden size that is not a multiple of 64
    raises a ValueError before any launch, with no fallback; 128 x 512 is
    taken."""
    check, name = CHECKS[op], "fused_mlp" if op.startswith("fused_mlp") else op
    x = torch.zeros(37, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=rf"{name}.*width 96, hidden 512"):
        check(x, 512, "gelu")
    with pytest.raises(ValueError, match=rf"{name}.*width 128, hidden 480"):
        check(torch.zeros(37, 128, dtype=torch.bfloat16), 480, "gelu")
    check(torch.zeros(37, 128, dtype=torch.bfloat16), 512, "quick_gelu")
