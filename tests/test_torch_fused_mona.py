"""The port's fused MONA adapter (K12) against the JAX package, on the CPU.

On a CPU tensor ``mona_block_fused`` runs its plain forward and its explicit
plain backward (the formulas of the JAX ``_bwd_kernel``). Float32 inputs
made from a numpy seed, parameters crossing through the weight bridge:
  - against the JAX kernel (Pallas, interpret mode) at B = 2, a 4x4 grid,
    D = 128, N = 24 (CLS, 16 spatial rows, 7 tail rows), all four variants
    and a given dropout mask: output and dx within 2e-5 * max(1, max|ref|),
    every parameter gradient within 1e-4 * its own max|ref|;
  - at N = 17, unpadded, which the JAX kernel declines, against the JAX
    package's composed ``mona_apply`` (eval), to the same tolerances;
  - the explicit backward against autograd of the plain forward;
  - ``mona_apply`` with and without NEXTGEN_UIA_FUSED_MONA=1 under one seeded
    generator: the same output and gradients within 1e-5 relative (one
    dropout stream);
  - parameters that do not match the variant, and a sequence without a CLS
    row, decline (None).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.ops.fused_mona import mona_block_fused as jax_fused
from nextgen_uia_tpu_torch.adapters.mona import VARIANTS, Mona, mona_apply
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.ops import PLAIN, fused_mona

B, H, W, D, C = 2, 4, 4, 128, 64


def _adapters(tmp_path, variant, seed):
    """(JAX adapter tree, the same weights in the port's Mona, trainable)."""
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
    _, n = ckpt.load_into(str(tmp_path / f"mona_{variant}.npz"), m)
    assert n == len(m.state_dict())
    for t in m.parameters():
        t.requires_grad_(True)
    return p, m


def _jax_leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def _inputs(n, seed, mask=True):
    rng = np.random.default_rng(seed)
    x = (0.6 * rng.standard_normal((B, n, D))).astype(np.float32)
    g = rng.standard_normal((B, n, D)).astype(np.float32)
    m = ((rng.random((B, n, C)) < 0.9) / 0.9).astype(np.float32) if mask else None
    return x, g, m


def _port_grads(m, x, g, mask, fn):
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in m.parameters():
        t.grad = None
    out = fn(xt, None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), {k: t.grad.numpy()
                                                   for k, t in m.named_parameters()}


def _close(got, want, what, rel):
    scale = max(1.0, float(np.abs(want).max())) if rel is None else float(np.abs(want).max())
    tol = (2e-5 if rel is None else rel) * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _compare(m, p, x, g, mask, jax_fn, port_fn):
    want, vjp = jax.vjp(jax_fn, p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    out, dx, grads = _port_grads(m, x, g, mask, port_fn)
    _close(out, np.asarray(want), "output", None)
    _close(dx, np.asarray(gx), "dx", None)
    for name, got in grads.items():
        _close(got, _jax_leaf(gp, name), name, 1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_mona_matches_jax_kernel(tmp_path, variant):
    p, m = _adapters(tmp_path, variant, seed=len(variant))
    x, g, mask = _inputs(H * W + 1 + 7, seed=len(variant))
    _compare(m, p, x, g, mask,
             lambda pp, xx: jax_fused(pp, xx, (H, W), variant=variant, mask=jnp.asarray(mask)),
             lambda xx, mm: fused_mona.mona_block_fused(m, xx, (H, W), variant=variant, mask=mm))


@pytest.mark.parametrize("variant", ["hybrid", "baseline"])
def test_fused_mona_unpadded_matches_jax_composed(tmp_path, variant):
    p, m = _adapters(tmp_path, variant, seed=3)
    x, g, _ = _inputs(H * W + 1, seed=5, mask=False)
    assert jax_fused(p, jnp.asarray(x), (H, W), variant=variant) is None  # N % 8
    _compare(m, p, x, g, None,
             lambda pp, xx: jax_mona.mona_apply(pp, xx, (H, W), variant=variant),
             lambda xx, mm: fused_mona.mona_block_fused(m, xx, (H, W), variant=variant))


@pytest.mark.parametrize("variant", ["hybrid", "freq_enhanced"])
def test_explicit_backward_matches_autograd_of_plain(tmp_path, variant):
    _, m = _adapters(tmp_path, variant, seed=7)
    x, g, mask = _inputs(H * W + 3, seed=7)
    out, dx, grads = _port_grads(
        m, x, g, mask,
        lambda xx, mm: fused_mona.mona_block_fused_plain(m, xx, (H, W), variant=variant, mask=mm))
    with torch.no_grad():
        dx2, grads2 = fused_mona.mona_block_fused_backward(
            m, torch.from_numpy(x), (H, W), torch.from_numpy(g), variant=variant,
            mask=torch.from_numpy(mask))
    _close(dx2.numpy(), dx, "dx", None)
    assert set(grads2) == set(grads)
    for name, want in grads.items():
        _close(grads2[name].numpy(), want, name, 1e-5)


def test_route_matches_composed_under_one_generator(tmp_path, monkeypatch):
    _, m = _adapters(tmp_path, "hybrid", seed=11)
    x, g, _ = _inputs(H * W + 1 + 2, seed=11, mask=False)

    def run(opt_in):
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_MONA", "1" if opt_in else "0")
        before = fused_mona.mona_block_fused.launches
        res = _port_grads(m, x, g, None, lambda xx, _: mona_apply(
            m, xx, (H, W), variant="hybrid", gen=torch.Generator().manual_seed(42)))
        assert fused_mona.mona_block_fused.launches == before  # the CPU runs no kernel
        return res

    composed, fused = run(False), run(True)
    assert not np.allclose(composed[0], _run_eval(m, x)), "dropout drew no mask"
    for (a, b), what in zip(zip(composed[:2], fused[:2]), ("output", "dx")):
        _close(b, a, what, 1e-5)
    for name, want in composed[2].items():
        _close(fused[2][name], want, name, 1e-5)


def _run_eval(m, x):
    with torch.no_grad():
        return mona_apply(m, torch.from_numpy(x), (H, W), variant="hybrid").numpy()


def test_plain_route_through_plain_ops(tmp_path, monkeypatch):
    _, m = _adapters(tmp_path, "noise_aware", seed=13)
    x, _, mask = _inputs(H * W + 1, seed=13)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        want = fused_mona.mona_block_fused_plain(m, xt, (H, W), variant="noise_aware", mask=mt)
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_MONA", "1")
        got = mona_apply(m, xt, (H, W), variant="noise_aware", ops=PLAIN, mask=mt)
    assert torch.equal(got, want)


def test_mismatches_decline(tmp_path):
    _, hybrid = _adapters(tmp_path, "hybrid", seed=1)
    _, base = _adapters(tmp_path, "baseline", seed=1)
    x = torch.zeros(B, H * W + 1, D)
    for fn in (fused_mona.mona_block_fused, fused_mona.mona_block_fused_plain):
        assert fn(hybrid, x, (H, W), variant="baseline") is None      # extra slots
        assert fn(base, x, (H, W), variant="noise_aware") is None     # missing slots
        assert fn(hybrid, x, (H, W), variant="freq_enhanced") is None
        assert fn(hybrid, x[:, 1:], (H, W), variant="hybrid") is None  # no CLS row
        assert fn(hybrid, x, (H, W), variant="hybrid") is not None
