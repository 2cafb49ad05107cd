"""The port's MONA spatial op and adapter against the JAX package.

mona_spatial: the port's plain version (what its wrapper runs on a CPU
tensor) against the JAX Pallas kernel in interpret mode, atol 1e-5 in
float32 (49 float32 multiply-adds in another order). mona_apply: all four
variants, eval mode, against the JAX package's mona_apply on the CPU, atol
1e-5; parameters cross through the weight bridge and are made non-trivial
from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.ops.dwconv import mona_spatial as jax_mona_spatial
from nextgen_uia_tpu_torch.adapters.mona import VARIANTS, Mona, mona_apply
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.ops import dwconv

DIM = 128


@pytest.mark.parametrize("shape", [(3, 14, 14, 64), (2, 9, 11, 32)])
def test_mona_spatial_matches_jax_kernel(shape):
    b, _, _, c = shape
    rng = np.random.default_rng(sum(shape))
    s = rng.standard_normal(shape).astype(np.float32)
    freq = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    kernels = (0.2 * rng.standard_normal((b, 7, 7, c))).astype(np.float32)
    bias = rng.standard_normal((b, c)).astype(np.float32)
    want = jax_mona_spatial(*map(jnp.asarray, (s, freq, kernels, bias)))
    got = dwconv.mona_spatial(*map(torch.from_numpy, (s, freq, kernels, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_mona_spatial_rejects_other_devices():
    s = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        dwconv.mona_spatial(s, s[0, 0, 0], torch.zeros(1, 7, 7, 8, device="meta"), s[:, 0, 0])


def _adapters(tmp_path, variant, seed):
    """(JAX adapter tree, the same weights in the port's Mona)."""
    p = jax_mona.mona_init(jax.random.key(seed), DIM, 64, variant)
    rng = np.random.default_rng(seed)
    # the init's gamma (1e-6) and unit freq filter would hide their paths
    p["gamma"] = jnp.asarray(0.5 * rng.standard_normal(DIM), jnp.float32)
    p["gammax"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(DIM), jnp.float32)
    p["norm"]["scale"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(DIM), jnp.float32)
    if "freq_filter" in p:
        p["freq_filter"] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(64), jnp.float32)
    jax_ckpt.save(str(tmp_path / "mona.npz"), p)
    m = Mona(torch.Generator().manual_seed(seed), DIM, 64, variant)
    _, n = ckpt.load_into(str(tmp_path / "mona.npz"), m)
    assert n == len(m.state_dict())
    return p, m


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n_tail", [0, 3])
def test_mona_apply_matches_jax(tmp_path, variant, n_tail):
    """N = 1 + 5*5 (+ padded tail rows, which take the CLS path)."""
    p, m = _adapters(tmp_path, variant, seed=len(variant) + n_tail)
    x = np.random.default_rng(n_tail).standard_normal((2, 26 + n_tail, DIM)).astype(np.float32)
    want = jax_mona.mona_apply(p, jnp.asarray(x), (5, 5), variant=variant)
    with torch.no_grad():
        got = mona_apply(m, torch.from_numpy(x), (5, 5), variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
