"""K2 and K3 (the MONA spatial op, csrc/mona_spatial.cu) as their CUDA
kernels compute them, on the CPU.

The backward kernel sums in its own order: each (sample, row, channel)
thread keeps partials of the 49 taps' g * u, of s * du and of g over its
row's columns; a CTA adds its strip's rows in order, the last strip CTA of
a sample adds the strips in order, and the last CTA of a channel group adds
dfreq's per-sample partials in sample order.
``dwconv._strip_backward`` is that order in plain float32; here it is held
to jax.vjp of the JAX
package's ``mona_spatial`` (the Pallas kernels in interpret mode) at the
strip counts ``dwconv._grid`` picks, and at every strip count against the
port's plain backward. Bound: max|d| <= 2e-5 * max(1, max|ref|) for ds,
dfreq, dk and dbias (float32 sums of up to 196 products taken in other
orders). ``_grid`` is held to what the kernels take: the access width
divides a pixel's bytes and the operands' alignment, whole vectors make a
channel group, whole groups make C, at most 256 threads a CTA (a thread
a channel and row), no empty strip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.ops.dwconv import mona_spatial as jax_mona_spatial
from nextgen_uia_tpu_torch.ops import dwconv

TOL = 2e-5


def _inputs(shape, seed):
    b, _, _, c = shape
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal(shape), 1 + 0.3 * rng.standard_normal(c),
           0.2 * rng.standard_normal((b, 7, 7, c)), rng.standard_normal((b, c)),
           rng.standard_normal(shape)]
    return [a.astype(np.float32) for a in ins]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = TOL * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


@pytest.mark.parametrize("shape", [(2, 14, 14, 64), (3, 9, 11, 24), (1, 3, 5, 8),
                                   (1, 81, 6, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strip_backward_matches_jax_vjp(shape, dtype):
    """The kernel's order of sums, at the grid the wrapper picks for the
    dtype, against jax.vjp of the JAX kernel; [1, 81, 6, 16] takes three
    strips in bf16 and two in float32."""
    s, freq, kernels, bias, g = _inputs(shape, sum(shape))
    _, vjp = jax.vjp(jax_mona_spatial, *map(jnp.asarray, (s, freq, kernels, bias)))
    want = vjp(jnp.asarray(g))
    grid = dwconv._grid(*shape[1:], torch.tensor([], dtype=dtype).element_size())
    got = dwconv._strip_backward(*map(torch.from_numpy, (s, freq, kernels, g)), grid.strips)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_strip_backward_at_every_strip_count():
    """Any split of the rows into strips gives the plain backward's
    gradients: rows, strips and samples summed in order."""
    shape = (2, 9, 5, 8)
    s, freq, kernels, _, g = map(torch.from_numpy, _inputs(shape, 7))
    want = dwconv.mona_spatial_backward_plain(s, freq, kernels, g)
    for strips in range(1, shape[1] + 1):
        got = dwconv._strip_backward(s, freq, kernels, g, strips)
        for a, b in zip(got, want):
            _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape,elem,want", [
    ((64, 14, 14, 64), 2, (16, 16, 1)),  # the bench step, bf16: 32-byte groups, one CTA a sample
    ((32, 14, 14, 64), 2, (16, 16, 1)),  # the supervised step
    ((64, 14, 14, 64), 4, (16, 8, 1)),   # float32
    ((2, 9, 11, 12), 2, (8, 12, 1)),     # 24 bytes a pixel: 8-byte copies
    ((2, 9, 11, 12), 4, (16, 4, 1)),
    ((3, 9, 11, 24), 2, (16, 8, 1)),
    ((1, 3, 5, 8), 2, (16, 8, 1)),
    ((3, 9, 11, 3), 2, (2, 3, 1)),       # an odd width: 2-byte copies
    ((3, 9, 11, 3), 4, (4, 3, 1)),
    ((1, 24, 6, 16), 2, (16, 8, 1)),     # 24 rows: narrower groups
    ((2, 70, 5, 16), 2, (16, 8, 3)),     # 70 rows of 8 channels: three strips
    ((2, 70, 5, 16), 4, (16, 4, 2)),
])
def test_grid_picks(shape, elem, want):
    assert tuple(dwconv._grid(*shape[1:], elem)) == want


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("align", [16, 8, 4])
def test_grid_is_what_the_kernels_take(elem, align):
    """csrc/mona_spatial.cu::geometry_ok, for widths 1-96 and heights 1-161."""
    for c in range(1, 97):
        for h in (1, 2, 7, 14, 17, 33, 80, 161):
            access, cg, strips = dwconv._grid(h, 5, c, elem, align)
            assert access >= elem and access in dwconv.ACCESS_BYTES
            assert (c * elem) % access == 0 and (align % access == 0 or access == elem)
            assert cg % (access // elem) == 0 and c % cg == 0
            rows = -(-h // strips)
            assert cg * rows <= dwconv.CTA_THREADS and (strips - 1) * rows < h


def test_grid_narrows_the_access_to_the_alignment():
    assert dwconv._grid(14, 14, 64, 2, align=8).access == 8
    assert dwconv._grid(14, 14, 64, 4, align=4).access == 4
