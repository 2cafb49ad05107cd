"""K13's equalize as its CUDA kernel computes it, on the CPU: the plain
version ``ops/lut.py::equalize_plain`` (in place over a list of images of
the batch) against the JAX package's ``data/augment.py::_equalize``
(``hist256_fact``, PIL's table, ``lut_apply_fact``) image by image, bit for
bit, at odd shapes, on a constant image (step 0: the identity), a
two-valued image and one that is 70% one value. JAX runs op by op here:
under jit XLA folds its ``/ 255`` into a multiply by the float reciprocal,
which differs from the quotient in the last bit for 126 of the 256 bytes.

The kernel stores each byte's value on the unit grid directly
(``unit_grid``) and skips the plain path's quantize to the uint8 grid:
``quantize_u8(v / 255) == v / 255`` for every byte v, checked exhaustively.
``apply_plan`` hands ``ops.equalize`` the batch and each slot's host index
list (one call a slot that drew it, no gather or copy around it) and
equals the JAX ops applied slot by slot. ``_eq_grid`` gives the cluster
and slice of the kernel's launches at the chip-smoke shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.data import augment as jaug
from nextgen_uia_tpu_torch.data import augment as aug
from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN, lut


def _on_grid(a):
    return (np.round(a * 255) / np.float32(255)).astype(np.float32)


def _images(rng, n, h, w):
    """n images on the byte grid: noise, one constant image, one two-valued
    image and one 70% one dark value (as ultrasound frames are), in turn."""
    x = _on_grid(rng.random((n, h, w)).astype(np.float32))
    for i in range(n):
        kind = i % 4
        if kind == 1:
            x[i] = np.float32(37 / 255)
        elif kind == 2:
            x[i] = np.where(rng.random((h, w)) < 0.4, np.float32(3 / 255), np.float32(250 / 255))
        elif kind == 3:
            x[i] = np.where(rng.random((h, w)) < 0.7, np.float32(5 / 255), x[i])
    return x


@pytest.mark.parametrize("n,h,w,idx", [
    (5, 37, 41, [4, 0, 2]), (4, 1, 1, [0, 1, 2, 3]), (6, 9, 130, [1, 3, 5]),
    (4, 64, 64, [3, 2])])
def test_equalize_plain_matches_jax_image_by_image(n, h, w, idx):
    rng = np.random.default_rng(h * w)
    x = _images(rng, n, h, w)
    got = lut.equalize_plain(torch.from_numpy(x.copy()), torch.tensor(idx)).numpy()
    for i in range(n):
        if i in idx:
            want = np.asarray(jaug._equalize(jnp.asarray(x[i][..., None])))[..., 0]
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_array_equal(got[i], x[i])  # not selected: untouched


def test_equalize_of_a_constant_image_is_the_identity():
    x = torch.full((2, 7, 5), 200 / 255)
    want = x.clone()
    lut.equalize_plain(x, [0, 1])
    assert torch.equal(x, want)
    assert torch.equal(lut.equalize_lut(lut.hist256_plain(x))[0], torch.arange(256))


def test_quantize_is_the_identity_on_the_unit_grid():
    """Exhaustive: quantize_u8(v / 255) == v / 255 for each byte v, so the
    kernel may store v / 255 (``unit_grid``) without quantizing it."""
    v = torch.arange(256, dtype=torch.float32)
    assert torch.equal(lut.quantize_u8(v / 255.0), v / 255.0)
    assert torch.equal(lut.unit_grid("cpu"), v / 255.0)
    assert torch.equal(lut.to_bytes(lut.unit_grid("cpu")), v.long())


def test_equalize_refuses_an_index_list_it_would_write_twice():
    x = torch.zeros(3, 4, 4)
    for bad in ([0, 0], [3], [-1]):
        with pytest.raises(ValueError, match="distinct images"):
            KERNELS.equalize(x, torch.tensor(bad))
    with pytest.raises(ValueError, match="1-D integer"):
        KERNELS.equalize(x, torch.tensor([0.0]))


def _jax_slot(x, op, u):
    """The JAX package's strong op ``op`` at unit draw u, then its uint8 round trip."""
    xj = jnp.asarray(x[..., None])
    if op == 2:
        y = jaug._equalize(xj)
    elif op == 7:
        y = jaug._posterize(xj, 8 - max(1, int(np.ceil(np.float32(4.0) * u))))
    else:
        y = jaug._solarize(xj, 256 - max(1, int(np.ceil(np.float32(255.0) * u))))
    return np.asarray(jaug._quantize_u8(y))[..., 0]


def test_apply_plan_calls_equalize_once_a_slot_in_place():
    """A strong-only plan of equalize, posterize and solarize (integer-valued
    ops: bit for bit), equalize drawn twice by one image and in three
    slots: ``apply_plan`` with KERNELS (the plain path on the CPU) equals the
    JAX ops slot by slot; ``ops.equalize`` gets the batch itself and the
    slot's images as a host list, once per slot that drew it."""
    rng = np.random.default_rng(7)
    n, h, w = 5, 19, 23
    x = _images(rng, n, h, w)
    ids = torch.zeros(n, aug.N_STRONG, dtype=torch.int64)
    ids[[0, 2, 3], 0] = 2
    ids[[0, 1], 1] = 7
    ids[4, 1] = 2
    ids[[1, 2], 2] = 8
    ids[[0, 1, 2, 3, 4], 3] = 2
    u = torch.from_numpy(rng.random((n, aug.N_STRONG)).astype(np.float32))
    plan = aug.Plan(strong_ids=ids, strong_u=u)
    calls = []

    def spy(xb, sel):
        calls.append((xb.data_ptr(), sel.device.type, sel.tolist()))
        return KERNELS.equalize(xb, sel)

    got, _ = aug.apply_plan(plan, torch.from_numpy(x)[..., None],
                            ops=dataclasses.replace(KERNELS, equalize=spy))
    assert [c[1:] for c in calls] == [("cpu", [0, 2, 3]), ("cpu", [4]), ("cpu", [0, 1, 2, 3, 4])]
    assert len({c[0] for c in calls}) == 1  # one buffer, written in place
    want = x.copy()
    for slot in range(aug.N_STRONG):
        for i in range(n):
            if ids[i, slot]:
                want[i] = _jax_slot(want[i], int(ids[i, slot]), u[i, slot].item())
    np.testing.assert_array_equal(got[..., 0].numpy(), want)
    plain, _ = aug.apply_plan(plan, torch.from_numpy(x)[..., None], ops=PLAIN)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("n,hw,want", [
    (24, 518 * 518, (8, 33544)), (3, 518 * 518, (16, 16772)), (32, 224 * 224, (8, 6272)),
    (4, 224 * 224, (8, 6272)), (3, 37 * 41, (1, 1520)), (3, 301 * 303, (16, 5704)),
    (1, 1024 * 1024, (16, 65536)), (1, 1, (1, 4))])
def test_equalize_grid_at_the_chip_shapes(n, hw, want):
    """One cluster an image: a power of two up to 16 CTAs, enough for ~192
    CTAs in all while a CTA keeps >= 4096 floats, and enough that none holds
    more than 36,864; slices a multiple of 4 floats that cover the image."""
    cluster, slice_ = lut._eq_grid(n, hw)
    assert (cluster, slice_) == want
    assert slice_ % 4 == 0 and cluster * slice_ >= hw > (cluster - 1) * slice_
