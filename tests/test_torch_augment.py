"""The port's on-device augmentation against the JAX package, on the CPU.

(a) K13's plain lookup and histogram against the JAX Pallas ``lut_apply``
(interpret mode), ``lut_apply_xla`` and ``hist256_fact`` on every byte
value, bit for bit; (b) each strong op at fixed magnitudes against the JAX
private op: the integer-valued ops (autocontrast after the uint8 round trip,
equalize, posterize, solarize) exactly, blur/contrast/brightness/sharpness
within 1e-5 before the round trip; (c) the resized crop at fixed (side, i, j)
and the crop's parameters from the same unit draws, exactly in side and
offsets, 1e-5 in values; (d) the whole ``augment_batch`` for three keys with
the plan rebuilt from jax.random's draws: masks identical on >= 99.9% of the
pixels, images max|d| <= 2/255 and mean|d| <= 1e-3 (an op's float result can
land on the other side of a uint8 rounding boundary); (e) the sampler's laws
against the JAX sampler's over 4000 images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.data import augment as jaug
from nextgen_uia_tpu.ops import lut as jlut
from nextgen_uia_tpu_torch.data import augment as aug
from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN, lut


def _bytes_image(rng):
    """Every byte value, values between grid points and a few outside [0, 1]."""
    v = np.concatenate([np.arange(256) / 255.0, rng.random(740), [-0.2, 1.3, 0.5 / 255]])
    return v.astype(np.float32)


def test_lut_apply_and_hist256_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    img = _bytes_image(rng)
    tables = rng.integers(0, 256, (2, 256)).astype(np.int32)
    for b in range(2):
        want = np.asarray(jlut.lut_apply(jnp.asarray(img), jnp.asarray(tables[b])))
        np.testing.assert_array_equal(want, np.asarray(
            jlut.lut_apply_xla(jnp.asarray(img), jnp.asarray(tables[b]))))
        imgs = torch.from_numpy(np.stack([img, img[::-1].copy()]))
        got = lut.lut_apply(imgs, torch.from_numpy(tables[[b, b]]))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), want)
        np.testing.assert_array_equal(got[1].numpy(), want[::-1])
    hist = lut.hist256(torch.from_numpy(img.reshape(1, 37, 27)))
    assert hist.dtype == torch.int32 and hist.shape == (1, 256)
    np.testing.assert_array_equal(hist[0].numpy(), np.asarray(jlut.hist256_fact(jnp.asarray(img))))
    assert int(hist.sum()) == img.size


def _grid_batch(rng, n, h, w):
    return (rng.integers(0, 256, (n, h, w)) / 255.0).astype(np.float32)


JAX_OPS = {
    1: lambda x, u: jaug._autocontrast(x),
    2: lambda x, u: jaug._equalize(x),
    3: lambda x, u: jaug._gaussian_blur(x, jnp.maximum(0.75, u * 0.5 + 0.75)),
    4: lambda x, u: jaug._contrast(x, 1.25 - 0.5 * u),
    5: lambda x, u: jaug._brightness(x, 1.25 - 0.5 * u),
    6: lambda x, u: jaug._sharpness(x, 1.25 - 0.5 * u),
    7: lambda x, u: jaug._posterize(x, 8 - jnp.maximum(1, jnp.ceil(4.0 * u).astype(jnp.int32))),
    8: lambda x, u: jaug._solarize(x, 256 - jnp.maximum(1, jnp.ceil(255.0 * u)
                                                       .astype(jnp.int32))),
}


@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_strong_ops_match_jax(op):
    """Port op (unit draw u) against the JAX op at the magnitude its JAX
    expression gives u; integer-valued ops compared after the uint8 round
    trip (exact), the float ones before it (<= 1e-5)."""
    rng = np.random.default_rng(op)
    x = _grid_batch(rng, 4, 20, 23)
    x[1] = np.clip(x[1] * 0.3 + 0.2, 0, 1).round(2)  # low contrast, repeated values
    x = (np.round(x * 255) / 255).astype(np.float32)
    u = np.array([0.0, 0.31, 0.77, 0.999], np.float32)
    got = aug.STRONG_OPS[op](torch.from_numpy(x), torch.from_numpy(u), PLAIN).numpy()
    want = np.stack([np.asarray(JAX_OPS[op](jnp.asarray(x[i])[..., None], jnp.float32(u[i])))[
        ..., 0] for i in range(4)])
    if op in (3, 4, 5, 6):
        assert np.abs(got - want).max() <= 1e-5
    else:
        np.testing.assert_array_equal(np.asarray(aug.quantize_u8(torch.from_numpy(got))),
                                      np.asarray(jaug._quantize_u8(jnp.asarray(want))))


def _jax_crop(key, h):
    k_s, k_i, k_j = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(k_s, (10,))),
            np.array([jax.random.uniform(k_i), jax.random.uniform(k_j)], np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_resized_crop_and_flips_match_jax(seed):
    rng = np.random.default_rng(seed)
    h = 32
    img = _grid_batch(rng, 1, h, h)[0]
    key = jax.random.key(seed)
    side_j, i_j, j_j = (float(t) for t in jaug._crop_params(key, h))
    u_s, u_ij = _jax_crop(key, h)
    side, i, j = aug.crop_params(torch.tensor(u_s[None]), torch.tensor(u_ij[None]), h)
    assert (float(side), float(i), float(j)) == (side_j, i_j, j_j)
    for s, ii, jj in ((side_j, i_j, j_j), (26.0, 3.0, 5.0), (32.0, 0.0, 0.0), (29.0, 3.0, 0.0)):
        want = np.asarray(jax.image.scale_and_translate(
            jnp.asarray(img)[..., None], (h, h, 1), (0, 1), jnp.array([h / s, h / s]),
            jnp.array([-ii * h / s, -jj * h / s]), method="bilinear"))[..., 0]
        got = aug.resized_crop(torch.from_numpy(img)[None], torch.tensor([s]),
                               torch.tensor([ii]), torch.tensor([jj]), h)[0].numpy()
        assert np.abs(got - want).max() <= 1e-5
    x = torch.from_numpy(img)[None, ..., None]
    plan = aug.Plan(weak_ids=torch.tensor([[1, 2, 3, 3]]), crop_s=torch.zeros(1, 4, 10),
                    crop_ij=torch.zeros(1, 4, 2))
    got, _ = aug.apply_plan(plan, x, out_size=h)
    np.testing.assert_array_equal(got[0, ..., 0].numpy(), img[::-1, ::-1])


def jax_plan(key, b):
    """The plan jax.random draws inside augment_batch(key, ...) with strong
    and weak on, as the port's Plan."""
    k_gate, k_strong, k_weak = jax.random.split(key, 3)
    sids, su, wids, cs, cij = [], [], [], [], []
    for sk, wk in zip(jax.random.split(k_strong, b), jax.random.split(k_weak, b)):
        k_seq, k_slots = jax.random.split(sk)
        sids.append(np.asarray(jaug._op_sequence(k_seq, 9, 0)))
        su.append(np.asarray(jax.vmap(jax.random.uniform)(jax.random.split(k_slots, 9))))
        k_seq, k_slots = jax.random.split(wk)
        wids.append(np.asarray(jaug._op_sequence(k_seq, 4, 3)))
        draws = [_jax_crop(kk, 0) for kk in jax.random.split(k_slots, 4)]
        cs.append(np.stack([d[0] for d in draws]))
        cij.append(np.stack([d[1] for d in draws]))
    gate = np.asarray(jax.random.bernoulli(k_gate, 0.5, (b, 1, 1, 1))).reshape(b)
    t = torch.from_numpy
    return aug.Plan(strong_ids=t(np.stack(sids)).long(), strong_u=t(np.stack(su)),
                    weak_ids=t(np.stack(wids)).long(), crop_s=t(np.stack(cs)),
                    crop_ij=t(np.stack(cij)), gate=t(gate.copy()))


def _disc_masks(rng, n, size):
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n, size, size), np.float32)
    for i in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(3, size // 3) ** 2] = 1
    return masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_matches_jax_with_its_draws(seed):
    rng = np.random.default_rng(seed)
    imgs = _grid_batch(rng, 4, 32, 32)[..., None]
    masks = _disc_masks(rng, 4, 32)[..., None]
    key = jax.random.key(seed)
    want_x, want_m = (np.asarray(t) for t in jaug.augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(masks), strong=True, weak=True, out_size=32))
    plan = jax_plan(key, 4)
    assert (plan.strong_ids != 0).any() and (plan.weak_ids != 3).any()
    for ops in (PLAIN, KERNELS):  # on the CPU both run the plain lookup
        got_x, got_m = (t.numpy() for t in aug.apply_plan(
            plan, torch.from_numpy(imgs), torch.from_numpy(masks), out_size=32, ops=ops))
        assert got_x.shape == want_x.shape and got_m.shape == want_m.shape
        assert (got_m == want_m).mean() >= 0.999
        d = np.abs(got_x - want_x)
        assert d.max() <= 2 / 255 + 1e-6 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_sampler_laws_match_jax():
    """4000 images: the count of non-identity strong and weak ops, the op
    ids, the gate rate and the crop side follow the JAX sampler's laws
    (total-variation distance <= 0.06 per law, rates within 0.03)."""
    b, h = 4000, 64
    plan = aug.sample_plan(torch.Generator().manual_seed(0), b)
    k_gate, k_strong, k_weak = jax.random.split(jax.random.key(0), 3)

    def seqs(key, n, ident):
        ks = jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(key, b))
        return np.asarray(jax.vmap(lambda k: jaug._op_sequence(k, n, ident))(ks))

    def tv(a, c, bins):
        pa = np.bincount(a, minlength=bins) / len(a)
        pc = np.bincount(c, minlength=bins) / len(c)
        return 0.5 * np.abs(pa - pc).sum()

    for ids, want, n, ident in ((plan.strong_ids.numpy(), seqs(k_strong, 9, 0), 9, 0),
                                (plan.weak_ids.numpy(), seqs(k_weak, 4, 3), 4, 3)):
        assert tv((ids != ident).sum(1), (want != ident).sum(1), n + 1) <= 0.06
        assert tv(ids.ravel(), want.ravel(), n) <= 0.06
    gate_j = np.asarray(jax.random.bernoulli(k_gate, 0.5, (b,)))
    assert abs(plan.gate.float().mean().item() - gate_j.mean()) <= 0.03
    side, _, _ = aug.crop_params(plan.crop_s[:, 0], plan.crop_ij[:, 0], h)
    side_j = np.asarray(jax.vmap(lambda k: jaug._crop_params(k, h)[0])(
        jax.random.split(jax.random.key(1), b)))
    assert tv(side.long().numpy() - 50, side_j.astype(np.int64) - 50, 15) <= 0.06


def test_augment_batch_keeps_shapes_and_gates():
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_grid_batch(rng, 6, 24, 24)[..., None])
    m = torch.from_numpy(_disc_masks(rng, 6, 24)[..., None])
    out_x, out_m = aug.augment_batch(gen, x, m, out_size=24)
    assert out_x.shape == x.shape and out_m.shape == m.shape
    assert set(np.unique(out_m.numpy())) <= {0.0, 1.0}
    assert out_x.min() >= 0 and out_x.max() <= 1
    only_strong, none_m = aug.augment_batch(gen, x, None, weak=False)
    assert none_m is None and only_strong.shape == x.shape
    with pytest.raises(ValueError, match="out_size"):
        aug.augment_batch(gen, x, m, strong=False, out_size=32)
