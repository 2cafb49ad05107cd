"""CLIPSeg in the port against the JAX package, on the CPU.

(a) The FiLM decoder in eval, float32: ``clipseg_decoder_apply`` against
JAX's within 2e-5 * max|ref|, from one seeded HF-layout state dict put
through both packages' ``clipseg_decoder`` converters (the two .npz files
equal) into both decoders, and the port's parameter names equal to JAX's
both ways over the .npz bridge. (b) Three AdamW updates of the tiny
CLIPSeg bundle (``--debug_tiny`` OpenAI towers at 32 px, float32,
augmentation off) against JAX's ``build_clipseg_bundle`` under
run_supervised's DiceCE: losses within 1e-4 relative, first-step decoder
gradients within 1e-4 * max|g| (the key bias's, zero up to rounding, both
within 1e-5 of the largest), the towers frozen. (c) ``--decoder_ckpt``
takes both roots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.convert import torch_to_jax as jax_convert
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import heads as jax_heads
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu.tasks import other_tasks as jax_ot
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.convert import torch_to_npz
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.models import heads
from nextgen_uia_tpu_torch.tasks import common, other_tasks

HIDDEN, RD, COND, INTER, K = 96, 64, 64, 128, 4


def _hf_decoder(seed, inter=INTER):
    """A seeded HF CLIPSegForImageSegmentation decoder state dict ('decoder.'
    prefix), torch's layouts: Linear [out, in], Conv2d OIHW, ConvTranspose2d
    [in, out, kh, kw]."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    sd = {}

    def lin(name, out, inp):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = arr(out, inp, scale=inp ** -0.5), arr(out)

    lin("film_mul", RD, COND)
    lin("film_add", RD, COND)
    for i in range(3):
        lin(f"reduces.{i}", RD, HIDDEN)
        b = f"layers.{i}."
        for t in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(b + "self_attn." + t, RD, RD)
        lin(b + "mlp.fc1", inter, RD)
        lin(b + "mlp.fc2", RD, inter)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}{ln}.weight"], sd[f"{b}{ln}.bias"] = 1 + arr(RD), arr(RD)
    sd["transposed_convolution.0.weight"] = arr(RD, RD, 3, 3, scale=(9 * RD) ** -0.5)
    sd["transposed_convolution.0.bias"] = arr(RD)
    sd["transposed_convolution.2.weight"] = arr(RD, RD // 2, K, K, scale=RD ** -0.5)
    sd["transposed_convolution.2.bias"] = arr(RD // 2)
    sd["transposed_convolution.4.weight"] = arr(RD // 2, 1, K, K, scale=(RD // 2) ** -0.5)
    sd["transposed_convolution.4.bias"] = arr(1)
    return {f"decoder.{k}": v for k, v in sd.items()}


def test_film_decoder_matches_jax(tmp_path):
    sd = _hf_decoder(0)
    flat_t, flat_j = torch_to_npz.convert_clipseg_decoder(sd), jax_convert.convert_clipseg_decoder(sd)
    assert sorted(flat_t) == sorted(flat_j)
    for key in flat_t:
        np.testing.assert_array_equal(flat_t[key], flat_j[key])
    np.savez(tmp_path / "port.npz", **flat_t)
    np.savez(tmp_path / "jax.npz", **flat_j)

    jcfg = jax_heads.ClipSegDecoderConfig(hidden_size=HIDDEN, reduce_dim=RD, cond_dim=COND,
                                          intermediate=INTER, extract_layers=(1, 2, 3))
    jp, n_j = jax_ckpt.load_into(str(tmp_path / "jax.npz"), jax.eval_shape(
        lambda: jax_heads.clipseg_decoder_init(jax.random.key(0), jcfg)))
    cfg = heads.ClipSegDecoderConfig(hidden_size=HIDDEN, reduce_dim=RD, cond_dim=COND,
                                     intermediate=INTER, extract_layers=(1, 2, 3))
    dec = heads.clipseg_decoder_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.load_into(str(tmp_path / "port.npz"), dec)
    assert n == n_j == len(dec.state_dict()) == len(flat_t) == 3 * 16 + 16
    assert {k.replace(".", "/") for k in dec.state_dict()} == set(flat_t)

    rng = np.random.default_rng(1)
    acts = [rng.standard_normal((2, 17, HIDDEN)).astype(np.float32) for _ in range(3)]
    cond = rng.standard_normal((2, COND)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a, c: jax_heads.clipseg_decoder_apply(p, jcfg, a, c))(
        jp, [jnp.asarray(a) for a in acts], jnp.asarray(cond)))
    with torch.no_grad():
        got = heads.clipseg_decoder_apply(dec, cfg, [torch.from_numpy(a) for a in acts],
                                          torch.from_numpy(cond))
    assert got.shape == want.shape == (2, 64, 64) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()

    # bf16 taps meet the float32 decoder in float32, as jnp promotes them
    with torch.no_grad():
        half = heads.clipseg_decoder_apply(dec, cfg, [torch.from_numpy(a).bfloat16() for a in acts],
                                           torch.from_numpy(cond).bfloat16())
    assert half.dtype == torch.float32

    # the port writes what the JAX package loads
    with torch.no_grad():
        for t in dec.parameters():
            t.mul_(1.5)
    ckpt.save(str(tmp_path / "back.npz"), dec)
    back, n_back = jax_ckpt.load_into(str(tmp_path / "back.npz"), jp)
    assert n_back == n
    state = dec.state_dict()
    for path, a in jax_flatten(back):
        np.testing.assert_array_equal(np.asarray(a), state[path.replace("/", ".")].numpy())


ARGV = ["--debug_tiny", "--img_size", "32", "--compute_dtype", "float32", "--no-strong_augs",
        "--no-weak_augs", "--dataset", "BUSI"]


def _args(package, *extra):
    common_, ot = (jax_common, jax_ot) if package == "jax" else (common, other_tasks)
    p = common_.base_parser("clipseg_segmentation")
    ot.add_clipseg_flags(p)
    return p.parse_args(ARGV + list(extra))


def _batch(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:32, :32]
    imgs = rng.integers(0, 140, (2, 32, 32)).astype(np.int32)
    masks = np.zeros((2, 32, 32), np.uint8)
    for i in range(2):
        cy, cx = rng.integers(8, 24, 2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(4, 9) ** 2
        masks[i][disc] = 1
        imgs[i][disc] += 100
    return {"image": imgs.clip(0, 255).astype(np.uint8), "mask": masks}


def test_three_clipseg_steps_match_jax(tmp_path, monkeypatch):
    bundle = other_tasks.build_clipseg_bundle(_args("port"), torch.Generator().manual_seed(0))
    path = str(tmp_path / "w.npz")
    assert ckpt.save(path, bundle.params) == len(bundle.params.state_dict())

    # JAX's bundle with the port's weights: its inits traced for their
    # shapes only, then every tensor loaded from the port's file
    def loaded(root, init):
        shapes = jax.eval_shape(init)
        tree, n = jax_ckpt.load_into(path, {root: shapes})
        assert n == len(jax_flatten(shapes))
        return tree[root]

    real_build = jax_ot.build_clip_model

    def build_clip_model(args, family, rng):
        cfgs = []
        params = loaded("backbone", lambda: cfgs.append(real_build(args, family, rng=rng))
                        or cfgs[0][1])
        return cfgs[0][0], params

    monkeypatch.setattr(jax_ot, "build_clip_model", build_clip_model)
    monkeypatch.setattr(jax_ot, "clipseg_decoder_init", lambda rng, dcfg: loaded(
        "head", lambda: jax_heads.clipseg_decoder_init(rng, dcfg)))
    bundle_j = jax_ot.build_clipseg_bundle(_args("jax"), jax.random.key(3))
    batch = _batch(4)
    mb_j = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_j(tp, frozen, mb, rng):
        logits, m, _ = bundle_j.forward_train(jax_merge(tp, frozen), None, mb, rng)
        return jax_losses.dice_ce_loss(logits, m)

    tcfg = dict(lr=1e-4, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    trainable_j, frozen_j = jax_partition(bundle_j.params, jax_by_keywords("head"))
    # the JAX step's update (make_train_step at grad_clip 0, one microbatch):
    # the loss's gradients, then make_optimizer's AdamW
    opt_j, _ = jax_train.make_optimizer(jax_train.TrainConfig(**tcfg))

    @jax.jit
    def step_j(tp, opt_state, key):
        loss, grads = jax.value_and_grad(loss_j)(tp, frozen_j, mb_j, key)
        updates, opt_state = opt_j.update(grads, opt_state, tp)
        return optax.apply_updates(tp, updates), opt_state, loss, grads

    tp, opt_state, losses_j, grads_j = trainable_j, opt_j.init(trainable_j), [], None
    for i in range(3):
        tp, opt_state, loss, grads = step_j(tp, opt_state, jax.random.key(i))
        losses_j.append(float(loss))
        grads_j = grads_j or dict(jax_flatten(grads))

    trainable, _ = partition(bundle.params, by_keywords("head"))
    assert set(trainable) == set(grads_j) and len(trainable) == 3 * 16 + 16

    def loss_t(mb, g):
        logits, m = bundle.forward_train(bundle.params, mb, g)
        assert logits.shape == (2, 2, 32, 32) and torch.equal(logits[:, 0], -logits[:, 1])
        return losses.dice_ce_loss(logits, m)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tcfg)),
                       T.TrainConfig(**tcfg))
    mb_t = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    losses_t = [step(mb_t)["loss"]]
    # the key projection's bias shifts every score of a row alike, which the
    # softmax cancels: its gradient is zero up to rounding on both sides
    g_scale = max(np.abs(np.asarray(g)).max() for g in grads_j.values())
    for name, prm in trainable.items():
        want, got = np.asarray(grads_j[name]), prm.grad.numpy()
        if name.endswith("/attn/k/b"):
            assert max(np.abs(want).max(), np.abs(got).max()) <= 1e-5 * g_scale, name
        else:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    # the towers are frozen and outside autograd
    assert all(p.grad is None for p in bundle.params["backbone"].parameters())
    losses_t += [step(mb_t)["loss"] for _ in range(2)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4, atol=0)
    assert losses_t[-1] != losses_t[0]


@pytest.mark.parametrize("rooted", [False, True])
def test_decoder_ckpt_takes_both_roots(tmp_path, rooted):
    """The converter's decoder-rooted file and a trainer's best_model.npz
    (params/head/...) both load into the bundle's decoder."""
    flat = torch_to_npz.convert_clipseg_decoder(_hf_decoder(2, inter=2048))
    flat = {(f"params/head/{k}" if rooted else k): v for k, v in flat.items()}
    np.savez(tmp_path / "dec.npz", **flat)
    bundle = other_tasks.build_clipseg_bundle(
        _args("port", "--decoder_ckpt", str(tmp_path / "dec.npz")), torch.Generator())
    got = bundle.params["head"].film_mul.w.detach().numpy()
    np.testing.assert_array_equal(got, flat[("params/head/" if rooted else "") + "film_mul/w"])
