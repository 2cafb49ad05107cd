"""The port's DINOv2 slice against the JAX package, on the CPU.

(a) K7's plain version against the JAX ``flash_attention`` (Pallas,
interpret mode): ragged N, key bias, causal, both layouts, one N > 512
case and the CUDA kernels' tile edges (N = 1, 64, 65, 129), max|d| <=
2e-5, and the plain row log-sum-exp (``flash_attention_lse_plain``)
against the JAX ``_scores``' probabilities, <= 2e-5; (b) K10's plain version against the JAX ``fused_mlp``
(interpret mode), gelu and quick_gelu, <= 2e-5; (c) the layers the heads
use: conv_transpose2d, conv2d_cat, batchnorm (train, eval, running state),
the align-corners bilinear and the antialiased bicubic resizes and the
positional-embedding interpolation, <= 1e-5 (1e-4 * max|ref| for the
convolutions); (d) the tiny DINOv2 (the --debug_tiny shape: width 64, depth
5, 4 heads) with LayerScale O(1), ``get_intermediate_layers`` at 56, 70 and
322 px (N = 530 > 512 takes the other attention route) <= 1e-4 * max|ref|;
(e) three AdamW steps of the seg (UNet and linear) and cls bundles, augmentation off,
against the JAX step: loss 1e-4 relative, first-step head gradients 1e-4 *
max|g| (the biases of the convs ahead of a train-mode BatchNorm, whose
gradient is zero up to rounding, <= 1e-5 * the largest head gradient on
both sides), the BatchNorm state after three steps 1e-5; (f) the dino seg CLI
with its default augmentation writes a best_model.npz (head + bn) that the
JAX bundle loads, reads the JAX package's, resumes with its BatchNorm
statistics, and the dino predict CLI serves it; (g) the dino cls CLI with
its default augmentation writes a best_model.npz that the JAX cls bundle
loads.
"""

import glob
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import dinov2 as jdv
from nextgen_uia_tpu.nn import layers as jl
from nextgen_uia_tpu.ops.flash_attention import _scores as jax_fa_scores
from nextgen_uia_tpu.ops.flash_attention import flash_attention as jax_flash
from nextgen_uia_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from nextgen_uia_tpu.tasks import other_tasks as jot
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.models import dinov2 as dv
from nextgen_uia_tpu_torch.nn import layers as L
from nextgen_uia_tpu_torch.ops import flash_attention as fa
from nextgen_uia_tpu_torch.ops import fused_mlp as fm
from nextgen_uia_tpu_torch.tasks import other_tasks as ot
from synth_data import make_synth_root


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("layout,n,heads,bias,causal", [
    ("bhnd", 77, 3, True, False), ("bhnd", 50, 2, False, True), ("bnhd", 33, 2, True, True),
    ("bnhd", 130, 2, False, False), ("bhnd", 530, 1, True, False),
    # the CUDA kernels' tile edges (64-row boxes, 128-row tiles)
    ("bnhd", 1, 2, True, True), ("bhnd", 64, 2, True, True), ("bnhd", 65, 2, True, True),
    ("bhnd", 129, 2, True, True)])
def test_flash_attention_plain_matches_jax(layout, n, heads, bias, causal):
    """The forward against the JAX kernel, and the row log-sum-exp the kernel
    saves (its plain version) against the JAX ``_scores``: exp(s - lse)
    must give the JAX probabilities."""
    rng = np.random.default_rng(n)
    shape = (2, heads, n, 16) if layout == "bhnd" else (2, n, heads, 16)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    kb = rng.standard_normal((2, n)).astype(np.float32) if bias else None
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                bias=None if kb is None else jnp.asarray(kb), causal=causal,
                                layout=layout))
    tb = None if kb is None else _t(kb)
    got = fa.flash_attention(_t(q), _t(k), _t(v), bias=tb, causal=causal, layout=layout)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 2e-5

    lse = fa.flash_attention_lse_plain(_t(q), _t(k), bias=tb, causal=causal, layout=layout)
    assert tuple(lse.shape) == (2, heads, n)
    qh, kh = (np.moveaxis(a, 2, 1) if layout == "bnhd" else a for a in (q, k))  # [B, H, N, dh]
    probs = np.stack([np.asarray(jax_fa_scores(
        jnp.asarray(qh[i]), jnp.asarray(kh[i]), None if kb is None else jnp.asarray(kb[i]),
        scale=16 ** -0.5, n=n, causal=causal)) for i in range(2)])
    s = fa._scores(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (qh, kh)), tb, causal)
    assert np.abs(torch.exp(s - lse[..., None]).numpy() - probs).max() <= 2e-5


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_plain_matches_jax(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w1, w2 = (0.2 * rng.standard_normal(s).astype(np.float32) for s in ((32, 128), (128, 32)))
    b1, b2 = (rng.standard_normal(s).astype(np.float32) for s in (128, 32))
    want = np.asarray(jax_fused_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), act=act))
    got = fm.fused_mlp(*map(_t, (x, w1, b1, w2, b2)), act=act)
    assert np.abs(got.numpy() - want).max() <= 2e-5


def _conv(gen, kh, kw, cin, cout, rng):
    p = L.Conv(gen, kh, kw, cin, cout)
    with torch.no_grad():
        p.w.copy_(_t(0.3 * rng.standard_normal(tuple(p.w.shape)).astype(np.float32)))
        p.b.copy_(_t(rng.standard_normal(cout).astype(np.float32)))
    return p, {"w": jnp.asarray(p.w.numpy()), "b": jnp.asarray(p.b.numpy())}


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    sk = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)

    up, up_j = _conv(gen, 2, 2, 8, 3, rng)
    want = np.asarray(jl.conv_transpose2d(up_j, jnp.asarray(x), stride=2))
    got = L.conv_transpose2d(up, _t(x), stride=2).numpy()
    assert got.shape == want.shape == (2, 10, 12, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    cat, cat_j = _conv(gen, 3, 3, 12, 5, rng)
    want = np.asarray(jl.conv2d_cat(cat_j, jnp.asarray(x), jnp.asarray(sk)))
    got = L.conv2d_cat(cat, _t(x), _t(sk)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want = np.asarray(jl.conv2d(cat_j, jnp.asarray(np.concatenate([x, sk], -1))))
    got = L.conv2d(cat, _t(np.concatenate([x, sk], -1))).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    bn, st = L.BatchNorm(8), L.BatchNormState(8)
    with torch.no_grad():
        bn.scale.copy_(_t(1 + 0.2 * rng.standard_normal(8).astype(np.float32)))
        bn.bias.copy_(_t(0.2 * rng.standard_normal(8).astype(np.float32)))
    p_j = {"scale": jnp.asarray(bn.scale.numpy()), "bias": jnp.asarray(bn.bias.numpy())}
    st_j = {"mean": jnp.zeros(8), "var": jnp.ones(8)}
    for train in (True, True, False):
        want, st_j = jl.batchnorm(p_j, st_j, jnp.asarray(3 * x + 1), train=train)
        got = L.batchnorm(bn, st, _t(3 * x + 1), train=train)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
        for name in ("mean", "var"):
            assert np.abs(getattr(st, name).numpy() - np.asarray(st_j[name])).max() <= 1e-5

    small = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_align_corners(jnp.asarray(small), (9, 11)))
    got = L.resize_bilinear_align_corners(_t(small), (9, 11)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    for size, out in ((40, 35), (64, 56), (20, 35)):
        img = rng.standard_normal((1, size, size, 2)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(img), (1, out, out, 2), "bicubic"))
        got = L.resize_bicubic(_t(img), (out, out)).numpy()
        assert np.abs(got - want).max() <= 1e-5, size

    pos = rng.standard_normal((37 * 37 + 1, 8)).astype(np.float32)
    for g in (4, 5, 23, 37):
        want = np.asarray(jdv._interp_pos(jnp.asarray(pos), g, 8))
        got = dv.interp_pos(_t(pos), g, 8).numpy()
        assert np.abs(got - want).max() <= 1e-5, g


def _args(**kw):
    base = dict(dino_arch="vit_base", debug_tiny=True, backbone_ckpt=None, num_classes=2,
                decoder_type="unet", head_dtype="float32", compute_dtype="float32",
                img_size=56, patch_size=14, strong_augs=False, weak_augs=False)
    return types.SimpleNamespace(**{**base, **kw})


def _layerscale_o1(params, rng):
    for blk in params["blocks"]:
        for name in ("ls1", "ls2"):
            blk[name] = jnp.asarray(rng.uniform(0.5, 1.5, blk[name].shape), jnp.float32)
    return params


@pytest.mark.parametrize("size", [56, 70, 322])
def test_tiny_dinov2_intermediate_layers_match_jax(tmp_path, size):
    cfg_j = jot._build_dino(_args(), jax.random.key(0))[0]
    params_j = _layerscale_o1(jdv.dinov2_init(jax.random.key(1), cfg_j), np.random.default_rng(1))
    jax_ckpt.save(str(tmp_path / "enc.npz"), params_j)
    cfg, enc = ot._build_dino(_args(backbone_ckpt=str(tmp_path / "enc.npz")),
                              torch.Generator().manual_seed(0))
    assert cfg.width == 64 and cfg.depth == 5 and cfg.heads == 4
    imgs = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    want = jdv.get_intermediate_layers(params_j, jnp.asarray(imgs), 5, cfg_j)
    with torch.no_grad():
        got = dv.get_intermediate_layers(enc, _t(imgs), 5, cfg)
    assert len(got) == len(want) == 5
    for (gp, gc), (wp, wc) in zip(got, want):
        for g, w in ((gp, wp), (gc, wc)):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _disc_batch(n, size, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    imgs = rng.integers(0, 120, (n, size, size)).astype(np.int32)
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(size // 9, size // 4) ** 2
        masks[i][disc] = 1
        imgs[i][disc] += 100
    return imgs.clip(0, 255).astype(np.uint8), masks


@pytest.mark.parametrize("task,decoder", [("seg", "unet"), ("seg", "linear"), ("cls", None)])
def test_three_train_steps_match_jax(tmp_path, task, decoder):
    """The JAX dino bundle's step (run_supervised's loss_fn: dice_ce with the
    BatchNorm state as aux, or focal) against the port's TrainStep over the
    port's bundle, three AdamW updates, augmentation off."""
    args = _args(decoder_type=decoder)
    build_j = jot.build_dino_seg_bundle if task == "seg" else jot.build_dino_cls_bundle
    bundle_j = build_j(args, jax.random.key(2))
    params_j = dict(bundle_j.params)
    params_j["encoder"] = _layerscale_o1(params_j["encoder"], np.random.default_rng(2))
    jax_ckpt.save(str(tmp_path / "w.npz"), params_j)
    imgs, masks = _disc_batch(2, 56, seed=5)
    labels = np.array([0, 1], np.int64)
    batch = {"image": imgs, **({"mask": masks} if task == "seg" else {"label": labels})}
    mb_j = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_j(tp, frozen, mb, rng):
        logits, m, new_bn = bundle_j.forward_train(jax_merge(tp, frozen["params"]),
                                                   frozen["bn"], mb, rng)
        loss = (jax_losses.focal_loss(logits, mb["label"]) if task == "cls"
                else jax_losses.dice_ce_loss(logits, m))
        return loss, new_bn

    # lr 1e-5: Adam moves a bias whose gradient is rounding noise by ~lr per
    # update in a direction set by that noise, and the conv biases ahead of
    # a BatchNorm enter its running mean (0.1 of the shift per update)
    tcfg = dict(lr=1e-5, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    trainable_j, frozen_j = jax_partition(params_j, jax_by_keywords("head"))
    fz = {"params": frozen_j, "bn": bundle_j.bn_state}
    grads_j = dict(jax_flatten(jax.grad(loss_j, has_aux=True)(trainable_j, fz, mb_j,
                                                               jax.random.key(0))[0]))
    jcfg = jax_train.TrainConfig(**tcfg, grad_clip=0.0, accum_steps=1)
    opt_j, _ = jax_train.make_optimizer(jcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jcfg, donate=False, has_aux=True)
    state = jax_train.init_state(trainable_j, opt_j)
    losses_j = []
    for i in range(3):
        state, m = step_j(state, fz, {k: v[None] for k, v in mb_j.items()}, jax.random.key(i))
        fz = {"params": frozen_j, "bn": m["aux"]}
        losses_j.append(float(m["loss"]))

    build = ot.build_dino_seg_bundle if task == "seg" else ot.build_dino_cls_bundle
    bundle = build(args, torch.Generator().manual_seed(0))
    ckpt.load_into(str(tmp_path / "w.npz"), bundle.params)
    trainable, _ = partition(bundle.params, by_keywords("head"))
    assert set(trainable) == set(grads_j)

    def loss_t(mb, g):
        logits, m = bundle.forward_train(bundle.params, mb, g)
        return (losses.focal_loss(logits, mb["label"]) if task == "cls"
                else losses.dice_ce_loss(logits, m))

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tcfg)),
                       T.TrainConfig(**tcfg))
    mb_t = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    losses_t = [step(mb_t)["loss"]]
    # the first update's gradients; the bias of a conv ahead of a train-mode
    # BatchNorm has zero gradient up to rounding: both sides <= 1e-5 * max|g|
    g_scale = max(np.abs(np.asarray(g)).max() for g in grads_j.values())
    for path, prm in trainable.items():
        want, got = np.asarray(grads_j[path]), prm.grad.numpy()
        if "/up" in path and path.endswith(("/conv/b", "/skip_conv/b")):
            assert max(np.abs(want).max(), np.abs(got).max()) <= 1e-5 * g_scale, path
        else:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path
    losses_t += [step(mb_t)["loss"] for _ in range(2)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4, atol=0)
    assert losses_t[-1] != losses_t[0]
    if decoder == "unet":
        want = dict(jax_flatten(fz["bn"]))
        got = {f"{k.replace('.', '/')}": v for k, v in bundle.bn_state.state_dict().items()}
        assert set(got) == set(want) and len(want) == 16
        for k, w in want.items():
            assert np.abs(got[k].numpy() - np.asarray(w)).max() <= 1e-5, k


def test_dino_cli_trains_with_augmentation_and_serves(tmp_path, monkeypatch):
    from nextgen_uia_tpu_torch.tasks.dino import predict, segmentation

    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=56)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "BUSI", "--data_root", str(root), "--exp", "dseg", "--img_size", "56",
            "--batch_size", "4", "--debug_tiny", "--num_workers", "2", "--device", "cpu",
            "--compute_dtype", "float32", "--val_interval", "1"]
    stats = segmentation.main(argv + ["--epochs", "1"])
    assert np.isfinite(stats["loss"]) and "dice_mean" in stats
    run = tmp_path / "runs" / "dseg" / "BUSI" / "train"
    best = run / "best_model.npz"
    keys = ckpt.peek_keys(str(best))
    assert any(k.startswith("bn/up0/conv_bn/") for k in keys)
    assert all(k.startswith(("params/head/", "bn/")) for k in keys)

    # the JAX package's dino seg bundle loads the port's file ...
    bundle_j = jot.build_dino_seg_bundle(_args(), jax.random.key(4))
    trainable_j, _ = jax_partition(bundle_j.params, jax_by_keywords("head"))
    loaded, n = jax_ckpt.load_into(str(best), {"params": trainable_j, "bn": bundle_j.bn_state})
    assert n == len(keys)
    saved = ckpt.load_flat(str(best))
    for path, arr in jax_flatten(loaded):
        np.testing.assert_array_equal(np.asarray(arr), saved[path])
    # ... and the port's bundle loads the JAX package's
    jax_ckpt.save(str(tmp_path / "jax_best.npz"), loaded)
    bundle = ot.build_dino_seg_bundle(_args(), torch.Generator().manual_seed(9))
    _, n = ckpt.load_into(str(tmp_path / "jax_best.npz"),
                          torch.nn.ModuleDict({"params": bundle.params, "bn": bundle.bn_state}))
    assert n == len(keys)

    # --resume restores the BatchNorm statistics with the train state
    flat, meta = ckpt.load_train_state(str(run / "last_state.npz"))
    assert meta["epoch"] == 1 and "bn/up3/skip_bn/var" in flat
    segmentation.main(argv + ["--epochs", "2", "--resume"])
    _, meta2 = ckpt.load_train_state(str(run / "last_state.npz"))
    assert meta2["epoch"] == 2 and meta2["applied_updates"] == 2 * meta["applied_updates"]

    out = predict.main(["--task", "seg", "--images", str(root / "all" / "images"),
                        "--img_size", "56", "--debug_tiny", "--batch_size", "4",
                        "--device", "cpu", "--compute_dtype", "float32", "--num_workers", "1",
                        "--head_weights", str(best), "--out", str(tmp_path / "served")])["out"]
    rows = open(f"{out}/index.csv").read().strip().splitlines()[1:]
    assert len(rows) == 12 and all(",ok," in r for r in rows)
    assert len(glob.glob(f"{out}/*_mask.png")) == 12


def test_dino_cls_cli_trains_with_default_augmentation(tmp_path, monkeypatch):
    """The dino classification CLI at its default --strong_augs --weak_augs
    on the CPU: finite stats, and a best_model.npz (head only, no BN state)
    that the JAX package's dino cls bundle loads."""
    from nextgen_uia_tpu_torch.tasks.dino import classification

    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=56)
    monkeypatch.chdir(tmp_path)
    stats = classification.main([
        "--dataset", "BUSI", "--data_root", str(root), "--exp", "dcls", "--img_size", "56",
        "--batch_size", "4", "--debug_tiny", "--num_workers", "2", "--device", "cpu",
        "--compute_dtype", "float32", "--val_interval", "1", "--epochs", "1"])
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["acc"])
    best = tmp_path / "runs" / "dcls" / "BUSI" / "train" / "best_model.npz"
    keys = ckpt.peek_keys(str(best))
    assert keys and all(k.startswith("params/head/") for k in keys)
    bundle_j = jot.build_dino_cls_bundle(_args(), jax.random.key(5))
    trainable_j, _ = jax_partition(bundle_j.params, jax_by_keywords("head"))
    _, n = jax_ckpt.load_into(str(best), {"params": trainable_j})
    assert n == len(keys)
