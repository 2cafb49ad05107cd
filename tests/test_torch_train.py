"""The port's supervised training slice against the JAX package, on the CPU.

(a) MONA in train mode with the dropout mask JAX draws, values and every
adapter gradient; (b) three AdamW steps of a shrunk BiomedCLIP (width 128,
depth 4, 2 heads, 64 px, hybrid MONA, seg and cls heads) under
run_supervised's TrainConfig, dropout neutralised on both sides: losses per
step within 1e-4 relative, first-step gradients of every trainable tensor
within 1e-4 * max|g|; (c) the cosine schedule and the AdamW update against
optax, a non-finite loss skipping the update; (d) the losses, the
host-side data order, the metrics and results.csv against the JAX package's.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.experiment import save_results_csv as jax_save_results_csv
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.data import pipeline as jax_pipeline
from nextgen_uia_tpu.metrics.segmentation import SegAccumulator as JaxSegAccumulator
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models import heads as jax_heads
from nextgen_uia_tpu.nn.layers import dropout_mask as jax_dropout_mask
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.adapters.mona import Mona, inject_mona, mona_apply
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.experiment import save_results_csv
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.data import pipeline
from nextgen_uia_tpu_torch.metrics.segmentation import SegAccumulator
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
from nextgen_uia_tpu_torch.tasks import clip_tasks

DIM = 128


def test_mona_train_mode_matches_jax_with_its_dropout_mask(tmp_path):
    """mona_apply(rng=key) in JAX against the port handed the mask JAX's
    dropout_mask(key, 0.1, [B, N, 64]) draws: output max|d| <= 1e-5, every
    adapter gradient (and dx) max|d| <= 1e-4 * max|ref|."""
    key = jax.random.key(11)
    p = jax_mona.mona_init(jax.random.key(3), DIM, 64, "hybrid")
    rng = np.random.default_rng(3)
    p["gamma"] = jnp.asarray(0.5 * rng.standard_normal(DIM), jnp.float32)
    p["freq_filter"] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(64), jnp.float32)
    jax_ckpt.save(str(tmp_path / "mona.npz"), p)
    m = Mona(torch.Generator().manual_seed(0), DIM, 64, "hybrid")
    ckpt.load_into(str(tmp_path / "mona.npz"), m)
    x = rng.standard_normal((2, 26, DIM)).astype(np.float32)
    cot = rng.standard_normal((2, 26, DIM)).astype(np.float32)

    def f(params, xx):
        return jax_mona.mona_apply(params, xx, (5, 5), variant="hybrid", rng=key)

    out_j, vjp = jax.vjp(jax.jit(f), p, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(cot))
    mask = np.asarray(jax_dropout_mask(key, 0.1, (2, 26, 64)))
    assert 0 < (mask == 0).mean() < 0.3

    trainable, _ = partition(m, lambda path: True)
    xt = torch.from_numpy(x).requires_grad_()
    out_t = mona_apply(m, xt, (5, 5), variant="hybrid", mask=torch.from_numpy(mask.copy()))
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    want = dict(jax_flatten(gp_j))
    assert set(want) == set(trainable)
    for path, prm in trainable.items():
        w = np.asarray(want[path])
        assert np.abs(prm.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-12, path
    assert np.abs(xt.grad.numpy() - np.asarray(gx_j)).max() <= 1e-4 * np.abs(gx_j).max()


def _shrink(vision):
    return dataclasses.replace(vision, image_size=64, width=DIM, depth=4, heads=2, proj_dim=64)


def _small_text(text):
    """The frozen text tower, which the supervised step never runs, at a
    small size on both sides."""
    return dataclasses.replace(text, width=64, depth=1, heads=2, intermediate=128,
                               embed_dim=64)


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


@pytest.mark.parametrize("task", ["seg", "cls"])
def test_three_train_steps_match_jax(tmp_path, monkeypatch, task):
    """The JAX train step (_make_forward(train=True), dice_ce/focal,
    T.make_train_step) against the port's (TrainStep over the same forward
    and loss) for three AdamW updates with run_supervised's settings."""
    monkeypatch.setattr(jax_mona, "dropout", lambda rng, x, rate: x)
    monkeypatch.setattr(jax_heads, "dropout", lambda rng, x, rate: x)
    jcfg = jax_clip.clip_config("biomedclip", mona_variant="hybrid")
    jcfg = jcfg.replace(vision=_shrink(jcfg.vision), text=_small_text(jcfg.text))
    key = jax.random.key(5)
    backbone = jax_clip.clip_init(jax.random.fold_in(key, 1), jcfg)
    backbone["visual"], _ = jax_mona.inject_mona(jax.random.fold_in(key, 2), backbone["visual"],
                                                 dim=DIM, variant="hybrid")
    jh = jax_heads.PyramidHeadConfig(feature_dim=DIM, img_size=64, task=task)
    params = {"backbone": backbone, "head": jax_heads.pyramid_head_init(
        jax.random.fold_in(key, 3), jh)}
    jax_ckpt.save(str(tmp_path / "w.npz"), params)

    imgs, masks = _disc_batch(2, 64, seed=7)
    labels = np.array([0, 1], np.int64)
    args = types.SimpleNamespace(strong_augs=False, weak_augs=False, img_size=64)
    fwd_j = jax_tasks._make_forward(jcfg, jh, args, train=True)

    def loss_j(tp, frozen, mb, rng):
        logits, m = fwd_j(jax_merge(tp, frozen), mb["image"], mb.get("mask"), rng)
        if task == "cls":
            return jax_losses.focal_loss(logits, mb["label"])
        return jax_losses.dice_ce_loss(logits, jnp.moveaxis(m, -1, 1).astype(jnp.int32))

    tcfg = dict(lr=1e-4, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    trainable_j, frozen_j = jax_partition(params, jax_by_keywords("head", "mona", "lora"))
    batch = {"image": imgs, **({"mask": masks} if task == "seg" else {"label": labels})}
    mb_j = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_j = dict(jax_flatten(jax.jit(jax.grad(loss_j))(trainable_j, frozen_j, mb_j,
                                                         jax.random.key(0))))
    jcfg_t = jax_train.TrainConfig(**tcfg, grad_clip=0.0, accum_steps=1)
    opt_j, _ = jax_train.make_optimizer(jcfg_t)
    step_j = jax_train.make_train_step(loss_j, opt_j, jcfg_t, donate=False)
    state = jax_train.init_state(trainable_j, opt_j)
    losses_j = []
    for i in range(3):
        state, metrics = step_j(state, frozen_j, {k: v[None] for k, v in mb_j.items()},
                                jax.random.key(i))
        losses_j.append(float(metrics["loss"]))

    gen = torch.Generator().manual_seed(1)
    cfg = clip_mod.clip_config("biomedclip", mona_variant="hybrid")
    cfg = cfg.replace(vision=_shrink(cfg.vision), text=_small_text(cfg.text))
    port_backbone = clip_mod.clip_init(gen, cfg)
    inject_mona(gen, port_backbone.visual, dim=DIM, variant="hybrid")
    hcfg = PyramidHeadConfig(feature_dim=DIM, img_size=64, task=task)
    model = torch.nn.ModuleDict({"backbone": port_backbone,
                                 "head": pyramid_head_init(gen, hcfg)})
    ckpt.load_into(str(tmp_path / "w.npz"), model)
    trainable, _ = partition(model, by_keywords("head", "mona", "lora"))
    assert set(trainable) == set(grads_j)
    fwd = clip_tasks.make_forward(cfg, hcfg, train=True)

    def loss_t(mb, g):
        logits, m = fwd(model, mb["image"], mb.get("mask"), g)
        return (losses.focal_loss(logits, mb["label"]) if task == "cls"
                else losses.dice_ce_loss(logits, m))

    mb_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t(mb_t, None).backward()
    for path, prm in trainable.items():
        want = np.asarray(grads_j[path])
        got = np.zeros_like(want) if prm.grad is None else prm.grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-10, path
    opt = T.make_optimizer(trainable.values(), T.TrainConfig(**tcfg))
    step = T.TrainStep(loss_t, opt, T.TrainConfig(**tcfg))
    losses_t = [step({k: v[None] for k, v in mb_t.items()})["loss"] for _ in range(3)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4, atol=0)
    assert losses_t[-1] != losses_t[0]


def test_cosine_schedule_and_adamw_match_optax_with_a_skipped_update():
    cfg = T.TrainConfig(lr=3e-3, lr_min=1e-5, weight_decay=0.05, beta1=0.8, beta2=0.95,
                        total_updates=7)
    jcfg = jax_train.TrainConfig(**dataclasses.asdict(cfg), grad_clip=0.0, accum_steps=1)
    _, sched = jax_train.make_optimizer(jcfg)
    for k in range(-1, 9):
        assert math.isclose(T.cosine_lr_value(cfg, k), jax_train.cosine_lr_value(jcfg, k),
                            rel_tol=1e-12)
        if 0 <= k <= 7:
            assert math.isclose(T.cosine_lr_value(cfg, k), float(sched(k)), rel_tol=1e-6)

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    xs = [rng.standard_normal((1, 3, 4)).astype(np.float32) for _ in range(5)]
    xs[2][0, 0, 0] = np.nan  # the third update's loss is not finite: skipped

    def loss_j(tp, frozen, mb, rng_):
        return jnp.sum(mb["x"] * tp["w"] ** 2) + jnp.sum(jnp.sin(tp["w"]))

    opt_j, _ = jax_train.make_optimizer(jcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jcfg, donate=False)
    state = jax_train.init_state({"w": jnp.asarray(w0)}, opt_j)

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    step = T.TrainStep(lambda mb, g: (mb["x"] * w ** 2).sum() + torch.sin(w).sum(),
                       T.make_optimizer([w], cfg), cfg)
    for i, x in enumerate(xs):
        state, m_j = step_j(state, None, {"x": jnp.asarray(x)}, jax.random.key(0))
        before = w.detach().clone()
        m_t = step({"x": torch.from_numpy(x)})
        assert m_t["skipped"] == int(m_j["skipped"]) == (1 if i == 2 else 0)
        if i == 2:
            assert torch.equal(w.detach(), before)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(state["params"]["w"]),
                                   rtol=1e-5, atol=1e-6)
    assert step.applied == 4


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 2, 8, 8)).astype(np.float32) * 3
    labels = rng.integers(0, 2, (3, 1, 8, 8))
    want = float(jax_losses.dice_ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(losses.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert math.isclose(got, want, rel_tol=1e-6)
    lc, yc = rng.standard_normal((6, 3)).astype(np.float32), rng.integers(0, 3, 6)
    for lo, la in ((lc, yc), (logits, labels)):
        want = float(jax_losses.focal_loss(jnp.asarray(lo), jnp.asarray(la)))
        got = float(losses.focal_loss(torch.from_numpy(lo), torch.from_numpy(la)))
        assert math.isclose(got, want, rel_tol=1e-6)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2), i, np.uint8), "label": int(i), "name": f"n{i}"}


@pytest.mark.parametrize("shuffle,drop_last,skip", [(True, True, 0), (True, False, 1),
                                                    (False, False, 0)])
def test_batches_follow_the_jax_order(shuffle, drop_last, skip):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=4, workers=2, skip_batches=skip)
    got = list(pipeline.batches(_Items(11), 4, **kw))
    want = list(jax_pipeline.batches(_Items(11), 4, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in ("name", "image", "label"))


def test_seg_metrics_and_results_csv_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 2, 16, 16)).astype(np.float32)
    gt = np.zeros((4, 1, 16, 16), np.int64)
    gt[:2, :, 4:10, 5:12] = 1
    ours, theirs = SegAccumulator(), JaxSegAccumulator()
    ours.update(logits, gt)
    theirs.update(logits, gt)
    stats, want = ours.compute(), theirs.compute()
    assert stats.keys() == want.keys()
    np.testing.assert_array_equal(list(stats.values()), list(want.values()))
    stats["hd95_std"] = float("nan")
    save_results_csv(stats, str(tmp_path / "port.csv"), scale100=())
    jax_save_results_csv(stats, str(tmp_path / "jax.csv"), scale100=())
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    cls = {"acc": 0.5, "rec": 1 / 3, "pre": 0.25, "f1": 0.123456, "auc": 0.75, "loss": 1.0}
    save_results_csv(cls, str(tmp_path / "port_cls.csv"))
    jax_save_results_csv(cls, str(tmp_path / "jax_cls.csv"))
    assert (tmp_path / "port_cls.csv").read_bytes() == (tmp_path / "jax_cls.csv").read_bytes()
