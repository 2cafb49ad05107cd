"""Smoke test of the port's bench (``python -m nextgen_uia_tpu_torch.bench``)
on the CPU at toy size, every mode, and its three JAX bench modes held to
the JAX package.

A regression in the bench would void the number a chip run reports, so
each mode runs end to end here with NEXTGEN_UIA_BENCH_* shrunk to seconds of
CPU work (depth 1-2, 32-64 px, float32, one warm-up and one step per window)
and ``device="cpu"``. The rate is not asserted (a CPU time says nothing
about the card); the one JSON line and the JAX mode's keys are, and that no
kernel launched. Then, on the same ``.npz`` weights and inputs, at depth 2
and 64 px in float32:

- the supervised mode's first-step loss (augmentation and dropout off)
  against the JAX bench's composition (``encode_image`` with the taps,
  ``pyramid_head_apply``, ``dice_ce_loss``): |d| <= 2e-5 * max(1, |ref|);
- the eval mode's logits and features against JAX's
  ``make_zero_shot_logits_fn`` on the same prompt features: max|d| <= 2e-5
  * max|ref|;
- the input mode's files as the JAX bench writes them, and its first two
  batches, PIL decode (NEXTGEN_UIA_NATIVE_LOADER=0), byte-equal to JAX's
  ``batches`` over ``load_image`` with the same seed.
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.data import datasets as jax_datasets
from nextgen_uia_tpu.data import pipeline as jax_pipeline
from nextgen_uia_tpu.losses import dice_ce_loss as jax_dice_ce_loss
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models import heads as jax_heads
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu_torch import bench, ops
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.ops import fused_mona
from nextgen_uia_tpu_torch.tasks.clip_tasks import make_zero_shot_logits_fn

SMOKE_ENV = {"NEXTGEN_UIA_BENCH_BATCH": "4", "NEXTGEN_UIA_BENCH_STEPS": "1",
             "NEXTGEN_UIA_BENCH_WARMUP": "1", "NEXTGEN_UIA_BENCH_DEPTH": "1",
             "NEXTGEN_UIA_BENCH_IMG": "32", "NEXTGEN_UIA_BENCH_DTYPE": "float32"}
MODE_ENV = {"SUPERVISED": {"NEXTGEN_UIA_BENCH_SUP_BATCH": "2"},
            "EVAL": {"NEXTGEN_UIA_BENCH_EVAL_BATCH": "3"},
            "INPUT": {"NEXTGEN_UIA_BENCH_WORKERS": "2", "NEXTGEN_UIA_NATIVE_LOADER": "0"}}
MODE_KNOBS = {"INPUT": {"images": 8}}  # the JAX input mode's n_images argument
BASE_KEYS = {"metric", "value", "unit", "vs_baseline"}
MODE_KEYS = {"SUPERVISED": BASE_KEYS | {"batch", "augs"}, "EVAL": BASE_KEYS | {"batch"},
             "INPUT": BASE_KEYS | {"host_only_images_per_sec", "decode", "workers",
                                   "n_images"}}
TOY = bench.Knobs(depth=2, img=64, dtype="float32", sup_batch=2, augs=False, eval_batch=3)


def _launches():
    """Every kernel wrapper's launch count in the port's ops modules."""
    counts = {}
    for mod in (getattr(ops, m) for m in dir(ops)):
        for name in dir(mod) if getattr(mod, "__name__", "").startswith(ops.__name__) else ():
            fn = getattr(mod, name)
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                counts[f"{mod.__name__}.{name}"] = fn.launches
    return counts


def _one_line(capsys, keys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == keys
    assert rec["value"] > 0 and rec["vs_baseline"] >= 0
    return rec


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_bench_prints_one_json_line(monkeypatch, capsys, fused):
    for k, v in SMOKE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("NEXTGEN_UIA_FUSED_MONA", "1" if fused else "0")
    calls = []
    core = fused_mona._forward_core
    monkeypatch.setattr(fused_mona, "_forward_core", lambda *a: calls.append(1) or core(*a))
    bench.main(device="cpu")
    assert bool(calls) == fused  # the fused route ran K12's plain version on the CPU
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "BUSI Mona fine-tune images/sec/chip"
    assert rec["unit"] == "images/sec/chip" and rec["value"] > 0 and rec["vs_baseline"] >= 0
    assert ("fused" in captured.err) == fused and "cpu" in captured.err
    assert fused_mona.mona_block_fused.launches == 0  # the CPU launches no kernel


@pytest.mark.parametrize("mode", ["SUPERVISED", "EVAL", "INPUT"])
def test_bench_modes_print_one_json_line(monkeypatch, capsys, mode):
    for k, v in {**SMOKE_ENV, **MODE_ENV[mode]}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(f"NEXTGEN_UIA_BENCH_{mode}", "1")
    knobs = dataclasses.replace(bench.Knobs.from_env(), **MODE_KNOBS.get(mode, {}))
    rec = bench.main(device="cpu", knobs=knobs)
    assert _one_line(capsys, MODE_KEYS[mode]) == rec
    assert rec["metric"] == {"SUPERVISED": bench.SUPERVISED_METRIC, "EVAL": bench.EVAL_METRIC,
                             "INPUT": bench.INPUT_METRIC}[mode]
    if mode == "SUPERVISED":
        assert rec["batch"] == 2 and rec["augs"] is True
    elif mode == "EVAL":
        assert rec["batch"] == 3
    else:
        assert rec["decode"] == "PIL" and rec["n_images"] == 8 and rec["workers"] == 2
        assert rec["host_only_images_per_sec"] > 0
    assert not any(_launches().values())  # the CPU launches no kernel


def test_bench_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    for mode in ("", "SUPERVISED", "EVAL", "INPUT"):
        with monkeypatch.context() as m:
            if mode:
                m.setenv(f"NEXTGEN_UIA_BENCH_{mode}", "1")
            with pytest.raises(RuntimeError, match="CUDA"):
                bench.main()


def test_input_mode_refuses_a_batch_above_its_images(monkeypatch):
    monkeypatch.setenv("NEXTGEN_UIA_BENCH_INPUT", "1")
    with pytest.raises(SystemExit, match="exceeds the 2 generated images"):
        bench.main(device="cpu", knobs=bench.Knobs(images=2))


def _jax_tree(path, knobs, head=None):
    """The JAX bench's tree (``__graft_entry__._flagship`` and, given a head
    config, the PyramidHead), traced for its shapes only, every tensor
    loaded from the port's file."""
    cfg = jax_clip.clip_config("biomedclip", compute_dtype=knobs.dtype, mona_variant="hybrid")
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=knobs.depth, image_size=knobs.img),
        text=dataclasses.replace(cfg.text, depth=max(knobs.depth // 2, 1)))

    def init():
        p = jax_clip.clip_init(jax.random.key(0), cfg)
        p["visual"], _ = jax_mona.inject_mona(jax.random.key(1), p["visual"],
                                              dim=cfg.vision.width, variant="hybrid")
        if head is None:
            return p
        return {"backbone": p, "head": jax_heads.pyramid_head_init(jax.random.key(7), head)}

    shapes = jax.eval_shape(init)
    tree, n = jax_ckpt.load_into(path, shapes)
    assert n == len(jax_flatten(shapes)) == len(np.load(path).files)
    return cfg, tree


def test_supervised_first_loss_matches_jax(tmp_path):
    sb = bench.build_supervised("cpu", TOY)
    path = str(tmp_path / "sup.npz")
    assert ckpt.save(path, sb.params) == len(sb.params.state_dict())
    mb = {k: v[0] for k, v in sb.batch.items()}
    with torch.no_grad():
        got = sb.loss_fn(augs=False)(mb, None).item()

    hcfg = jax_heads.PyramidHeadConfig(feature_dim=768, reduce_dim=512, num_classes=2,
                                       img_size=TOY.img, task="seg", cls_hidden=False)
    cfg, p = _jax_tree(path, TOY, hcfg)
    taps = jax_tasks.extract_layers_for(TOY.depth)

    @jax.jit
    def loss(p, image, mask):  # the JAX bench's loss_fn with augs off, no dropout
        x = jnp.repeat(image.astype(jnp.float32)[..., None] / 255.0, 3, axis=-1)
        _, acts = jax_clip.encode_image(p["backbone"], cfg, x, extract_layers=taps)
        logits = jax_heads.pyramid_head_apply(p["head"], hcfg, acts)
        return jax_dice_ce_loss(logits, mask.astype(jnp.int32)[:, None])

    want = float(loss(p, jnp.asarray(mb["image"].numpy()), jnp.asarray(mb["mask"].numpy())))
    assert np.isfinite(got) and abs(got - want) <= 2e-5 * max(1.0, abs(want))


def test_eval_logits_match_jax(tmp_path):
    eb = bench.build_eval("cpu", TOY)
    path = str(tmp_path / "eval.npz")
    ckpt.save(path, eb.params)
    logits, feats = make_zero_shot_logits_fn(eb.cfg, eb.text_feats)(eb.params, eb.images)
    assert logits.shape == (3, 2) and feats.shape == (3, 512)

    cfg, p = _jax_tree(path, TOY)
    protos = {c: jnp.asarray(f.numpy()) for c, f in eb.text_feats.items()}
    want_logits, want_feats = jax_tasks.make_zero_shot_logits_fn(cfg, protos)(
        p, jnp.asarray(eb.images.numpy()))
    for a, b in ((logits, want_logits), (feats, want_feats)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2e-5 * np.abs(b).max()


class _JaxBenchImages:
    """The JAX input bench's dataset: ``load_image`` repeated to 3 channels."""

    def __init__(self, paths, size):
        self.paths, self.size = paths, size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        g = jax_datasets.load_image(self.paths[i], self.size)
        return {"image": np.repeat(g[:, :, None], 3, axis=2)}


def test_input_feed_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NEXTGEN_UIA_NATIVE_LOADER", "0")
    paths = bench.write_pngs(str(tmp_path), 12)
    rng = np.random.default_rng(0)  # the JAX input bench's files, in order
    for p in paths:
        want = rng.integers(0, 255, (256, 256), dtype=np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), want)
    feat = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    ds = bench.DecodedImages(paths, 64)
    got = list(itertools.islice(bench.input_batches(ds, 4, 2, feat), 2))
    want = list(itertools.islice(jax_pipeline.batches(
        _JaxBenchImages(paths, 64), 4, shuffle=True, drop_last=True, seed=0, workers=2), 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["image"].shape == (1, 4, 64, 64, 3) and g["image"].dtype == np.uint8
        assert g["image"][0].tobytes() == w["image"].tobytes()
        np.testing.assert_array_equal(g["txt_feat"], feat[None])
    assert ds.decoders == {"PIL"}
