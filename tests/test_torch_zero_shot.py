"""Zero-shot and retrieval of the CLIP families against the JAX package, on
the CPU.

(a) The prompts module equals JAX's; (b) ``build_text_features`` for a
BERT-text tiny BiomedCLIP and a CLIP-text tiny OpenAI model (depth 2, width
96), weights carried over through the .npz bridge: max|d| <= 2e-5 *
max|ref| for each class's prompt features; (c) ``make_zero_shot_logits_fn``
over seeded grayscale uint8 images, with MONA (freq_enhanced, noise_aware)
in the image tower: logits and image features alike; (d)
``retrieval_metrics`` exactly equal on random and tied similarity
matrices, and ``cross_entropy_np``; (e) one ``--debug_tiny`` float32 run of
``biomedclip.zero_shot`` in each package on tests/synth_data.py's data, from
the same JAX-written backbone and MONA checkpoints: the same results.csv,
byte for byte.
"""

import dataclasses
import glob
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu.tasks import prompts as jax_prompts
from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
from nextgen_uia_tpu_torch.tasks import clip_tasks, common, prompts
from synth_data import make_synth_root

W = 96


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


def _tiny(cfg, depth=2):
    vis = dataclasses.replace(cfg.vision, image_size=32, width=W, depth=depth, heads=4,
                              proj_dim=64)
    kw = dict(width=W, depth=2, heads=4, embed_dim=64)
    if cfg.text_kind == "bert":
        kw["intermediate"] = 2 * W
    return cfg.replace(vision=vis, text=dataclasses.replace(cfg.text, **kw))


def _perturbed(tree, seed):
    """Every float leaf scaled by 1 + 0.1 n and shifted by 0.01 n': LayerNorm
    and zero-initialised slots move off their init."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        noise = rng.standard_normal((2, *a.shape)).astype(a.dtype)
        return jnp.asarray(a * (1 + 0.1 * noise[0]) + 0.01 * noise[1])

    return jax.tree_util.tree_map(move, tree)


def _pair(tmp_path, family, mona=None, seed=0):
    """(JAX params and config, the port's model with the same weights through
    the .npz bridge, its config), tiny, with MONA ``mona`` in the image tower."""
    jcfg = _tiny(jax_clip.clip_config(family, mona_variant=mona or "hybrid"))
    key = jax.random.key(seed)
    jp = jax_clip.clip_init(jax.random.fold_in(key, 1), jcfg)
    if mona:
        jp["visual"], _ = jax_mona.inject_mona(jax.random.fold_in(key, 2), jp["visual"], dim=W,
                                               variant=mona)
    jp = _perturbed(jp, seed)
    jax_ckpt.save(str(tmp_path / f"{family}.npz"), jp)
    cfg = _tiny(clip_mod.clip_config(family, mona_variant=mona or "hybrid"))
    gen = torch.Generator().manual_seed(seed)
    model = clip_mod.clip_init(gen, cfg)
    if mona:
        inject_mona(gen, model.visual, dim=W, variant=mona)
    _, n = ckpt.load_into(str(tmp_path / f"{family}.npz"), model)
    assert n == len(model.state_dict())
    return jp, jcfg, model, cfg


@pytest.fixture()
def offline(monkeypatch):
    """No HuggingFace tokenizer files on either side: the CLIP-BPE fallbacks."""
    monkeypatch.setattr(jax_common, "load_hf_tokenizer", lambda *a, **k: None)
    monkeypatch.setattr(common, "load_hf_tokenizer", lambda *a, **k: None)


def test_prompts_match_jax():
    for name in ("LESION_TYPES", "LN_PROMPTS_ENSEMBLE", "BREAST_PROMPTS_ENSEMBLE",
                 "CLIPSEG_DENSE_PROMPTS"):
        assert getattr(prompts, name) == getattr(jax_prompts, name), name
    for ds in ("BUSI", "busi_small", "LN", "ln_2", "DDTI", "TN3K", "thyroid", "prostate"):
        assert prompts.clipseg_prompt_for(ds) == jax_prompts.clipseg_prompt_for(ds)
    for ds in ("BUSI", "LN", "my_ln"):
        assert prompts.prompt_ensemble_for(ds) is getattr(
            prompts, ("LN" if "ln" in ds.lower() else "BREAST") + "_PROMPTS_ENSEMBLE")
        assert prompts.prompt_ensemble_for(ds) == jax_prompts.prompt_ensemble_for(ds)
    for fn in (prompts.prompt_ensemble_for, prompts.clipseg_prompt_for):
        with pytest.raises(ValueError):
            fn("cifar")


def _text_pair(tmp_path, family, mona=None):
    jp, jcfg, model, cfg = _pair(tmp_path, family, mona)
    want = jax_tasks.build_text_features(jp, jcfg, jax_common.get_text_tokenizer(None, family),
                                         jax_prompts.BREAST_PROMPTS_ENSEMBLE)
    got = clip_tasks.build_text_features(model, cfg, common.get_text_tokenizer(None, family),
                                         prompts.BREAST_PROMPTS_ENSEMBLE)
    return jp, jcfg, model, cfg, got, want


@pytest.mark.parametrize("family", ["biomedclip", "openai"])
def test_build_text_features_match_jax(tmp_path, offline, family):
    *_, got, want = _text_pair(tmp_path, family)
    assert list(got) == list(want) == prompts.LESION_TYPES
    for c in prompts.LESION_TYPES:
        assert got[c].dtype == torch.float32 and got[c].shape == (10, 64)
        _close(got[c].numpy(), want[c], 2e-5)
        np.testing.assert_allclose(torch.linalg.vector_norm(got[c], dim=1).numpy(), 1.0,
                                   rtol=1e-6)


@pytest.mark.parametrize("family,mona", [("biomedclip", "freq_enhanced"),
                                         ("openai", "noise_aware")])
def test_zero_shot_logits_match_jax(tmp_path, offline, family, mona):
    jp, jcfg, model, cfg, got_t, want_t = _text_pair(tmp_path, family, mona)
    images = np.random.default_rng(5).integers(0, 256, (3, 32, 32), dtype=np.uint8)
    want_logits, want_feats = jax_tasks.make_zero_shot_logits_fn(jcfg, want_t)(
        jp, jnp.asarray(images))
    fn = clip_tasks.make_zero_shot_logits_fn(cfg, got_t)
    logits, feats = fn(model, torch.from_numpy(images))
    assert logits.shape == (3, 2) and feats.shape == (3, 64)
    _close(logits.numpy(), want_logits, 2e-5)
    _close(feats.numpy(), want_feats, 2e-5)
    # the class columns follow ``classes``
    swapped, _ = clip_tasks.make_zero_shot_logits_fn(
        cfg, got_t, classes=["malignant", "benign"])(model, torch.from_numpy(images))
    np.testing.assert_array_equal(swapped.numpy(), logits.numpy()[:, ::-1])


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_retrieval_metrics_match_jax(kind):
    rng = np.random.default_rng(3)
    sim = rng.standard_normal((37, 37)).astype(np.float32)
    if kind == "tied":  # four values: most pairs tie, the diagonal with them
        sim = np.round(sim).clip(-1, 2) / 2
        sim[::3, ::2] = sim[0, 0]
    for k_values in ((1, 2, 5, 10), (1, 3), (50,)):
        got = ft.retrieval_metrics(sim, k_values)
        assert got == jax_ft.retrieval_metrics(sim, k_values)
    eye = ft.retrieval_metrics(np.eye(6, dtype=np.float32))
    assert eye["rsum"] == 800.0 and eye["i2t"]["medr"] == eye["t2i"]["meanr"] == 1.0


def test_cross_entropy_np_matches_jax():
    rng = np.random.default_rng(4)
    logits = (30 * rng.standard_normal((9, 2))).astype(np.float32)
    labels = rng.integers(0, 2, 9)
    assert clip_tasks.cross_entropy_np(logits, labels) == jax_tasks.cross_entropy_np(
        logits, labels)


def test_biomedclip_zero_shot_cli_matches_jax(tmp_path, monkeypatch, offline):
    """Both packages' CLIs on one dataset, from the same JAX-written
    --backbone_ckpt and --mona_weights (freq_enhanced, the CLI default),
    float32: equal results.csv."""
    from nextgen_uia_tpu.tasks.biomedclip import zero_shot as jax_cli
    from nextgen_uia_tpu_torch.tasks.biomedclip import zero_shot as port_cli

    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=32)
    monkeypatch.chdir(tmp_path)
    jcfg = _tiny(jax_clip.clip_config("biomedclip", mona_variant="freq_enhanced"), depth=4)
    key = jax.random.key(9)
    jp = _perturbed(jax_clip.clip_init(jax.random.fold_in(key, 1), jcfg), 9)
    jax_ckpt.save(str(tmp_path / "backbone.npz"), jp)
    jp["visual"], _ = jax_mona.inject_mona(jax.random.fold_in(key, 2), jp["visual"], dim=W,
                                           variant="freq_enhanced")
    jax_ckpt.save(str(tmp_path / "mona.npz"), _perturbed(jp, 10), keyword_filter=["mona"])
    argv = ["--data_root", str(root), "--dataset", "BUSI", "--debug_tiny", "--img_size", "32",
            "--batch_size", "5", "--compute_dtype", "float32", "--num_workers", "2",
            "--device", "cpu", "--backbone_ckpt", str(tmp_path / "backbone.npz"),
            "--mona_weights", str(tmp_path / "mona.npz")]
    want = jax_cli.main(argv + ["--exp", "zs_jax"])
    got = port_cli.main(argv + ["--exp", "zs_port"])
    assert got.keys() == want.keys()
    assert math.isclose(got["loss"], want["loss"], rel_tol=1e-5)
    for k in ("acc", "rec", "pre", "f1", "auc"):
        assert got[k] == want[k], k
    (theirs,) = glob.glob(str(tmp_path / "runs" / "zs_jax" / "BUSI" / "test" / "*acc*" /
                              "results.csv"))
    (ours,) = glob.glob(str(tmp_path / "runs" / "zs_port" / "BUSI" / "test" / "*acc*" /
                            "results.csv"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
