"""The port's serving slice as a whole against the JAX package.

(a) The seg/cls forward (ViT + MONA in every block + PyramidHead) with one
set of weights through the bridge: the JAX forward runs its whole-block
Pallas kernel in interpret mode (NEXTGEN_UIA_FUSED_BLOCK=force, tokens
padded 17 -> 32), the port runs 17 tokens unpadded; logits agree at 1e-4.
(b) Both ``predict`` CLIs on the same .npz files and PNGs, 7 images at batch
4 so a ragged tail occurs: probabilities agree at 1e-4, masks are identical,
row order is kept.
Plus the host helpers of the slice and the rule that the port never
imports JAX.
"""

import argparse
import csv
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nextgen_uia_tpu.adapters.mona import inject_mona as jax_inject_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.train import pad_eval_batch as jax_pad_eval_batch
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models.heads import PyramidHeadConfig as JaxHeadConfig
from nextgen_uia_tpu.models.heads import pyramid_head_init as jax_head_init
from nextgen_uia_tpu.nn.layers import resize_bilinear as jax_resize_bilinear
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core.train import pad_eval_batch
from nextgen_uia_tpu_torch.data.pipeline import prefetch_to_device
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
from nextgen_uia_tpu_torch.nn.layers import resize_bilinear
from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.tasks import clip_tasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shrink(vision, **kw):
    return dataclasses.replace(vision, image_size=64, width=128, depth=4, heads=2,
                               proj_dim=64, **kw)


@pytest.mark.parametrize("task", ["seg", "cls"])
def test_forward_matches_jax_fused_kernel(tmp_path, monkeypatch, task):
    monkeypatch.setenv("NEXTGEN_UIA_FUSED_BLOCK", "force")
    jcfg = jax_clip.clip_config("biomedclip", mona_variant="hybrid")
    jcfg = jcfg.replace(vision=_shrink(jcfg.vision),
                        text=dataclasses.replace(jcfg.text, width=64, depth=1, heads=2,
                                                 intermediate=128, embed_dim=64))
    key = jax.random.key(3)
    backbone = jax_clip.clip_init(jax.random.fold_in(key, 1), jcfg)
    backbone["visual"], _ = jax_inject_mona(jax.random.fold_in(key, 2), backbone["visual"],
                                            dim=128, variant="hybrid")
    jh = JaxHeadConfig(feature_dim=128, img_size=64, task=task)
    params = {"backbone": backbone, "head": jax_head_init(jax.random.fold_in(key, 3), jh)}
    images = np.random.default_rng(0).integers(0, 256, (3, 64, 64), dtype=np.uint8)
    args = types.SimpleNamespace(strong_augs=False, weak_augs=False, img_size=64)
    fwd = jax.jit(jax_tasks._make_forward(jcfg, jh, args, train=False))
    want, _ = fwd(params, jnp.asarray(images), None, jax.random.key(0))

    jax_ckpt.save(str(tmp_path / "w.npz"), params)
    gen = torch.Generator().manual_seed(9)
    cfg = clip_mod.clip_config("biomedclip", mona_variant="hybrid")
    cfg = cfg.replace(vision=_shrink(cfg.vision),
                      text=dataclasses.replace(cfg.text, width=64, depth=1, heads=2,
                                               intermediate=128, embed_dim=64))
    port_backbone = clip_mod.clip_init(gen, cfg)
    inject_mona(gen, port_backbone.visual, dim=128, variant="hybrid")
    hcfg = PyramidHeadConfig(feature_dim=128, img_size=64, task=task)
    model = torch.nn.ModuleDict({"backbone": port_backbone,
                                 "head": pyramid_head_init(gen, hcfg)})
    _, n = ckpt.load_into(str(tmp_path / "w.npz"), model)
    assert n == len(model.state_dict())
    with torch.no_grad():
        got = clip_tasks.make_forward(cfg, hcfg, train=False)(
            model, torch.from_numpy(images))
    want = np.asarray(want)
    assert got.shape == want.shape == ((3, 2, 64, 64) if task == "seg" else (3, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _write_checkpoints(tmp_path, task, num_classes):
    """The .npz files the JAX package's own trees give for the debug_tiny
    tower: backbone (clip_init root), MONA slots (clip root, filtered) and a
    supervised file rooted like _build_supervised's params."""
    cfg = jax_clip.clip_config("biomedclip", mona_variant="hybrid")
    cfg = cfg.replace(
        vision=dataclasses.replace(cfg.vision, image_size=32, width=96, depth=4, heads=4,
                                   proj_dim=64),
        text=dataclasses.replace(cfg.text, width=96, depth=2, heads=4, intermediate=192,
                                 embed_dim=64))
    key = jax.random.key(21)
    clip_params = jax_clip.clip_init(jax.random.fold_in(key, 1), cfg)
    files = {"backbone_ckpt": str(tmp_path / "backbone.npz"),
             "mona_weights": str(tmp_path / "mona.npz"),
             "head_weights": str(tmp_path / "head.npz")}
    jax_ckpt.save(files["backbone_ckpt"], clip_params)
    clip_params["visual"], _ = jax_inject_mona(jax.random.fold_in(key, 2),
                                               clip_params["visual"], dim=96,
                                               variant="hybrid")
    jax_ckpt.save(files["mona_weights"], clip_params, keyword_filter=["mona"])
    hcfg = JaxHeadConfig(feature_dim=96, num_classes=num_classes, img_size=32, task=task)
    head = jax_head_init(jax.random.fold_in(key, 3), hcfg)
    jax_ckpt.save(files["head_weights"], {"backbone": clip_params, "head": head})
    return [a for k, v in files.items() for a in (f"--{k}", v)]


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_predict_cli_matches_jax(tmp_path, monkeypatch, task):
    from nextgen_uia_tpu.tasks.biomedclip.predict import main as jax_main
    from nextgen_uia_tpu_torch.tasks.biomedclip.predict import main as port_main

    monkeypatch.chdir(tmp_path)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        paths.append(str(img_dir / f"img_{i:02d}.png"))
        Image.fromarray(rng.integers(0, 255, (48, 48), np.uint8)).save(paths[-1])
    common = (["--task", task, "--images", str(img_dir), "--debug_tiny", "--img_size", "32",
               "--batch_size", "4", "--num_workers", "2", "--compute_dtype", "float32",
               "--mona_variant", "hybrid", "--num_classes", "3", "--device", "cpu"]
              + _write_checkpoints(tmp_path, task, 3))
    out_j = jax_main(common + ["--out", str(tmp_path / "jax")])["out"]
    out_t = port_main(common + ["--out", str(tmp_path / "port")])["out"]

    name = "predictions.csv" if task == "cls" else "index.csv"
    with open(os.path.join(out_j, name)) as f:
        rows_j = list(csv.DictReader(f))
    with open(os.path.join(out_t, name)) as f:
        rows_t = list(csv.DictReader(f))
    assert [r["path"] for r in rows_t] == [r["path"] for r in rows_j] == paths
    for rj, rt in zip(rows_j, rows_t):
        assert rt["status"] == rj["status"] == "ok"
        if task == "cls":
            assert rt["pred"] == rj["pred"]
            pj = [float(v) for k, v in rj.items() if k.startswith("prob_")]
            pt = [float(v) for k, v in rt.items() if k.startswith("prob_")]
            np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
        else:
            assert rt["foreground_frac"] == rj["foreground_frac"]
            mj = np.asarray(Image.open(rj["mask"]))
            mt = np.asarray(Image.open(rt["mask"]))
            assert mt.shape == (32, 32) and np.array_equal(mt, mj)


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What the predict CLIs once refused now runs: ``--export`` (zero-shot,
    cls, the baselines' seg) writes a program and its weights that load
    back, ``--n_model`` is ignored by serving, as in the JAX CLI; serving
    on an absent CUDA device still refuses."""
    from nextgen_uia_tpu_torch.tasks.biomedclip.predict import main
    from nextgen_uia_tpu_torch.tasks.serve import load_exported_params, predict_main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "imgs").mkdir()
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "imgs" / "a.png")
    base = ["--images", str(tmp_path / "imgs"), "--debug_tiny", "--img_size", "32",
            "--device", "cpu", "--batch_size", "1"]

    def exported(out, name="f"):
        program = torch.export.load(os.path.join(out, name + ".pt2"))
        weights = load_exported_params(os.path.join(out, name + ".pt2.params.npz"))
        logits = program.module()(weights, torch.zeros(1, 32, 32, dtype=torch.uint8))
        assert torch.isfinite(logits).all()
        return logits

    for extra in (["--export", "f.pt2"], ["--task", "cls", "--export", "f.pt2"],
                  ["--task", "cls", "--n_model", "2"]):
        out = str(tmp_path / f"out{len(extra)}_{extra[1]}")
        assert main(base + extra + ["--out", out])["n_images"] == 1
        if "--export" in extra:
            assert exported(out).shape == (1, 2)
    out = str(tmp_path / "out_baselines")
    predict_main("baselines", base + ["--task", "seg", "--export", "f.pt2", "--out", out,
                                      "--init_channels", "2"])
    assert exported(out).shape == (1, 2, 32, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--images", str(tmp_path / "imgs"), "--task", "seg", "--debug_tiny"])


def test_resize_bilinear_matches_jax_at_the_edges():
    """Upsampling 14 -> 224 and an odd 5 -> 13: half-pixel bilinear, no
    antialias, including the clamped border rows and columns."""
    rng = np.random.default_rng(0)
    for src, dst in ((14, 224), (5, 13)):
        x = rng.standard_normal((2, src, src + 1, 3)).astype(np.float32)
        want = np.asarray(jax_resize_bilinear(jnp.asarray(x), (dst, dst + 3)))
        got = resize_bilinear(torch.from_numpy(x), (dst, dst + 3)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-6, rtol=0)


def test_pad_eval_batch_and_prefetch():
    imgs = np.arange(5 * 2 * 2, dtype=np.uint8).reshape(5, 2, 2)
    batch = {"image": imgs, "paths": list("abcde")}
    got, n = pad_eval_batch(batch, 4)
    want, n_j = jax_pad_eval_batch(batch, 4)
    assert n == n_j == 5 and got["paths"] == batch["paths"]
    assert np.array_equal(got["image"], np.asarray(want["image"]))
    assert np.array_equal(got["image"][5:], np.repeat(imgs[-1:], 3, axis=0))
    assert pad_eval_batch(batch, 5)[0] is batch

    batches = [{"image": imgs[i:i + 2], "n": i} for i in range(0, 5, 2)]
    out = list(prefetch_to_device(iter(batches), device=torch.device("cpu")))
    assert [b["n"] for b in out] == [0, 2, 4]
    for b, src in zip(out, batches):
        assert isinstance(b["image"], torch.Tensor)
        assert np.array_equal(b["image"].numpy(), src["image"])


def test_normalize_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    x[0] = 0.0  # the eps floor
    want = np.asarray(jax_clip.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(clip_mod.normalize(torch.from_numpy(x)).numpy(), want,
                               atol=1e-7, rtol=0)


def test_port_never_imports_jax():
    """Importing every module of the port pulls in no JAX (fresh process)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nextgen_uia_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) > 15, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_build_supervised_reads_rooted_and_bare_files(tmp_path):
    """--head_weights rooted at 'params/' (the supervised trainer's payload)
    and bare-rooted both load; a file matching neither raises NoMatch."""
    from nextgen_uia_tpu_torch.tasks.common import base_parser

    args = base_parser("t").parse_args(["--debug_tiny", "--img_size", "32",
                                        "--mona_weights", str(tmp_path / "none.npz")])
    gen = torch.Generator().manual_seed(0)
    _, _, ref = clip_tasks._build_supervised(
        argparse.Namespace(**{**vars(args), "mona_weights": None}), "biomedclip", "seg", gen)
    ckpt.save(str(tmp_path / "bare.npz"), ref)
    ckpt.save(str(tmp_path / "rooted.npz"), torch.nn.ModuleDict({"params": ref}))
    for name in ("bare.npz", "rooted.npz"):
        a = argparse.Namespace(**{**vars(args), "mona_weights": None,
                                  "head_weights": str(tmp_path / name)})
        _, _, got = clip_tasks._build_supervised(a, "biomedclip", "seg",
                                                 torch.Generator().manual_seed(1))
        for k, v in ref.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), (name, k)
    np.savez(tmp_path / "other.npz", x=np.zeros(1))
    a = argparse.Namespace(**{**vars(args), "mona_weights": None,
                              "head_weights": str(tmp_path / "other.npz")})
    with pytest.raises(ckpt.NoMatch):
        clip_tasks._build_supervised(a, "biomedclip", "seg", gen)
