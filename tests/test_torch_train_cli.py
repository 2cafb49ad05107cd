"""The port's supervised trainer CLI on the CPU, and the rule that the port
imports nothing of the JAX package.

The trainer runs ``--debug_tiny --img_size 32`` on tests/synth_data.py's
dataset with hybrid MONA, augmentation off and (a run of its own) at its
default augmentation: it writes results.csv in the JAX CLI's layout, a
best_model.npz that the JAX package loads into its own trainable tree, and a
last_state.npz that ``--resume`` continues from.
"""

import ast
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters.mona import inject_mona as jax_inject_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.experiment import save_results_csv as jax_save_results_csv
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models.heads import PyramidHeadConfig as JaxHeadConfig
from nextgen_uia_tpu.models.heads import pyramid_head_init as jax_head_init
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from synth_data import make_synth_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tiny(seed=0):
    """The JAX package's debug_tiny BiomedCLIP tree with hybrid MONA and a
    2-class seg head, and its trainable subtree."""
    cfg = jax_clip.clip_config("biomedclip", mona_variant="hybrid")
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, image_size=32, width=96, depth=4,
                                                 heads=4, proj_dim=64))
    key = jax.random.key(seed)
    backbone = jax_clip.clip_init(jax.random.fold_in(key, 1), cfg)
    backbone["visual"], _ = jax_inject_mona(jax.random.fold_in(key, 2), backbone["visual"],
                                            dim=96, variant="hybrid")
    head = jax_head_init(jax.random.fold_in(key, 3),
                         JaxHeadConfig(feature_dim=96, img_size=32, task="seg"))
    return backbone, {"backbone": backbone, "head": head}


@pytest.fixture()
def synth(tmp_path, monkeypatch):
    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=32)
    monkeypatch.chdir(tmp_path)
    backbone, _ = _jax_tiny()
    jax_ckpt.save(str(tmp_path / "mona.npz"), backbone, keyword_filter=["mona"])
    return str(root), str(tmp_path / "mona.npz")


def _argv(root, mona, *extra):
    return ["--dataset", "BUSI", "--data_root", root, "--exp", "pseg", "--img_size", "32",
            "--batch_size", "4", "--debug_tiny", "--num_workers", "2", "--device", "cpu",
            "--compute_dtype", "float32", "--no-strong_augs", "--no-weak_augs",
            "--mona_variant", "hybrid", "--mona_weights", mona, "--val_interval", "1",
            "--patience", "3", *extra]


def test_trainer_cli_writes_what_the_jax_package_reads(synth, tmp_path):
    from nextgen_uia_tpu_torch.tasks.biomedclip.segmentation import main

    root, mona = synth
    stats = main(_argv(root, mona, "--epochs", "1"))
    assert {"dice_mean", "iou_mean", "hd95_mean", "asd_mean", "loss"} <= set(stats)
    assert np.isfinite(stats["loss"])
    run = tmp_path / "runs" / "pseg" / "BUSI" / "train"
    (results,) = glob.glob(str(run / "*_iou=*" / "results.csv"))
    jax_save_results_csv(stats, str(tmp_path / "jax_results.csv"), scale100=())
    with open(results, "rb") as f:
        assert f.read() == (tmp_path / "jax_results.csv").read_bytes()

    # best_model.npz (params/ root: MONA + head) loads into the JAX trainable tree
    _, params = _jax_tiny(seed=1)
    trainable, _ = jax_partition(params, jax_by_keywords("head", "mona", "lora"))
    loaded, n = jax_ckpt.load_into(str(run / "best_model.npz"), {"params": trainable})
    want = dict(jax_flatten(trainable))
    assert n == len(want) == len(ckpt.peek_keys(str(run / "best_model.npz")))
    saved = ckpt.load_flat(str(run / "best_model.npz"))
    for path, arr in jax_flatten(loaded["params"]):
        np.testing.assert_array_equal(np.asarray(arr), saved[f"params/{path}"])

    # --resume continues from last_state.npz: epoch 1 is not replayed
    _, meta = ckpt.load_train_state(str(run / "last_state.npz"))
    assert meta["epoch"] == 1 and meta["applied_updates"] == 1
    main(_argv(root, mona, "--epochs", "2", "--resume"))
    _, meta = ckpt.load_train_state(str(run / "last_state.npz"))
    assert meta["epoch"] == 2 and meta["applied_updates"] == 2
    log = open(max(glob.glob(str(run / "*_iou=*" / "log.log")), key=os.path.getmtime)).read()
    assert "Resumed from" in log and "Epoch 1:" not in log


def test_trainer_cli_refuses_what_is_not_ported(synth):
    from nextgen_uia_tpu_torch.tasks import other_tasks
    from nextgen_uia_tpu_torch.tasks.biomedclip import segmentation
    from nextgen_uia_tpu_torch.tasks.dino import classification as dino_cls

    root, mona = synth
    base = _argv(root, mona, "--epochs", "1")
    # several devices take a torchrun launch of as many processes
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        segmentation.main(base + ["--n_data", "2"])
    dino = ["--dataset", "BUSI", "--data_root", root, "--debug_tiny", "--img_size", "28",
            "--device", "cpu"]
    # the few-shot mains and --lora_weights run since their slice
    # (tests/test_torch_fewshot_lora.py); a grid this launch lacks refuses
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        other_tasks.dino_segmentation_main(dino + ["--n_data", "2"], fewshot=True)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        dino_cls.main(dino + ["--lora_weights", "x.npz", "--n_model", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            segmentation.main([a for a in base if a not in ("--device", "cpu")])


def test_trainer_cli_runs_with_default_augmentation(synth, tmp_path):
    """The trainer's defaults (--strong_augs --weak_augs) on the CPU: the
    batch is augmented on the device before the forward, and the run ends
    with finite stats and its best_model.npz."""
    from nextgen_uia_tpu_torch.tasks.biomedclip import classification, segmentation

    root, mona = synth
    augs_default = [a for a in _argv(root, mona, "--epochs", "1")
                    if a not in ("--no-strong_augs", "--no-weak_augs")]
    stats = segmentation.main(augs_default)
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["dice_mean"])
    assert (tmp_path / "runs" / "pseg" / "BUSI" / "train" / "best_model.npz").exists()
    stats = classification.main(augs_default + ["--exp", "pcls"])
    assert np.isfinite(stats["acc"])


def _imports(path):
    """(line, module) for every import statement in a file, nested ones
    (inside functions, lazy) included."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Static: no .py of nextgen_uia_tpu_torch/ nor chip_smoke.py imports
    nextgen_uia_tpu (any submodule), jax, flax or optax, at any depth.
    Docstrings and comments may name them."""
    files = glob.glob(os.path.join(REPO, "nextgen_uia_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30 and all(any(os.sep + pkg + os.sep in f for f in files)
                                   for pkg in ("clipseg", "baselines"))
    banned = ("nextgen_uia_tpu", "jax", "jaxlib", "flax", "optax")
    bad = [f"{os.path.relpath(f, REPO)}:{line}: {mod}" for f in files
           for line, mod in _imports(f) if mod.split(".")[0] in banned]
    assert not bad, bad
