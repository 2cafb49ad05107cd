"""The CLIP families' other paths against the JAX package, on the CPU.

(a) UniMedCLIP's tokenizer: the BiomedBERT files asked for at context 77,
else the CLIP BPE at 77, not marked as a fallback, ids equal to JAX's;
(b) the OpenAI family's cls head (``cls_hidden``: GAP -> fc1 -> ReLU ->
dropout 0.1 -> fc2) in eval within 2e-5 * max|ref|, its tensors named
``cls_head/fc1`` and ``cls_head/fc2`` both ways over the .npz bridge, and
its train-mode dropout at rate 0.1 from the generator; (c) three AdamW
steps of the tiny OpenAI-layout supervised cls step (quick_gelu,
``ln_pre``, ``final_norm='cls'``, noise_aware MONA, the hidden head; width
128, depth 2, 64 px) under run_supervised's settings, dropout neutralised
on both sides: losses within 1e-4 relative, first-step gradients of every
trainable tensor within 1e-4 * max|g|; (d) ``biomedclip.retrieval`` in both
packages on a synthetic caption CSV from one JAX-written backbone: equal
results.csv and features; (e) port-only ``--debug_tiny`` runs of
``unimedclip.zero_shot``, ``clip.predict`` at its default task,
``clip.classification`` (its best_model.npz loads into the JAX trainable
tree) and ``clip.finetune --method mona --chain_zero_shot BUSI``.
"""

import dataclasses
import glob
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models import heads as jax_heads
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.models import heads
from nextgen_uia_tpu_torch.tasks import clip_tasks, common
from synth_data import make_finetune_csv, make_synth_root

TEXTS = ["A benign nodule with an oval shape and circumscribed margins",
         "A malignant nodule causing posterior acoustic shadowing", "", "!!! 12.5 mm"]


@pytest.fixture()
def offline(monkeypatch):
    """No HuggingFace tokenizer files on either side."""
    monkeypatch.setattr(jax_common, "load_hf_tokenizer", lambda *a, **k: None)
    monkeypatch.setattr(common, "load_hf_tokenizer", lambda *a, **k: None)


def test_unimedclip_tokenizer_matches_jax(monkeypatch, offline):
    ours = common.get_text_tokenizer(None, "unimedclip")
    theirs = jax_common.get_text_tokenizer(None, "unimedclip")
    assert not getattr(ours, "is_fallback", False) and not getattr(theirs, "is_fallback", False)
    got, want = ours(TEXTS), theirs(TEXTS)
    assert got.shape == (len(TEXTS), 77) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours(TEXTS, 20), theirs(TEXTS, 20))
    # a full-size run takes it: it is not the folded fallback
    common.require_real_tokenizer(types.SimpleNamespace(debug_tiny=False), ours, "unimedclip")

    # with the files cached, both ask for BiomedBERT at context 77
    asked = []
    monkeypatch.setattr(common, "load_hf_tokenizer",
                        lambda name, context_length: asked.append((name, context_length)) or id)
    monkeypatch.setattr(jax_common, "load_hf_tokenizer",
                        lambda name, context_length: asked.append((name, context_length)) or id)
    assert common.get_text_tokenizer(None, "unimedclip") is id
    assert jax_common.get_text_tokenizer(None, "unimedclip") is id
    assert asked[0] == asked[1] == ("microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract", 77)


def _head_pair(tmp_path, seed=0):
    jcfg = jax_heads.PyramidHeadConfig(feature_dim=96, reduce_dim=64, num_classes=3,
                                       img_size=32, task="cls", cls_hidden=True)
    rng = np.random.default_rng(seed)
    jp = jax_heads.pyramid_head_init(jax.random.key(seed), jcfg)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)),
                              jnp.float32), jp)
    jax_ckpt.save(str(tmp_path / "head.npz"), jp)
    cfg = heads.PyramidHeadConfig(feature_dim=96, reduce_dim=64, num_classes=3, img_size=32,
                                  task="cls", cls_hidden=True)
    head = heads.pyramid_head_init(torch.Generator().manual_seed(seed), cfg)
    _, n = ckpt.load_into(str(tmp_path / "head.npz"), head)
    assert n == len(head.state_dict()) == len(jax_flatten(jp))
    return jp, jcfg, head, cfg


def test_cls_hidden_head_matches_jax(tmp_path, monkeypatch):
    jp, jcfg, head, cfg = _head_pair(tmp_path)
    names = {k for k, _ in jax_flatten(jp) if k.startswith("cls_head/")}
    assert names == {"cls_head/fc1/w", "cls_head/fc1/b", "cls_head/fc2/w", "cls_head/fc2/b"}
    rng = np.random.default_rng(1)
    acts = [rng.standard_normal((2, 17, 96)).astype(np.float32) for _ in range(3)]
    want = np.asarray(jax_heads.pyramid_head_apply(jp, jcfg, [jnp.asarray(a) for a in acts]))
    with torch.no_grad():
        got = heads.pyramid_head_apply(head, cfg, [torch.from_numpy(a) for a in acts])
    assert got.shape == (2, 3)
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()

    # the port writes what the JAX package loads, with JAX's names
    with torch.no_grad():
        for t in head.parameters():
            t.mul_(1.5)
    n = ckpt.save(str(tmp_path / "port.npz"), head)
    back, n_back = jax_ckpt.load_into(str(tmp_path / "port.npz"), jp)
    assert n == n_back == len(jax_flatten(jp))
    flat = dict(head.state_dict())
    for path, arr in jax_flatten(back):
        np.testing.assert_array_equal(np.asarray(arr), flat[path.replace("/", ".")].numpy())

    # train mode: the hidden features [B, reduce_dim] dropped at rate 0.1 by a mask
    # drawn from the generator (the timm head drops the pooled features at 0.5)
    x = [torch.from_numpy(a) for a in acts]
    seen = []
    real = heads.dropout
    monkeypatch.setattr(heads, "dropout",
                        lambda t, rate, gen=None: seen.append((tuple(t.shape), rate))
                        or real(t, rate, gen=gen))
    with torch.no_grad():
        a = heads.pyramid_head_apply(head, cfg, x, gen=torch.Generator().manual_seed(3))
        b = heads.pyramid_head_apply(head, cfg, x, gen=torch.Generator().manual_seed(3))
        c = heads.pyramid_head_apply(head, cfg, x, gen=torch.Generator().manual_seed(4))
        timm_cfg = dataclasses.replace(cfg, cls_hidden=False)
        heads.pyramid_head_apply(heads.pyramid_head_init(torch.Generator(), timm_cfg),
                                 timm_cfg, x, gen=torch.Generator())
    assert seen == [((2, 64), 0.1)] * 3 + [((2, 64), 0.5)]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, got)


DIM = 128


def _shrink(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=64, width=DIM, depth=2, heads=2,
                              proj_dim=64)
    # the text tower, which the supervised step never runs, at a small size
    txt = dataclasses.replace(cfg.text, width=64, depth=1, heads=2, embed_dim=64,
                              vocab_size=300)
    return cfg.replace(vision=vis, text=txt)


def test_openai_cls_steps_match_jax(tmp_path, monkeypatch):
    """The JAX openai supervised cls step (``_build_supervised``'s hidden
    head, noise_aware MONA) against the port's for three AdamW updates."""
    monkeypatch.setattr(jax_mona, "dropout", lambda rng, x, rate: x)
    monkeypatch.setattr(jax_heads, "dropout", lambda rng, x, rate: x)
    jcfg = _shrink(jax_clip.clip_config("openai", mona_variant="noise_aware"))
    assert (jcfg.vision.act, jcfg.vision.use_ln_pre, jcfg.vision.final_norm) == (
        "quick_gelu", True, "cls")
    key = jax.random.key(5)
    backbone = jax_clip.clip_init(jax.random.fold_in(key, 1), jcfg)
    backbone["visual"], _ = jax_mona.inject_mona(jax.random.fold_in(key, 2), backbone["visual"],
                                                 dim=DIM, variant="noise_aware")
    jh = jax_heads.PyramidHeadConfig(feature_dim=DIM, img_size=64, task="cls",
                                     num_layers=2, cls_hidden=True)
    params = {"backbone": backbone,
              "head": jax_heads.pyramid_head_init(jax.random.fold_in(key, 3), jh)}
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(  # MONA's and the LayerNorms' slots off their init
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.1 * rng.standard_normal(np.shape(a)))
                              + 0.01 * rng.standard_normal(np.shape(a)), jnp.float32), params)
    jax_ckpt.save(str(tmp_path / "w.npz"), params)

    imgs = np.random.default_rng(7).integers(0, 256, (2, 64, 64), dtype=np.uint8)
    labels = np.array([0, 1], np.int64)
    args = types.SimpleNamespace(strong_augs=False, weak_augs=False, img_size=64)
    fwd_j = jax_tasks._make_forward(jcfg, jh, args, train=True)

    def loss_j(tp, frozen, mb, rng_):
        logits, _ = fwd_j(jax_merge(tp, frozen), mb["image"], None, rng_)
        return jax_losses.focal_loss(logits, mb["label"])

    tcfg = dict(lr=1e-4, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    trainable_j, frozen_j = jax_partition(params, jax_by_keywords("head", "mona", "lora"))
    mb_j = {"image": jnp.asarray(imgs), "label": jnp.asarray(labels)}
    grads_j = dict(jax_flatten(jax.jit(jax.grad(loss_j))(trainable_j, frozen_j, mb_j,
                                                         jax.random.key(0))))
    assert "head/cls_head/fc1/w" in grads_j and "head/cls_head/fc2/b" in grads_j
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
    cfg = _shrink(clip_mod.clip_config("openai", mona_variant="noise_aware"))
    backbone_t = clip_mod.clip_init(gen, cfg)
    inject_mona(gen, backbone_t.visual, dim=DIM, variant="noise_aware")
    hcfg = heads.PyramidHeadConfig(feature_dim=DIM, img_size=64, task="cls", num_layers=2,
                                   cls_hidden=True)
    model = torch.nn.ModuleDict({"backbone": backbone_t,
                                 "head": heads.pyramid_head_init(gen, hcfg)})
    _, n = ckpt.load_into(str(tmp_path / "w.npz"), model)
    assert n == len(model.state_dict())
    trainable, _ = partition(model, by_keywords("head", "mona", "lora"))
    assert set(trainable) == set(grads_j)
    fwd = clip_tasks.make_forward(cfg, hcfg, train=True)

    def loss_t(mb, g):
        logits, _ = fwd(model, mb["image"], None, g)
        return losses.focal_loss(logits, mb["label"])

    mb_t = {"image": torch.from_numpy(imgs), "label": torch.from_numpy(labels)}
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


def _tiny_backbone(tmp_path, family, seed=0):
    """The JAX package's --debug_tiny tree of ``family``, written as the
    backbone checkpoint the CLIs load."""
    cfg = jax_clip.clip_config(family)
    vis = dataclasses.replace(cfg.vision, image_size=32, width=96, depth=4, heads=4, proj_dim=64)
    kw = dict(width=96, depth=2, heads=4, embed_dim=64)
    if cfg.text_kind == "bert":
        kw["intermediate"] = 192
    cfg = cfg.replace(vision=vis, text=dataclasses.replace(cfg.text, **kw))
    p = jax_clip.clip_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.1 * rng.standard_normal(np.shape(a))),
                              jnp.float32), p)
    path = str(tmp_path / f"{family}_backbone.npz")
    jax_ckpt.save(path, p)
    return path


def test_retrieval_cli_matches_jax(tmp_path, monkeypatch, offline):
    from nextgen_uia_tpu.tasks.biomedclip import retrieval as jax_cli
    from nextgen_uia_tpu_torch.tasks.biomedclip import retrieval as port_cli

    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=21, img_size=40)
    monkeypatch.chdir(tmp_path)
    argv = ["--csv", csv, "--img_dir", img_dir, "--debug_tiny", "--img_size", "32",
            "--batch_size", "8", "--compute_dtype", "float32", "--num_workers", "2",
            "--device", "cpu", "--backbone_ckpt", _tiny_backbone(tmp_path, "biomedclip"),
            "--save_features", "--k_values", "1", "5"]
    want = jax_cli.main(argv + ["--output_dir", "jax_out"])
    got = port_cli.main(argv + ["--output_dir", "port_out"])
    assert list(got) == list(want) == ["i2t_r1", "i2t_r5", "i2t_medr", "i2t_meanr", "t2i_r1",
                                       "t2i_r5", "t2i_medr", "t2i_meanr", "rsum"]
    assert got == want
    assert open("port_out/results.csv").read() == open("jax_out/results.csv").read()
    ours, theirs = np.load("port_out/features.npz"), np.load("jax_out/features.npz")
    for k in ("image_features", "text_features"):
        assert ours[k].shape == (21, 64)
        np.testing.assert_allclose(ours[k], theirs[k], atol=2e-5, rtol=0)


@pytest.fixture()
def synth(tmp_path, monkeypatch):
    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=32)
    monkeypatch.chdir(tmp_path)
    return str(root)


def _cpu(*extra):
    return ["--debug_tiny", "--img_size", "32", "--device", "cpu", "--compute_dtype",
            "float32", "--num_workers", "2", *extra]


def test_unimedclip_zero_shot_and_clip_predict_run(synth, tmp_path, offline):
    from nextgen_uia_tpu_torch.tasks.clip import predict
    from nextgen_uia_tpu_torch.tasks.unimedclip import zero_shot

    stats = zero_shot.main(_cpu("--data_root", synth, "--batch_size", "5"))
    assert {"acc", "auc", "loss"} <= set(stats) and np.isfinite(stats["loss"])
    assert glob.glob(str(tmp_path / "runs" / "unimedclip_zero_shot" / "BUSI" / "test" /
                         "*acc*" / "results.csv"))
    # predict's default task: zero-shot over the images, the prompt classes as names
    out = predict.main(_cpu("--images", str(tmp_path / "data" / "all" / "images"),
                            "--batch_size", "5"))
    lines = open(f"{out['out']}/predictions.csv").read().splitlines()
    assert lines[0] == "path,pred,status,prob_benign,prob_malignant" and len(lines) == 13
    assert all(line.split(",")[1] in ("benign", "malignant") for line in lines[1:])
    # --export writes the program and its weights beside the predictions
    out = predict.main(_cpu("--images", synth, "--export", "f.pt2"))
    assert os.path.getsize(os.path.join(out["out"], "f.pt2.params.npz")) > 0
    assert os.path.getsize(os.path.join(out["out"], "f.pt2")) > 0


def test_clip_classification_writes_the_hidden_head(synth, tmp_path):
    from nextgen_uia_tpu_torch.tasks.clip import classification

    stats = classification.main(_cpu("--data_root", synth, "--exp", "ocls", "--epochs", "1",
                                     "--val_interval", "1", "--batch_size", "4",
                                     "--no-strong_augs", "--no-weak_augs"))
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["acc"])
    best = tmp_path / "runs" / "ocls" / "BUSI" / "train" / "best_model.npz"
    keys = set(ckpt.peek_keys(str(best)))
    assert {f"params/head/cls_head/{fc}/{t}" for fc in ("fc1", "fc2") for t in "wb"} <= keys
    # it loads into the JAX package's trainable tree of the same CLI
    args = jax_common.base_parser("t").parse_args(["--debug_tiny", "--img_size", "32"])
    _, _, params = jax_tasks._build_supervised(args, "openai", "cls", jax.random.key(0))
    trainable, _ = jax_partition(params, jax_by_keywords("head", "mona", "lora"))
    _, n = jax_ckpt.load_into(str(best), {"params": trainable})
    assert n == len(keys) == len(jax_flatten(trainable))


def test_finetune_chains_zero_shot(synth, tmp_path):
    from nextgen_uia_tpu_torch.tasks.clip import finetune

    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=24, img_size=32)
    out = finetune.main(_cpu("--method", "mona", "--exp", "ftz", "--batch_size", "8",
                             "--accumulation_steps", "2", "--epochs", "1", "--finetune_csvs",
                             csv, "--finetune_img_dirs", img_dir, "--data_root", synth,
                             "--chain_zero_shot", "BUSI"))
    assert math.isfinite(out["best_val_loss"])
    log = open(glob.glob(str(tmp_path / "runs" / "ftz_zero_shot" / "BUSI" / "test" / "*acc*" /
                             "log.log"))[0]).read()
    assert "mona_weights='runs/ftz/best_model.npz'" in log
    # the chained run injects the CLI's variant into the 4 tiny blocks and loads the
    # 20 MONA tensors of each from the fine-tune's best_model.npz
    assert "Injected noise_aware MONA into 4 blocks" in log
    assert "Loaded 80 MONA tensors from runs/ftz/best_model.npz" in log
