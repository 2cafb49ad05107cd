"""The port's contrastive fine-tune against the JAX package, on the CPU.

(a) ``info_nce`` and ``trim_token_padding`` equal to the JAX ones (1e-6
relative); (b) ``TrainStep`` with gradient accumulation, the global-norm
clip, a skipped non-finite microbatch and an update whose microbatches were
all skipped, against ``make_train_step`` + optax on a toy loss; (c) three
updates of the tiny OpenAI CLIP LoRA fine-tune step (accumulation 2, clip
1.0, cached text features, one microbatch made non-finite) and one
``--method mona`` update, against the JAX step: losses, gradient norms and
the trained tensors after the updates within 1e-4 relative (the key
biases, whose gradient is zero up to rounding, within the lr-sized steps
AdamW makes of it; dropout off on both sides: the mha test holds the LoRA
dropout to the JAX masks); (d) the
fine-tune CLI with ``--debug_tiny --device cpu``: its best_model.npz holds
only LoRA tensors and loads into the JAX package's tree, the in-step text
path gives the cached path's validation loss, and ``--resume`` continues;
(e) what is not ported (multi-device training) refuses, naming its
ROADMAP item; (f) three
updates of the tiny BiomedCLIP MONA fine-tune step (the BERT text tower's
features cached, or encoded in the step from trimmed tokens) against the
JAX step, 1e-4 relative, and the BiomedCLIP fine-tune CLI with
``--debug_tiny --device cpu``: its best_model.npz holds only MONA tensors
(LoRA tensors with ``--method lora``, in-step text).
"""

import dataclasses
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX optimizer under make_optimizer)
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.adapters import lora as jax_lora
from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.adapters.lora import inject_lora
from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
from synth_data import make_finetune_csv


def test_info_nce_and_trim_token_padding_match_jax():
    rng = np.random.default_rng(0)
    img, txt = rng.standard_normal((2, 6, 16)).astype(np.float32)
    for t in (0.07, 1.0):
        want = float(jax_losses.info_nce(jnp.asarray(img), jnp.asarray(txt), temperature=t))
        got = float(losses.info_nce(torch.from_numpy(img), torch.from_numpy(txt), temperature=t))
        assert math.isclose(got, want, rel_tol=1e-6)
    toks = np.zeros((3, 77), np.int32)
    toks[0, :5], toks[1, :40], toks[2, :2] = 7, 9, 3
    toks[1, 20] = 0  # the BPE's real id 0 inside a caption
    for tokens in (toks, toks[:, :20], np.zeros((2, 77), np.int32)):
        for kw in ({}, {"enabled": False}, {"multiple": 16}):
            np.testing.assert_array_equal(ft.trim_token_padding(tokens, **kw),
                                          jax_ft.trim_token_padding(tokens, **kw))


def test_accumulation_clip_and_skips_match_optax():
    """Two microbatches per update, clip 0.5: update 2 keeps one of its two
    microbatches, update 3 none (params, moments and the schedule stay)."""
    cfg = T.TrainConfig(lr=5e-2, lr_min=1e-4, weight_decay=0.05, beta1=0.8, beta2=0.95,
                        total_updates=6)
    jcfg = jax_train.TrainConfig(**dataclasses.asdict(cfg), grad_clip=0.5, accum_steps=2)
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    xs = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(5)]
    xs[1][0, 0, 0] = np.nan
    xs[2][:, 1, 1] = np.inf

    def loss_j(tp, frozen, mb, rng_):
        return jnp.sum(mb["x"] * tp["w"] ** 2) + jnp.sum(jnp.sin(3 * tp["w"]))

    opt_j, _ = jax_train.make_optimizer(jcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jcfg, donate=False)
    state = jax_train.init_state({"w": jnp.asarray(w0)}, opt_j)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    step = T.TrainStep(lambda mb, g: (mb["x"] * w ** 2).sum() + torch.sin(3 * w).sum(),
                       T.make_optimizer([w], cfg), cfg, accum_steps=2, grad_clip=0.5)
    for i, x in enumerate(xs):
        state, m_j = step_j(state, None, {"x": jnp.asarray(x)}, jax.random.key(0))
        before = w.detach().clone()
        m_t = step({"x": torch.from_numpy(x)})
        assert m_t["skipped"] == int(m_j["skipped"]) == {1: 1, 2: 2}.get(i, 0)
        assert math.isclose(m_t["loss"], float(m_j["loss"]), rel_tol=1e-5, abs_tol=1e-6)
        if i != 2:
            assert math.isclose(m_t["grad_norm"], float(m_j["grad_norm"]), rel_tol=1e-5)
        else:
            assert torch.equal(w.detach(), before)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(state["params"]["w"]),
                                   rtol=1e-5, atol=1e-6)
    assert step.applied == 4
    with pytest.raises(ValueError, match="accum_steps"):
        step({"x": torch.zeros(3, 3, 4)})


def _tiny(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=32, width=96, depth=2, heads=4, proj_dim=64)
    return cfg.replace(vision=vis, text=dataclasses.replace(cfg.text, width=96, depth=1,
                                                            heads=4, embed_dim=64))


def _batches(n_updates, nan_at=None, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_updates):
        b = {"image": rng.integers(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8),
             "txt_feat": rng.standard_normal((2, 4, 64)).astype(np.float32)}
        if i == nan_at:
            b["txt_feat"][1, 2, 5] = np.nan
        out.append(b)
    return out


@pytest.mark.parametrize("method", ["lora", "mona"])
def test_finetune_steps_match_jax(tmp_path, monkeypatch, method):
    monkeypatch.setattr(jax_mona, "dropout", lambda rng, x, rate: x)
    jcfg = _tiny(jax_clip.clip_config("openai", mona_variant="noise_aware", lora_dropout=0.0))
    params = jax_clip.clip_init(jax.random.key(1), jcfg)
    rng = np.random.default_rng(2)
    if method == "lora":
        params["visual"], _ = jax_lora.inject_lora(jax.random.key(2), params["visual"], dim=96,
                                                   r=4)
        for blk in params["visual"]["blocks"]:
            for t in "qkvo":
                blk["attn"]["lora"][t]["b"] = jnp.asarray(
                    0.05 * rng.standard_normal((4, 96)), jnp.float32)
        pred_j = jax_ft._lora_trainable_predicate(params)
    else:
        params["visual"], _ = jax_mona.inject_mona(jax.random.key(2), params["visual"], dim=96,
                                                   variant="noise_aware")
        for blk in params["visual"]["blocks"]:
            blk["mona"]["gamma"] = jnp.asarray(0.5 * rng.standard_normal(96), jnp.float32)
        pred_j = jax_by_keywords("mona")
    jax_ckpt.save(str(tmp_path / "clip.npz"), params)
    trainable_j, frozen_j = jax_partition(params, pred_j)

    def loss_j(tp, fz, mb, key):
        img, _ = jax_clip.encode_image(jax_merge(tp, fz), jcfg,
                                       mb["image"].astype(jnp.float32) / 255.0, rng=key)
        return jax_losses.info_nce(img, mb["txt_feat"], temperature=0.07)

    n_updates = 3 if method == "lora" else 1
    tkw = dict(lr=1e-3, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
               total_updates=10)
    jtcfg = jax_train.TrainConfig(**tkw, grad_clip=1.0, accum_steps=2)
    opt_j, _ = jax_train.make_optimizer(jtcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jtcfg, donate=False)
    state = jax_train.init_state(trainable_j, opt_j)
    batches = _batches(n_updates, nan_at=1 if method == "lora" else None)
    metrics_j = []
    for i, b in enumerate(batches):
        state, m = step_j(state, frozen_j, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(i))
        metrics_j.append((float(m["loss"]), float(m["grad_norm"]), int(m["skipped"])))

    cfg = _tiny(clip_mod.clip_config("openai", mona_variant="noise_aware", lora_dropout=0.0))
    gen = torch.Generator().manual_seed(0)
    model = clip_mod.clip_init(gen, cfg)
    if method == "lora":
        inject_lora(gen, model.visual, dim=96, r=4)
        pred = ft.lora_trainable_predicate(model)
    else:
        inject_mona(gen, model.visual, dim=96, variant="noise_aware")
        pred = by_keywords("mona")
    _, n = ckpt.load_into(str(tmp_path / "clip.npz"), model)
    assert n == len(model.state_dict())
    trainable, _ = partition(model, pred)
    assert set(trainable) == {k for k, _ in jax_flatten(trainable_j)}

    def loss_t(mb, g):
        img, _ = clip_mod.encode_image(model, cfg, mb["image"].float() / 255.0, gen=g)
        return losses.info_nce(img, mb["txt_feat"], temperature=0.07)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tkw)),
                       T.TrainConfig(**tkw), accum_steps=2, grad_clip=1.0)
    for b, (loss, norm, skipped) in zip(batches, metrics_j):
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        assert m["skipped"] == skipped
        assert math.isclose(m["loss"], loss, rel_tol=1e-4)
        assert math.isclose(m["grad_norm"], norm, rel_tol=1e-4)
    assert metrics_j[-1][1] > 1.0 or method == "mona"  # the clip was in force
    want = dict(jax_flatten(state["params"]))
    start = dict(jax_flatten(trainable_j))
    for path, prm in trainable.items():
        w, got = np.asarray(want[path]), prm.detach().numpy()
        if path.endswith("/attn/k/b"):
            # softmax ignores a constant added to every key's score, so the
            # key bias's gradient is zero up to rounding, which AdamW scales
            # to steps of up to lr on either side: both stay within them
            for t in (w, got):
                assert np.abs(t - np.asarray(start[path])).max() <= 1.01 * n_updates * 1e-3
            continue
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max() + 1e-8, path


@pytest.fixture()
def ftdata(tmp_path, monkeypatch):
    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=24, img_size=32)
    monkeypatch.chdir(tmp_path)
    return csv, img_dir


def _argv(ftdata, exp, *extra):
    csv, img_dir = ftdata
    return ["--exp", exp, "--method", "lora", "--debug_tiny", "--img_size", "32",
            "--batch_size", "8", "--accumulation_steps", "2", "--epochs", "1", "--device", "cpu",
            "--compute_dtype", "float32", "--num_workers", "2", "--finetune_csvs", csv,
            "--finetune_img_dirs", img_dir, *extra]


def test_finetune_cli_writes_what_the_jax_package_reads(ftdata, tmp_path):
    from nextgen_uia_tpu_torch.tasks.clip.finetune import main

    out = main(_argv(ftdata, "ft_cached"))
    assert np.isfinite(out["best_val_loss"]) and out["best_epoch"] == 0
    best = tmp_path / "runs" / "ft_cached" / "best_model.npz"
    saved = ckpt.load_flat(str(best))
    assert len(saved) == 4 * 4 * 2 and all("/attn/lora/" in k for k in saved)

    # the JAX package's --debug_tiny OpenAI tree with LoRA loads every tensor
    jcfg = jax_clip.clip_config("openai")
    jcfg = jcfg.replace(
        vision=dataclasses.replace(jcfg.vision, image_size=32, width=96, depth=4, heads=4,
                                   proj_dim=64),
        text=dataclasses.replace(jcfg.text, width=96, depth=2, heads=4, embed_dim=64))
    params = jax_clip.clip_init(jax.random.key(0), jcfg)
    params["visual"], _ = jax_lora.inject_lora(jax.random.key(1), params["visual"], dim=96)
    loaded, n = jax_ckpt.load_into(str(best), params)
    assert n == len(saved)
    for path, arr in jax_flatten(loaded):
        if path in saved:
            np.testing.assert_array_equal(np.asarray(arr), saved[path])
    assert any(np.abs(v).max() > 0 for k, v in saved.items() if k.endswith("/b"))

    # the in-step text path (through the causal whole-block route) is exact
    uncached = main(_argv(ftdata, "ft_uncached", "--no-cache_text_features"))
    assert math.isclose(uncached["best_val_loss"], out["best_val_loss"], rel_tol=1e-5)

    # --resume continues from last_state.npz: epoch 1 is not replayed (one
    # update per loader batch of 8: 21 training pairs give two)
    _, meta = ckpt.load_train_state(str(tmp_path / "runs" / "ft_cached" / "last_state.npz"))
    assert meta["epoch"] == 1 and meta["applied_count"] == 2
    main(_argv(ftdata, "ft_cached", "--epochs", "2", "--resume"))
    _, meta = ckpt.load_train_state(str(tmp_path / "runs" / "ft_cached" / "last_state.npz"))
    assert meta["epoch"] == 2 and meta["applied_count"] == 4
    log = open(glob.glob(str(tmp_path / "runs" / "ft_cached" / "log.log"))[0]).read()
    assert "Resumed from" in log and "Epoch 1:" not in log

    # a LoRA checkpoint given through --mona_weights is routed to LoRA
    from nextgen_uia_tpu_torch.tasks.common import base_parser, build_clip_model

    args = base_parser("t").parse_args(["--debug_tiny", "--img_size", "32", "--mona_weights",
                                        str(best), "--compute_dtype", "float32"])
    _, model = build_clip_model(args, "openai")
    assert args.lora_weights == str(best) and args.mona_weights is None
    got = dict(model.state_dict())
    for path, arr in saved.items():
        np.testing.assert_array_equal(got[path.replace("/", ".")].numpy(), arr)


def test_finetune_refuses_what_is_not_ported(ftdata):
    from nextgen_uia_tpu_torch.tasks.clip.finetune import main

    base = _argv(ftdata, "ft_refuse")
    # --method full and --tune_text_encoder run (tests/test_torch_full_ft.py);
    # several devices take a torchrun launch of as many processes
    # (tests/test_torch_mesh.py), with them too
    for extra in (["--method", "full", "--n_data", "2"], ["--tune_text_encoder", "--n_data", "2"],
                  ["--n_data", "2"]):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            main(base + extra)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ft.retrieval_main("openai", ["--n_data", "2"])
    # an unknown family: no such model (all four CLIP families are ported)
    with pytest.raises(ValueError, match="Unknown CLIP family"):
        clip_mod.clip_config("clipseg")
    # BiomedCLIP at full size refuses the folded fallback tokenizer
    with pytest.raises(SystemExit, match="FALLBACK|fallback"):
        ft.finetune_main("biomedclip", [a for a in base if a != "--debug_tiny"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([a for a in base if a not in ("--device", "cpu")])
    assert not os.path.exists(os.path.join("runs", "ft_refuse", "best_model.npz"))


def _tiny_biomedclip(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=32, width=96, depth=2, heads=4, proj_dim=64)
    txt = dataclasses.replace(cfg.text, vocab_size=400, width=64, depth=1, heads=2,
                              intermediate=128, context_length=64, embed_dim=64)
    return cfg.replace(vision=vis, text=txt)


@pytest.mark.parametrize("text", ["cached", "in_step"])
def test_biomedclip_mona_updates_match_jax(tmp_path, monkeypatch, text):
    """Three MONA updates (accumulation 2, clip 1.0) of the tiny BiomedCLIP
    step, the frozen BERT tower's features cached through its forward-only
    route or encoded in the step, against the JAX step: the features,
    losses, gradient norms and trained tensors within 1e-4 relative."""
    monkeypatch.setattr(jax_mona, "dropout", lambda rng, x, rate: x)
    jcfg = _tiny_biomedclip(jax_clip.clip_config("biomedclip", mona_variant="freq_enhanced"))
    params = jax_clip.clip_init(jax.random.key(1), jcfg)
    params["visual"], _ = jax_mona.inject_mona(jax.random.key(2), params["visual"], dim=96,
                                               variant="freq_enhanced")
    rng = np.random.default_rng(2)
    for blk in params["visual"]["blocks"]:
        blk["mona"]["gamma"] = jnp.asarray(0.5 * rng.standard_normal(96), jnp.float32)
    jax_ckpt.save(str(tmp_path / "clip.npz"), params)
    trainable_j, frozen_j = jax_partition(params, jax_by_keywords("mona"))

    batches = []
    for _ in range(3):
        tokens = np.zeros((8, 64), np.int32)
        for i, n in enumerate(rng.integers(3, 31, 8)):
            tokens[i, :n] = rng.integers(1, 400, n)
        batches.append({"image": rng.integers(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8),
                        "tokens": ft.trim_token_padding(tokens).reshape(2, 4, -1)})
    assert batches[0]["tokens"].shape == (2, 4, 32)
    if text == "cached":
        enc_j = jax.jit(lambda p, t: jax_clip.encode_text(p, jax_clip.infer_cfg(jcfg), t))
        for b in batches:
            toks = jnp.asarray(b["tokens"].reshape(8, -1))
            b["txt_feat"] = np.array(enc_j(params, toks)).reshape(2, 4, -1)
    step_cfg = jax_clip.infer_cfg(jcfg, vision=False)

    def loss_j(tp, fz, mb, key):
        p = jax_merge(tp, fz)
        img, _ = jax_clip.encode_image(p, jcfg, mb["image"].astype(jnp.float32) / 255.0, rng=key)
        txt = (mb["txt_feat"] if text == "cached"
               else jax_clip.encode_text(p, step_cfg, mb["tokens"]))
        return jax_losses.info_nce(img, txt, temperature=0.07)

    tkw = dict(lr=1e-3, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
               total_updates=10)
    jtcfg = jax_train.TrainConfig(**tkw, grad_clip=1.0, accum_steps=2)
    opt_j, _ = jax_train.make_optimizer(jtcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jtcfg, donate=False)
    state = jax_train.init_state(trainable_j, opt_j)
    metrics_j = []
    for i, b in enumerate(batches):
        state, m = step_j(state, frozen_j, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(i))
        metrics_j.append((float(m["loss"]), float(m["grad_norm"])))

    cfg = _tiny_biomedclip(clip_mod.clip_config("biomedclip", mona_variant="freq_enhanced"))
    gen = torch.Generator().manual_seed(0)
    model = clip_mod.clip_init(gen, cfg)
    inject_mona(gen, model.visual, dim=96, variant="freq_enhanced")
    _, n = ckpt.load_into(str(tmp_path / "clip.npz"), model)
    assert n == len(model.state_dict())
    trainable, _ = partition(model, by_keywords("mona"))
    encode = ft.make_text_encoder(model, cfg, torch.device("cpu"))
    ours = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    if text == "cached":
        for b, mine in zip(batches, ours):
            mine["txt_feat"] = encode(b["tokens"].reshape(8, -1)).reshape(2, 4, -1)
            want = b["txt_feat"]
            assert np.abs(mine["txt_feat"].numpy() - want).max() <= 1e-4 * np.abs(want).max()

    def loss_t(mb, g):
        img, _ = clip_mod.encode_image(model, cfg, mb["image"].float() / 255.0, gen=g)
        txt = mb["txt_feat"] if text == "cached" else encode(mb["tokens"])
        return losses.info_nce(img, txt, temperature=0.07)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tkw)),
                       T.TrainConfig(**tkw), accum_steps=2, grad_clip=1.0)
    for b, (loss, norm) in zip(ours, metrics_j):
        m = step(b)
        assert m["skipped"] == 0
        assert math.isclose(m["loss"], loss, rel_tol=1e-4)
        assert math.isclose(m["grad_norm"], norm, rel_tol=1e-4)
    want = dict(jax_flatten(state["params"]))
    for path, prm in trainable.items():
        w, got = np.asarray(want[path]), prm.detach().numpy()
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max() + 1e-8, path


@pytest.mark.parametrize("method", ["mona", "lora"])
def test_biomedclip_finetune_cli_saves_adapter_only(ftdata, tmp_path, method):
    """--method mona with the text cache, --method lora with in-step text:
    best_model.npz holds only the method's tensors, of every block."""
    from nextgen_uia_tpu_torch.tasks.biomedclip.finetune import main

    extra = [] if method == "mona" else ["--no-cache_text_features"]
    out = main([a if a != "lora" else method for a in _argv(ftdata, "bm")] + extra)
    assert np.isfinite(out["best_val_loss"]) and out["best_epoch"] == 0
    saved = ckpt.load_flat(str(tmp_path / "runs" / "bm" / "best_model.npz"))
    assert len(saved) > 0 and all(f"/{method}/" in k for k in saved)
    assert {k.split("/")[2] for k in saved} == {"0", "1", "2", "3"}  # every --debug_tiny block
    log = open(tmp_path / "runs" / "bm" / "log.log").read()
    assert ("freq_enhanced MONA" in log and "Cached text features" in log if method == "mona"
            else "Injected LoRA" in log and "Cached text features" not in log)
