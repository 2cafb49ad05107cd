"""``--method full`` (the towers' own weights train) and the CLIP text
tower's composed route, the port against the JAX package on the CPU.

Float32 inputs from a numpy seed, JAX weights carried across through the
``.npz`` bridge. (a) ``mha``'s flash-attention route (q/k/v products, K7's
plain version, the o-projection) and its einsum route, with a key bias and
the causal mask, against the JAX ``mha``: the output and the gradients of x
and of every projection within 2e-5 * max|ref|; (b) the ViT block under
``mlp_impl='xla'`` (gelu, and quick_gelu with LayerScale), the BERT tower
and the CLIP text tower (frozen composed route and trained route) alike;
(c) three AdamW updates (accumulation 2, clip 1.0) of the tiny fine-tune
step at ``--method full``, BiomedCLIP and the OpenAI layout, with and
without ``--tune_text_encoder`` (text cached through the forward-only
route, or encoded in the step and trained), against the JAX step: losses
and gradient norms within 1e-4 relative, the first update's clipped
gradients within 1e-4 * max|g| of each tensor, the change of the trained
tensors over the three updates within 1e-3 relative L2; (d) the ``clip.finetune`` CLI with no ``--method``
(and with ``--tune_text_encoder``, and ``--method mona
--tune_text_encoder``) at ``--debug_tiny`` from a converted checkpoint: its
best_model.npz holds the whole model (only MONA tensors under mona) and
loads into the JAX package's tree with no missing or extra key.
"""

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import bert as jax_bert
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models import text_clip as jax_text
from nextgen_uia_tpu.models import vit as jax_vit
from nextgen_uia_tpu.nn.attention import mha as jax_mha
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.convert import torch_to_npz as C
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import partition
from nextgen_uia_tpu_torch.models import bert, text_clip, vit
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.nn.attention import Attention, mha
from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
from synth_data import make_finetune_csv

TOL = 2e-5


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: max|d| {err:.3e}"


def _load(flat_tree, module):
    """JAX tree -> the port's module through the flat path names."""
    flat = {k: np.asarray(v) for k, v in jax_flatten(flat_tree)}
    _, n = ckpt.merge_flat(flat, module)
    assert n == len(flat) == len(module.state_dict())


def _grads(module):
    return {k.replace(".", "/"): p.grad.numpy() for k, p in module.named_parameters()}


def _is_key_bias(path):
    """The attention key bias adds q . b_k to every score of a row, which
    the softmax removes: its exact gradient is zero, so both packages give
    rounding noise, held to the tolerance times the largest gradient of
    all the tensors."""
    return path.endswith("k/b")


def _check_grads(got, want, tol=TOL):
    """Every gradient of ``got`` within ``tol`` * its own max|ref| in ``want``
    (flat path -> array dicts; the key biases: ``tol`` * the largest of
    all)."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(want) == set(got)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        if _is_key_bias(k):
            assert float(np.abs(got[k] - w).max()) <= tol * top, k
        else:
            _close(got[k], w, k, tol)


@pytest.mark.parametrize("impl,causal,bias", [("flash", False, True), ("flash", True, False),
                                              ("einsum", True, True)])
def test_mha_routes_for_trained_weights_match_jax(impl, causal, bias):
    d, heads, b, n = 64, 4, 3, 21
    rng = np.random.default_rng(0)
    w = {t: {"w": jnp.asarray(rng.standard_normal((d, d)) / 8, jnp.float32),
             "b": jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)} for t in "qkvo"}
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    kb = None
    if bias:
        kb = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
        kb[1, -6:] = -1e9

    def jax_fn(pp, xx):
        return jax_mha(pp, xx, num_heads=heads, causal=causal,
                       key_padding_bias=None if kb is None else jnp.asarray(kb))

    want, vjp = jax.vjp(jax.jit(jax_fn), w, jnp.asarray(x))
    gw, gx = vjp(jnp.asarray(g))
    p = Attention(torch.Generator().manual_seed(0), d)
    _load(w, p)
    p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mha(p, xt, num_heads=heads, causal=causal, impl=impl,
              key_padding_bias=None if kb is None else torch.from_numpy(kb))
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want, "output")
    _close(xt.grad, gx, "dx")
    _check_grads(_grads(p), dict(jax_flatten(gw)))


@pytest.mark.parametrize("act,layerscale", [("gelu", False), ("quick_gelu", True)])
def test_vit_block_full_route_matches_jax(act, layerscale):
    jcfg = jax_vit.ViTConfig(width=64, heads=4, depth=1, act=act, mlp_impl="xla", ln_eps=1e-6)
    p = jax_vit._block_init(jax.random.key(3), jcfg)
    rng = np.random.default_rng(4)
    p["ln1"]["scale"] = jnp.asarray(1 + 0.2 * rng.standard_normal(64), jnp.float32)
    if layerscale:
        p["ls1"], p["ls2"] = (jnp.asarray(rng.uniform(0.5, 1.5, 64), jnp.float32)
                              for _ in range(2))
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    g = rng.standard_normal((3, 17, 64)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda pp, xx: jax_vit.block_apply(pp, xx, jcfg)), p,
                        jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))

    cfg = vit.ViTConfig(width=64, heads=4, depth=1, act=act, mlp_impl="xla", ln_eps=1e-6,
                        block_impl="fused_infer")  # the full route at either block_impl
    blk = vit.Block(torch.Generator().manual_seed(0), cfg,
                    layerscale=1.0 if layerscale else None)
    _load(p, blk)
    blk.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vit.block_apply(blk, xt, cfg)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want, "block output")
    _close(xt.grad, gx, "dx")
    _check_grads(_grads(blk), dict(jax_flatten(gp)))


def test_bert_full_route_matches_jax():
    kw = dict(vocab_size=300, width=64, heads=2, intermediate=128, depth=2, context_length=24,
              embed_dim=32)
    jcfg = jax_bert.BertConfig(**kw, mlp_impl="xla")
    p = jax_bert.bert_init(jax.random.key(5), jcfg)
    ids = np.zeros((3, 24), np.int32)
    rng = np.random.default_rng(6)
    for i, n in enumerate((4, 17, 24)):
        ids[i, :n] = rng.integers(1, 300, n)
    want, grads = jax.jit(jax.value_and_grad(
        lambda pp: jnp.sum(jax_bert.bert_apply(pp, jcfg, jnp.asarray(ids)) ** 2)))(p)

    cfg = bert.BertConfig(**kw, mlp_impl="xla")
    tower = bert.bert_init(torch.Generator().manual_seed(0), cfg)
    _load(p, tower)
    tower.requires_grad_(True)
    got = (bert.bert_apply(tower, cfg, torch.from_numpy(ids)) ** 2).sum()
    got.backward()
    assert math.isclose(got.item(), float(want), rel_tol=1e-5)
    _check_grads(_grads(tower), dict(jax_flatten(grads)))


@pytest.mark.parametrize("mlp_impl", ["auto", "xla"])
def test_text_tower_composed_route_matches_jax(mlp_impl):
    """The frozen composed route ('auto') forward, the trained one ('xla')
    with every gradient."""
    kw = dict(vocab_size=200, width=64, heads=2, depth=2, embed_dim=32, context_length=16)
    jcfg = jax_text.TextConfig(**kw, mlp_impl=mlp_impl)
    p = jax_text.text_init(jax.random.key(8), jcfg)
    ids = np.zeros((3, 16), np.int32)
    rng = np.random.default_rng(9)
    for i, n in enumerate((3, 11, 16)):
        ids[i, :n] = rng.integers(1, 199, n)
        ids[i, n - 1] = 199
    want, grads = jax.jit(jax.value_and_grad(
        lambda pp: jnp.sum(jax_text.text_apply(pp, jcfg, jnp.asarray(ids)) ** 2)))(p)

    cfg = text_clip.TextConfig(**kw, mlp_impl=mlp_impl)
    tower = text_clip.text_init(torch.Generator().manual_seed(0), cfg)
    _load(p, tower)
    tower.requires_grad_(mlp_impl == "xla")
    got = (text_clip.text_apply(tower, cfg, torch.from_numpy(ids)) ** 2).sum()
    assert math.isclose(got.item(), float(want), rel_tol=1e-5)
    if mlp_impl == "xla":
        got.backward()
        _check_grads(_grads(tower), dict(jax_flatten(grads)))


def _tiny(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=32, width=64, depth=2, heads=2, proj_dim=32)
    if cfg.text_kind == "bert":
        txt = dataclasses.replace(cfg.text, vocab_size=300, width=64, depth=1, heads=2,
                                  intermediate=128, context_length=32, embed_dim=32)
    else:
        txt = dataclasses.replace(cfg.text, vocab_size=300, width=64, depth=1, heads=2,
                                  context_length=32, embed_dim=32)
    return cfg.replace(vision=vis, text=txt)


def _batches(family, n_updates, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_updates):
        tokens = np.zeros((8, 32), np.int32)
        for i, n in enumerate(rng.integers(3, 32, 8)):
            tokens[i, :n] = rng.integers(1, 299, n)
            if family != "biomedclip":
                tokens[i, n - 1] = 299  # EOT: the largest id
        out.append({"image": rng.integers(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8),
                    "tokens": tokens.reshape(2, 4, 32)})
    return out


@pytest.mark.parametrize("family", ["biomedclip", "openai"])
@pytest.mark.parametrize("tune_text", [False, True])
def test_full_updates_match_jax(tmp_path, family, tune_text):
    args = argparse.Namespace(tune_layers="all", tune_text_encoder=tune_text)
    jcfg = _tiny(jax_clip.clip_config(family))
    jcfg = jcfg.replace(vision=dataclasses.replace(jcfg.vision, mlp_impl="xla"),
                        text=dataclasses.replace(jcfg.text, mlp_impl="xla"))
    params = jax_clip.clip_init(jax.random.key(1), jcfg)
    jax_ckpt.save(str(tmp_path / "clip.npz"), params)
    trainable_j, frozen_j = jax_partition(params, jax_ft._full_ft_predicate(args, depth=2))
    batches = _batches(family, 3, seed=2)
    eval_cfg = jax_clip.infer_cfg(jcfg)
    if not tune_text:  # the cache: the text tower forward only
        enc = jax.jit(lambda p, t: jax_clip.encode_text(p, eval_cfg, t))
        for b in batches:
            b["txt_feat"] = np.array(enc(params, jnp.asarray(b["tokens"].reshape(8, -1)))
                                     ).reshape(2, 4, -1)

    def loss_j(tp, fz, mb, key):
        p = jax_merge(tp, fz)
        img, _ = jax_clip.encode_image(p, jcfg, mb["image"].astype(jnp.float32) / 255.0)
        txt = (jax_clip.encode_text(p, jcfg, mb["tokens"]) if tune_text else mb["txt_feat"])
        return jax_losses.info_nce(img, txt, temperature=0.07)

    tkw = dict(lr=1e-3, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
               total_updates=10)
    jtcfg = jax_train.TrainConfig(**tkw, grad_clip=1.0, accum_steps=2)
    opt_j, _ = jax_train.make_optimizer(jtcfg)
    step_j = jax_train.make_train_step(loss_j, opt_j, jtcfg, donate=False)
    state = jax_train.init_state(trainable_j, opt_j)
    # the first update's gradient: the mean over microbatches, clipped to 1.0
    grad_j = jax.jit(jax.grad(loss_j))
    mb_grads = [grad_j(trainable_j, frozen_j, {k: v[i] for k, v in batches[0].items()}, None)
                for i in range(2)]
    g_mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *mb_grads)
    norm = float(jnp.sqrt(sum(jnp.sum(v ** 2) for _, v in jax_flatten(g_mean))))
    g_first = {k: np.asarray(v) * min(1.0, 1.0 / norm) for k, v in jax_flatten(g_mean)}
    metrics_j = []
    for i, b in enumerate(batches):
        state, m = step_j(state, frozen_j, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(i))
        metrics_j.append((float(m["loss"]), float(m["grad_norm"])))
    assert math.isclose(metrics_j[0][1], norm, rel_tol=1e-5)

    cfg = _tiny(clip_mod.clip_config(family))
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, mlp_impl="xla"),
                      text=dataclasses.replace(cfg.text, mlp_impl="xla"))
    model = clip_mod.clip_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.load_into(str(tmp_path / "clip.npz"), model)
    assert n == len(model.state_dict())
    trainable, _ = partition(model, ft.full_ft_predicate(args, depth=2))
    assert set(trainable) == {k for k, _ in jax_flatten(trainable_j)}
    assert "logit_scale" not in trainable
    assert any(k.startswith("text/") for k in trainable) == tune_text
    ours = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    if not tune_text:
        encode = ft.make_text_encoder(model, cfg, torch.device("cpu"))
        for mine, b in zip(ours, batches):
            mine["txt_feat"] = encode(b["tokens"].reshape(8, -1)).reshape(2, 4, -1)
            _close(mine["txt_feat"], b["txt_feat"], "cached text features", 1e-4)

    def loss_t(mb, g):
        img, _ = clip_mod.encode_image(model, cfg, mb["image"].float() / 255.0, gen=g)
        txt = (clip_mod.encode_text(model, cfg, mb["tokens"]) if tune_text
               else mb["txt_feat"])
        return losses.info_nce(img, txt, temperature=0.07)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tkw)),
                       T.TrainConfig(**tkw), accum_steps=2, grad_clip=1.0)
    for i, (b, (loss, norm)) in enumerate(zip(ours, metrics_j)):
        m = step(b)
        assert m["skipped"] == 0
        assert math.isclose(m["loss"], loss, rel_tol=1e-4)
        assert math.isclose(m["grad_norm"], norm, rel_tol=1e-4)
        if i == 0:
            _check_grads({k: prm.grad.numpy() for k, prm in trainable.items()}, g_first, 1e-4)
    # the three updates' change of every trained tensor: AdamW divides each
    # element's gradient by its own scale, so an element whose gradient is
    # rounding noise (a key bias, an embedding row read once) can step
    # anywhere within lr; held as one vector, relative L2
    want, start = dict(jax_flatten(state["params"])), dict(jax_flatten(trainable_j))
    d_port, d_jax = (np.concatenate([(np.asarray(src[k]) - np.asarray(start[k])).ravel()
                                     for k in trainable])
                     for src in ({k: p.detach().numpy() for k, p in trainable.items()}, want))
    rel = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
    assert rel <= 1e-3, rel


def _openai_sd(rng, *, width, depth, text_width, text_depth, vocab, ctx, embed, img, patch):
    """An OpenAI-layout state dict (the reference's key names) of the given
    sizes, seeded."""
    def t(*shape):
        return torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32))

    sd = {"visual.conv1.weight": t(width, 3, patch, patch), "visual.class_embedding": t(width),
          "visual.positional_embedding": t((img // patch) ** 2 + 1, width),
          "visual.proj": t(width, embed), "token_embedding.weight": t(vocab, text_width),
          "positional_embedding": t(ctx, text_width), "text_projection": t(text_width, embed),
          "logit_scale": torch.tensor(math.log(1 / 0.07))}
    for name, d in (("visual.ln_pre", width), ("visual.ln_post", width),
                    ("ln_final", text_width)):
        sd[name + ".weight"], sd[name + ".bias"] = 1 + t(d), t(d)
    for prefix, d, n in (("visual.transformer.", width, depth),
                         ("transformer.", text_width, text_depth)):
        for i in range(n):
            b = f"{prefix}resblocks.{i}."
            sd[b + "attn.in_proj_weight"], sd[b + "attn.in_proj_bias"] = t(3 * d, d), t(3 * d)
            sd[b + "attn.out_proj.weight"], sd[b + "attn.out_proj.bias"] = t(d, d), t(d)
            for ln in ("ln_1", "ln_2"):
                sd[b + ln + ".weight"], sd[b + ln + ".bias"] = 1 + t(d), t(d)
            sd[b + "mlp.c_fc.weight"], sd[b + "mlp.c_fc.bias"] = t(4 * d, d), t(4 * d)
            sd[b + "mlp.c_proj.weight"], sd[b + "mlp.c_proj.bias"] = t(d, 4 * d), t(d)
    return sd


@pytest.mark.parametrize("extra", [[], ["--tune_text_encoder"],
                                   ["--method", "mona", "--tune_text_encoder"]])
def test_full_finetune_cli_writes_the_whole_model(tmp_path, monkeypatch, extra):
    from nextgen_uia_tpu_torch.tasks.clip.finetune import main

    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=24, img_size=32)
    monkeypatch.chdir(tmp_path)
    # the --debug_tiny OpenAI towers' sizes, converted from the reference layout
    sd = _openai_sd(np.random.default_rng(0), width=96, depth=4, text_width=96, text_depth=2,
                    vocab=49408, ctx=77, embed=64, img=32, patch=16)
    np.savez(tmp_path / "converted.npz", **C.convert_openai_clip(sd, depth=4, text_depth=2))
    out = main(["--exp", "full", "--debug_tiny", "--img_size", "32", "--batch_size", "8",
                "--accumulation_steps", "2", "--epochs", "1", "--device", "cpu",
                "--compute_dtype", "float32", "--num_workers", "2", "--finetune_csvs", csv,
                "--finetune_img_dirs", img_dir, "--ckpt", str(tmp_path / "converted.npz"),
                *extra])
    assert np.isfinite(out["best_val_loss"]) and out["best_epoch"] == 0
    run = tmp_path / "runs" / "full"
    log = (run / "log.log").read_text()
    conv = ckpt.load_flat(str(tmp_path / "converted.npz"))
    assert f"Loaded {len(conv)} backbone tensors" in log
    saved = ckpt.load_flat(str(run / "best_model.npz"))
    if "mona" in extra:
        assert saved and all("/mona/" in k for k in saved)
        assert "Adjusted learning rate" not in log
        return
    assert "Adjusted learning rate to 1e-06 for full fine-tuning" in log
    jcfg = jax_clip.clip_config("openai")
    jcfg = jcfg.replace(
        vision=dataclasses.replace(jcfg.vision, image_size=32, width=96, depth=4, heads=4,
                                   proj_dim=64),
        text=dataclasses.replace(jcfg.text, width=96, depth=2, heads=4, embed_dim=64))
    params = jax_clip.clip_init(jax.random.key(0), jcfg)
    assert sorted(saved) == sorted(k for k, _ in jax_flatten(params))
    loaded, n = jax_ckpt.load_into(str(run / "best_model.npz"), params)
    assert n == len(saved)
    for path, arr in jax_flatten(loaded):
        np.testing.assert_array_equal(np.asarray(arr), saved[path])
    # the image tower trained (lr 1e-6), the text tower only when tuned
    moved = [k for k in conv if not np.array_equal(conv[k], saved[k])]
    assert any(k.startswith("visual/") for k in moved) and "logit_scale" not in moved
    assert any(k.startswith("text/") for k in moved) == ("--tune_text_encoder" in extra)
