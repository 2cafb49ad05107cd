"""The port's BERT text tower (PubMedBERT, BiomedCLIP) against the JAX
package, on the CPU, at a toy size (width 128, 2 heads, intermediate 512,
depth 2, 40-48 tokens with real padding); inputs from numpy with a seed.

(a) The four post-norm kernels' plain versions against the JAX Pallas
kernels (interpret mode), float32, max|d| <= 2e-5 * max|ref|: K5 raw-x
(``fused_ln_qkv`` with ``ln=None``), K6 with the post-LN epilogue, K9
(``fused_postnorm_mlp_ln``) and K1 post-norm (``fused_block_infer``
``layout="postnorm"``); the key-padding bias leaves one batch row wholly
padded, which must come out finite. (b) ``bert_apply``, by the three-kernel
chain and by the whole-layer route (``NEXTGEN_UIA_FUSED_BLOCK_BERT=1``;
the JAX side under ``NEXTGEN_UIA_FUSED_BLOCK=force``), against the JAX
``bert_apply`` through the .npz bridge, max|d| <= 1e-4 * max|ref|; the
bridge round-trips the text/... paths both ways; trimming the padding gives
the same features; the ``mlp_impl='xla'`` layer (weights that train)
against JAX's. (c) ``BertTokenizer`` on a synthetic vocabulary, the
folded CLIP-BPE fallback and ``trim_token_padding`` equal to the JAX
package's.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.data.tokenizer import BertTokenizer as JaxBertTokenizer
from nextgen_uia_tpu.models import bert as jax_bert
from nextgen_uia_tpu.ops.fused_attn_o import fused_attn_o_residual as jax_attn_o
from nextgen_uia_tpu.ops.fused_block import fused_block_infer as jax_block
from nextgen_uia_tpu.ops.fused_ln_mlp import fused_postnorm_mlp_ln as jax_postnorm_mlp
from nextgen_uia_tpu.ops.fused_ln_qkv import fused_ln_qkv as jax_ln_qkv
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.data.tokenizer import BertTokenizer
from nextgen_uia_tpu_torch.models import bert
from nextgen_uia_tpu_torch.ops import PLAIN, fused_attn_o, fused_block, fused_ln_mlp
from nextgen_uia_tpu_torch.ops import fused_ln_qkv
from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
from nextgen_uia_tpu_torch.tasks import common

B, N, D, H, HIDDEN = 3, 40, 128, 2, 512
DH = D // H
EPS = 1e-12


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, rel * scale)


def _layer(seed):
    """A port BertLayer with perturbed LayerNorms, and its JAX dict."""
    gen = torch.Generator().manual_seed(seed)
    cfg = bert.BertConfig(width=D, heads=H, intermediate=HIDDEN)
    layer = bert.BertLayer(gen, cfg)
    with torch.no_grad():
        for ln in (layer.attn_ln, layer.ffn_ln):
            ln.scale.add_(0.2 * torch.randn(D, generator=gen))
            ln.bias.add_(0.2 * torch.randn(D, generator=gen))

    def tree(m):
        return {k: jnp.asarray(v.numpy()) for k, v in m.named_parameters()}

    return layer, {"attn": {k: tree(getattr(layer.attn, k)) for k in "qkvo"},
                   "attn_ln": tree(layer.attn_ln), "ffn_ln": tree(layer.ffn_ln),
                   "ffn": {k: tree(getattr(layer.ffn, k)) for k in ("fc1", "fc2")}}


def _pad_bias(rng):
    """[B, N] key-padding bias: 31 real keys, all N, and none (a row whose
    keys are all padding, as a zero row of a padded cache chunk)."""
    mask = np.zeros((B, N), np.float32)
    mask[0, :31], mask[1, :] = 1.0, 1.0
    return (1.0 - mask) * -1e9


@pytest.mark.parametrize("kernel", ["k5_rawx", "k6_postln", "k9", "k1_postnorm"])
def test_plain_versions_match_jax_kernels(kernel):
    layer, jp = _layer(1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    bias = _pad_bias(rng)
    tx, tbias = torch.from_numpy(x), torch.from_numpy(bias)
    with torch.no_grad():
        if kernel == "k5_rawx":
            want = jax_ln_qkv(jnp.asarray(x), None, jp["attn"], heads=H)
            got = fused_ln_qkv.fused_ln_qkv(tx, None, layer.attn, heads=H)
        elif kernel == "k6_postln":
            q, k, v = (rng.standard_normal((B, H, N, DH)).astype(np.float32) for _ in range(3))
            want = jax_attn_o(*map(jnp.asarray, (q, k, v, x)), jp["attn"]["o"], heads=H,
                              bias=jnp.asarray(bias), post_ln=jp["attn_ln"], ln_eps=EPS)
            got = fused_attn_o.fused_attn_o_residual(
                *map(torch.from_numpy, (q, k, v)), tx, layer.attn.o, heads=H, bias=tbias,
                post_ln=layer.attn_ln, ln_eps=EPS)
        elif kernel == "k9":
            want = jax_postnorm_mlp(jnp.asarray(x), jp["ffn"], jp["ffn_ln"], act="gelu",
                                    eps=EPS)
            got = fused_ln_mlp.fused_postnorm_mlp_ln(tx, layer.ffn, layer.ffn_ln, act="gelu",
                                                     eps=EPS)
        else:
            want = jax_block(jnp.asarray(x), jp, heads=H, act="gelu", eps=EPS,
                             key_bias=jnp.asarray(bias), layout="postnorm")
            got = fused_block.fused_block_infer(tx, layer, heads=H, act="gelu", eps=EPS,
                                                key_bias=tbias, layout="postnorm")
    assert want is not None  # the JAX kernel took the shape
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        _close(g.numpy(), w, 2e-5)


def _towers(tmp_path, seed=3, vocab=1000):
    """(JAX BERT tree and config, the port's tower with its weights loaded
    through the .npz bridge, the port's config)."""
    kw = dict(vocab_size=vocab, width=D, heads=H, intermediate=HIDDEN, depth=2,
              context_length=64, embed_dim=64)
    jcfg = jax_bert.BertConfig(**kw)
    p = jax_bert.bert_init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    for layer in p["layers"]:
        for ln in ("attn_ln", "ffn_ln"):
            layer[ln]["scale"] = jnp.asarray(1 + 0.2 * rng.standard_normal(D), jnp.float32)
            layer[ln]["bias"] = jnp.asarray(0.2 * rng.standard_normal(D), jnp.float32)
    jax_ckpt.save(str(tmp_path / "bert.npz"), p)
    cfg = bert.BertConfig(**kw)
    tower = bert.bert_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.load_into(str(tmp_path / "bert.npz"), tower)
    assert n == len(tower.state_dict()) == len(jax_flatten(p))
    return p, jcfg, tower, cfg


def _ids(vocab, lengths=(5, 29, 48), ctx=48, seed=4):
    ids = np.zeros((len(lengths), ctx), np.int32)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, vocab, n)
    ids[1, 2] = vocab + 40  # outside the vocabulary: clamped
    return ids


@pytest.mark.parametrize("route", ["chain", "whole_layer"])
def test_bert_apply_matches_jax(tmp_path, monkeypatch, route):
    p, jcfg, tower, cfg = _towers(tmp_path)
    ids = _ids(cfg.vocab_size)
    if route == "whole_layer":
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_BLOCK", "force")  # the JAX K1 on the CPU
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_BLOCK_BERT", "1")
        jcfg = dataclasses.replace(jcfg, block_impl="fused_infer")
        cfg = dataclasses.replace(cfg, block_impl="fused_infer")
    want = np.asarray(jax_bert.bert_apply(p, jcfg, jnp.asarray(ids)))

    calls = []
    monkeypatch.setattr(fused_block, "fused_block_infer_plain",
                        lambda *a, **k: calls.append(k["layout"]) or PLAIN.fused_block_infer(
                            *a, **k))
    with torch.no_grad():
        got = bert.bert_apply(tower, cfg, torch.from_numpy(ids))
        plain = bert.bert_apply(tower, cfg, torch.from_numpy(ids), ops=PLAIN)
    assert got.shape == (3, 64)
    assert calls == (["postnorm"] * 2 if route == "whole_layer" else [])
    _close(got.numpy(), want, 1e-4)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())

    # padding trimmed to the 32-token bucket: the same features
    short = ft.trim_token_padding(ids[:2])
    assert short.shape == (2, 32)
    with torch.no_grad():
        trimmed = bert.bert_apply(tower, cfg, torch.from_numpy(short))
    np.testing.assert_allclose(trimmed.numpy(), got[:2].numpy(), atol=1e-5, rtol=1e-5)


def test_bridge_round_trips_the_text_tower(tmp_path):
    p, _, tower, _ = _towers(tmp_path)
    with torch.no_grad():
        for t in tower.parameters():
            t.mul_(1.5)
    n = ckpt.save(str(tmp_path / "port.npz"), tower)
    back, n_back = jax_ckpt.load_into(str(tmp_path / "port.npz"), p)
    assert n == n_back == len(jax_flatten(p))
    flat = dict(tower.state_dict())
    for path, arr in jax_flatten(back):
        np.testing.assert_array_equal(np.asarray(arr), flat[path.replace("/", ".")].numpy())


def test_bert_refuses_what_is_not_ported(tmp_path):
    """Training the tower's own weights (--method full, ``mlp_impl='xla'``)
    is ported: the plain layer against the JAX one, max|d| <= 1e-4 *
    max|ref|; an unknown ``mlp_impl`` refuses. LoRA in its layers runs
    (tests/test_torch_text_lora.py)."""
    p, jcfg, tower, cfg = _towers(tmp_path)
    ids = _ids(cfg.vocab_size)
    want = np.asarray(jax_bert.bert_apply(p, dataclasses.replace(jcfg, mlp_impl="xla"),
                                          jnp.asarray(ids)))
    with torch.no_grad():
        got = bert.bert_apply(tower, dataclasses.replace(cfg, mlp_impl="xla"),
                              torch.from_numpy(ids)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="mlp_impl"):
        bert.bert_apply(tower, dataclasses.replace(cfg, mlp_impl="fused"), torch.from_numpy(ids))


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", ",", "(", ")", "-", "_", "the", "a", "of",
         "lesion", "ultra", "##sound", "##s", "hypo", "##echo", "##ic", "mass", "breast",
         "cyst", "benign", "malign", "##ant", "1", "2", "##3", "mm", "shadow", "##ing"]


def test_tokenizers_match_jax(monkeypatch):
    texts = ["Ultrasound of a hypoechoic breast lesion.", "MALIGNANT mass (12.3 mm), shadowing",
             "benign cysts, unknownword", "", "the_lesion-a", "lesion " * 300]
    ours, theirs = BertTokenizer(VOCAB), JaxBertTokenizer(VOCAB)
    for ctx in (None, 8):
        got, want = ours(texts, ctx), theirs(texts, ctx)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    got = ours(texts)
    assert got.shape == (len(texts), 256) and (got[:, 0] == 2).all()
    assert got[-1, 255] == 3 and got[3, 2] == 0  # truncated with [SEP] last; padding

    # the folded CLIP-BPE fallback (no HuggingFace files cached here)
    monkeypatch.setattr(jax_common, "load_hf_tokenizer", lambda *a, **k: None)
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    mine = common.get_text_tokenizer(None, "biomedclip")
    ref = jax_common.get_text_tokenizer(None, "biomedclip")
    assert mine.is_fallback and ref.is_fallback
    for ctx in (256, 20):
        np.testing.assert_array_equal(mine(texts, ctx), ref(texts, ctx))
    assert mine(texts).max() < 30522 and mine(texts).shape == (len(texts), 256)

    args = argparse.Namespace(debug_tiny=False)
    with pytest.raises(SystemExit, match="fallback"):
        common.require_real_tokenizer(args, mine, "biomedclip")
    common.require_real_tokenizer(argparse.Namespace(debug_tiny=True), mine, "biomedclip")
    monkeypatch.setenv("NEXTGEN_UIA_ALLOW_TOKENIZER_FALLBACK", "1")
    common.require_real_tokenizer(args, mine, "biomedclip")


def test_trim_token_padding_matches_jax_on_bert_batches():
    toks = BertTokenizer(VOCAB)(["lesion", "benign breast cyst , " * 12, "mass"], 256)
    for kw in ({}, {"enabled": False}, {"multiple": 16}):
        np.testing.assert_array_equal(ft.trim_token_padding(toks, **kw),
                                      jax_ft.trim_token_padding(toks, **kw))
    assert ft.trim_token_padding(toks).shape == (3, 64)
