"""The port's CLIP text side against the JAX package, on the CPU.

(a) ``ClipTokenizer``: equal ids to the JAX one on the captions of
tests/synth_data.py::make_finetune_csv, some prompts, punctuation runs,
HTML entities, non-ASCII text and an over-length caption (truncated with
EOT last); (b) the embedding's clamp of ids outside the vocabulary; (c) K1
with the causal mask: the port's plain version against the JAX
``fused_block_infer(causal=True)`` (Pallas, interpret mode), with and
without a key bias, max|d| <= 2e-5 (atol = rtol); (d) the tiny text tower
(depth 2, 77 tokens) through the forward-only route against the JAX
``text_apply``, through the JAX whole-block kernel under
NEXTGEN_UIA_FUSED_BLOCK=force (77 tokens padded to 80 there, unpadded
here) at head dim 64 and through the JAX composed route at the
--debug_tiny head dim 24, <= 2e-5; the composed routes (``block_impl
'auto'``, frozen and at ``mlp_impl='xla'``) against JAX's alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.data.tokenizer import ClipTokenizer as JaxClipTokenizer
from nextgen_uia_tpu.models import text_clip as jax_text
from nextgen_uia_tpu.models.vit import ViTConfig as JaxViTConfig
from nextgen_uia_tpu.models.vit import _block_init
from nextgen_uia_tpu.nn.layers import embedding as jax_embedding
from nextgen_uia_tpu.ops import fused_block as jax_fb
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.data.tokenizer import ClipTokenizer
from nextgen_uia_tpu_torch.models import text_clip
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.nn.layers import Embedding, embedding
from nextgen_uia_tpu_torch.ops import fused_block as fb
from synth_data import make_finetune_csv

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def tokenizers():
    return ClipTokenizer(), JaxClipTokenizer()


def test_tokenizer_matches_jax(tmp_path, tokenizers):
    ours, theirs = tokenizers
    csv, _ = make_finetune_csv(tmp_path, n=12, img_size=8)
    captions = [line.split(",", 1)[1] for line in open(csv).read().splitlines()[1:]]
    prompts = ["a photo of a benign breast lesion.", "an ultrasound image of a malignant tumor",
               "Wow!!! it's  <b>bold</b> &amp; &lt;odd&gt; -- 12.5 mm;", "Ünïcödé café naïve 3µm",
               "!!!!", "", "  leading and trailing   spaces  "]
    long = " ".join(f"word{i} lesion margin" for i in range(60))  # > 77 tokens
    texts = captions + prompts + [long]
    got, want = ours(texts), theirs(texts)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == ours.eot and (got[-1] != 0).all()  # truncated with EOT last
    np.testing.assert_array_equal(ours(texts[:3], context_length=20),
                                  theirs(texts[:3], context_length=20))


def test_embedding_clamps_ids_outside_the_vocabulary():
    emb = Embedding(torch.Generator().manual_seed(0), 10, 4)
    ids = np.array([[0, 3, 9, 10, 57, -2]], np.int32)
    want = jax_embedding({"w": jnp.asarray(emb.w.numpy())}, jnp.asarray(ids))
    got = embedding(emb, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_pair(tmp_path, seed, width, heads):
    cfg = JaxViTConfig(width=width, heads=heads, act="quick_gelu")
    p = _block_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    for ln in ("ln1", "ln2"):
        p[ln]["scale"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(width), jnp.float32)
        p[ln]["bias"] = jnp.asarray(0.1 * rng.standard_normal(width), jnp.float32)
    jax_ckpt.save(str(tmp_path / "block.npz"), p)
    blk = Block(torch.Generator().manual_seed(seed), ViTConfig(width=width, heads=heads))
    ckpt.load_into(str(tmp_path / "block.npz"), blk)
    return p, blk


@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_block_plain_matches_jax_kernel(tmp_path, with_bias):
    p, blk = _block_pair(tmp_path, 3, 128, 2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 128)).astype(np.float32)
    bias = rng.standard_normal((2, 24)).astype(np.float32) if with_bias else None
    want = jax_fb.fused_block_infer(jnp.asarray(x), p, heads=2, act="quick_gelu", causal=True,
                                    key_bias=None if bias is None else jnp.asarray(bias))
    assert want is not None  # the JAX kernel took the shape
    with torch.no_grad():
        got = fb.fused_block_infer(torch.from_numpy(x), blk, heads=2, act="quick_gelu",
                                   causal=True,
                                   key_bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the first row sees only itself: changing later rows leaves it alone
    x2 = x.copy()
    x2[:, 1:] += 1.0
    with torch.no_grad():
        got2 = fb.fused_block_infer(torch.from_numpy(x2), blk, heads=2, act="quick_gelu",
                                    causal=True)
        got1 = fb.fused_block_infer(torch.from_numpy(x), blk, heads=2, act="quick_gelu",
                                    causal=True)
    np.testing.assert_array_equal(got1[:, 0].numpy(), got2[:, 0].numpy())


@pytest.mark.parametrize("width,heads,fused", [(128, 2, True), (96, 4, False)])
def test_text_tower_matches_jax(tmp_path, monkeypatch, width, heads, fused):
    """The tiny text tower: JAX's whole-block kernel (head dim 64, 77 tokens
    padded to 80) or its composed route (the --debug_tiny head dim 24,
    which the JAX kernel declines) against the port's forward-only route."""
    jcfg = jax_text.TextConfig(vocab_size=300, width=width, heads=heads, depth=2, embed_dim=64)
    p = jax_text.text_init(jax.random.key(7), jcfg)
    rng = np.random.default_rng(8)
    for blk in p["blocks"]:
        for ln in ("ln1", "ln2"):
            blk[ln]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(width), jnp.float32)
    jax_ckpt.save(str(tmp_path / "text.npz"), p)
    ids = np.zeros((3, 77), np.int32)
    for i, n in enumerate((5, 40, 77)):
        ids[i, :n] = rng.integers(1, 299, n)
        ids[i, n - 1] = 299  # EOT: the largest id
    ids[1, 3] = 350  # outside the vocabulary: clamped
    if fused:
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_BLOCK", "force")
        jcfg = dataclasses.replace(jcfg, block_impl="fused_infer")
    want = jax_text.text_apply(p, jcfg, jnp.asarray(ids))

    cfg = text_clip.TextConfig(vocab_size=300, width=width, heads=heads, depth=2, embed_dim=64,
                               block_impl="fused_infer")
    tower = text_clip.text_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.load_into(str(tmp_path / "text.npz"), tower)
    assert n == len(tower.state_dict())
    with torch.no_grad():
        got = text_clip.text_apply(tower, cfg, torch.from_numpy(ids))
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # the composed routes, frozen ('auto') and trained ('xla'), against JAX's
    for mlp_impl in ("auto", "xla"):
        want = jax_text.text_apply(
            p, dataclasses.replace(jcfg, block_impl="auto", mlp_impl=mlp_impl), jnp.asarray(ids))
        with torch.no_grad():
            got = text_clip.text_apply(
                tower, dataclasses.replace(cfg, block_impl="auto", mlp_impl=mlp_impl),
                torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
