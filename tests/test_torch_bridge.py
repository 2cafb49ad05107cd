"""Weight bridge between the JAX package and its PyTorch port.

A parameter tree built by the JAX package (CLIP towers, the BERT text tower
included, + MONA + PyramidHead) is saved with nextgen_uia_tpu.core.checkpoint, merged into the port's
modules with nextgen_uia_tpu_torch.core.checkpoint, saved again by the port
and read back by the JAX package: every key and array must survive bit for
bit, in both directions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.adapters.mona import inject_mona as jax_inject_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.partition import flatten_with_paths
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models.heads import PyramidHeadConfig as JaxHeadConfig
from nextgen_uia_tpu.models.heads import pyramid_head_init as jax_head_init
from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init

WIDTH, DEPTH, HEADS, IMG = 128, 4, 2, 64


def _shrink(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=IMG, width=WIDTH, depth=DEPTH,
                              heads=HEADS, proj_dim=64)
    txt = dataclasses.replace(cfg.text, width=64, depth=1, heads=2, intermediate=128,
                              embed_dim=64)
    return cfg.replace(vision=vis, text=txt)


def _jax_cfg(variant="hybrid"):
    return _shrink(jax_clip.clip_config("biomedclip", mona_variant=variant))


def _jax_tree(task="seg", variant="hybrid", seed=0):
    """{'backbone': CLIP tree with MONA in every block, 'head': PyramidHead}."""
    key = jax.random.key(seed)
    params = jax_clip.clip_init(jax.random.fold_in(key, 1), _jax_cfg(variant))
    params["visual"], _ = jax_inject_mona(jax.random.fold_in(key, 2), params["visual"],
                                          dim=WIDTH, variant=variant)
    head = jax_head_init(jax.random.fold_in(key, 3),
                         JaxHeadConfig(feature_dim=WIDTH, img_size=IMG, task=task))
    return {"backbone": params, "head": head}


def _port_model(task="seg", variant="hybrid", seed=5):
    """The port's counterpart of _jax_tree (its own random init)."""
    gen = torch.Generator().manual_seed(seed)
    backbone = clip_mod.clip_init(gen, _shrink(clip_mod.clip_config("biomedclip",
                                                                    mona_variant=variant)))
    inject_mona(gen, backbone.visual, dim=WIDTH, variant=variant)
    head = pyramid_head_init(gen, PyramidHeadConfig(feature_dim=WIDTH, img_size=IMG,
                                                    task=task))
    return torch.nn.ModuleDict({"backbone": backbone, "head": head})


@pytest.mark.parametrize("task,variant", [("seg", "hybrid"), ("cls", "noise_aware"),
                                          ("seg", "freq_enhanced"), ("cls", "baseline")])
def test_jax_to_port_to_jax_bit_exact(tmp_path, task, variant):
    tree = _jax_tree(task, variant)
    n_jax = jax_ckpt.save(str(tmp_path / "jax.npz"), tree)
    model = _port_model(task, variant)
    _, n = ckpt.load_into(str(tmp_path / "jax.npz"), model)
    assert n == n_jax == len(model.state_dict())

    assert ckpt.save(str(tmp_path / "port.npz"), model) == n_jax
    want = jax_ckpt.load_flat(str(tmp_path / "jax.npz"))
    got = jax_ckpt.load_flat(str(tmp_path / "port.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k

    # and the JAX package loads the port's file into its own tree
    back, n_back = jax_ckpt.load_into(str(tmp_path / "port.npz"), tree)
    assert n_back == n_jax
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p


def test_keys_outside_the_port_are_ignored(tmp_path):
    """A JAX CLIP file with a key the port's tree lacks merges by name:
    every vision, text and logit_scale tensor loads, the extra key is
    skipped."""
    tree = _jax_tree()
    flat = dict(flatten_with_paths(tree["backbone"]))
    np.savez(tmp_path / "clip.npz", **{k: np.asarray(v) for k, v in flat.items()},
             **{"text/pooler/w": np.zeros((64, 64), np.float32)})
    model = _port_model()
    _, n = ckpt.load_into(str(tmp_path / "clip.npz"), model["backbone"])
    assert n == len(model["backbone"].state_dict()) == len(flat)
    w = jax_ckpt.load_flat(str(tmp_path / "clip.npz"))["visual/blocks/2/attn/q/w"]
    assert np.array_equal(model["backbone"].visual.blocks[2].attn.q.w.numpy(), w)
    w = jax_ckpt.load_flat(str(tmp_path / "clip.npz"))["text/layers/0/ffn/fc1/w"]
    assert np.array_equal(model["backbone"].text.layers[0].ffn.fc1.w.numpy(), w)


def test_state_dict_keys_are_jax_paths():
    model = _port_model()
    flat = dict(flatten_with_paths(_jax_tree()))
    keys = {k.replace(".", "/") for k in model.state_dict()}
    assert keys == set(flat)


def test_shape_mismatch_raises(tmp_path):
    np.savez(tmp_path / "bad.npz", **{"head/reduces/0/w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="Shape mismatch") as e:
        ckpt.load_into(str(tmp_path / "bad.npz"), _port_model())
    assert not isinstance(e.value, ckpt.NoMatch)


def test_empty_intersection_raises_nomatch(tmp_path):
    np.savez(tmp_path / "other.npz", **{"not/a/param": np.zeros(2, np.float32)})
    with pytest.raises(ckpt.NoMatch):
        ckpt.load_into(str(tmp_path / "other.npz"), _port_model())
    assert ckpt.peek_keys(str(tmp_path / "other.npz")) == ["not/a/param"]


def test_skip_and_keyword_filter(tmp_path):
    tree = _jax_tree()
    jax_ckpt.save(str(tmp_path / "jax.npz"), tree)
    model = _port_model()
    before = model["head"].reduces[0].w.clone()
    _, n = ckpt.load_into(str(tmp_path / "jax.npz"), model, skip=("head/",))
    assert torch.equal(model["head"].reduces[0].w, before)
    assert n == len([k for k in model.state_dict() if not k.startswith("head.")])
    n_mona = ckpt.save(str(tmp_path / "mona.npz"), model, keyword_filter=["mona"])
    keys = ckpt.peek_keys(str(tmp_path / "mona.npz"))
    assert len(keys) == n_mona > 0 and all("/mona/" in k for k in keys)
