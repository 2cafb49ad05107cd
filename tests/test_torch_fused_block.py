"""The port's whole-block forward (nextgen_uia_tpu_torch/ops/fused_block.py)
against the JAX package's fused_block_infer, run as its own tests run it on
the CPU (Pallas in interpret mode), and against its _xla_reference.

On a CPU tensor the port's wrapper runs its plain version; the CUDA kernels
are compared with that plain version on the card (test_torch_kernels_gpu.py).
Tolerance: atol = rtol = 2e-5 in float32, the JAX package's own bar for the
kernel against the composed path (tests/test_fused_block.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.models.vit import ViTConfig as JaxViTConfig
from nextgen_uia_tpu.models.vit import _block_init
from nextgen_uia_tpu.ops import fused_block as jax_fb
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import fused_block as fb

WIDTH, HEADS = 128, 2
TOL = dict(atol=2e-5, rtol=2e-5)


def _blocks(tmp_path, seed, act="gelu"):
    """(JAX block tree, the same weights in the port's Block); LN params and
    biases made non-trivial from numpy so a fusion bug cannot hide."""
    cfg = JaxViTConfig(width=WIDTH, heads=HEADS, act=act)
    p = _block_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    for ln in ("ln1", "ln2"):
        p[ln]["scale"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(WIDTH), jnp.float32)
        p[ln]["bias"] = jnp.asarray(0.1 * rng.standard_normal(WIDTH), jnp.float32)
    jax_ckpt.save(str(tmp_path / "block.npz"), p)
    blk = Block(torch.Generator().manual_seed(seed), ViTConfig(width=WIDTH, heads=HEADS))
    ckpt.load_into(str(tmp_path / "block.npz"), blk)
    return p, blk


def _port(x, blk, **kw):
    with torch.no_grad():
        return fb.fused_block_infer(torch.from_numpy(np.asarray(x)), blk, heads=HEADS,
                                    **kw).numpy()


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_matches_jax_kernel(tmp_path, act):
    p, blk = _blocks(tmp_path, 0, act)
    x = np.random.default_rng(1).standard_normal((2, 16, WIDTH)).astype(np.float32)
    want = jax_fb.fused_block_infer(jnp.asarray(x), p, heads=HEADS, act=act, eps=1e-6)
    assert want is not None  # the JAX kernel took the shape
    got = _port(x, blk, act=act, eps=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_unpadded_matches_padded_jax_kernel(tmp_path):
    """The JAX kernel pads N=13 to 16 with a -1e9 key bias and n_real; the
    port runs the 13 real tokens unpadded, and also takes the padded form."""
    p, blk = _blocks(tmp_path, 2)
    n, n_real = 16, 13
    x = np.random.default_rng(3).standard_normal((2, n, WIDTH)).astype(np.float32)
    bias = np.zeros((2, n), np.float32)
    bias[:, n_real:] = -1e9
    want = np.asarray(jax_fb.fused_block_infer(jnp.asarray(x), p, heads=HEADS,
                                               key_bias=jnp.asarray(bias), n_real=n_real))
    np.testing.assert_allclose(_port(x[:, :n_real], blk), want[:, :n_real], **TOL)
    padded = _port(x, blk, key_bias=torch.from_numpy(bias), n_real=n_real)
    np.testing.assert_allclose(padded[:, :n_real], want[:, :n_real], **TOL)


def test_key_bias_matches_xla_reference(tmp_path):
    """A general (not only -inf-like) key bias and n_real < N, against the
    JAX package's plain recomposition _xla_reference."""
    p, blk = _blocks(tmp_path, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, WIDTH)).astype(np.float32)
    bias = rng.standard_normal((3, 11)).astype(np.float32)
    a, m = p["attn"], p["mlp"]
    want = jax_fb._xla_reference(
        jnp.asarray(x), p["ln1"]["scale"], p["ln1"]["bias"], a["q"]["w"], a["q"]["b"],
        a["k"]["w"], a["k"]["b"], a["v"]["w"], a["v"]["b"], a["o"]["w"], a["o"]["b"],
        p["ln2"]["scale"], p["ln2"]["bias"], m["fc1"]["w"], m["fc1"]["b"], m["fc2"]["w"],
        m["fc2"]["b"], jnp.asarray(bias), heads=HEADS, n_real=9, causal=False,
        act="gelu", eps=1e-5, prenorm=True)
    got = _port(x, blk, key_bias=torch.from_numpy(bias), n_real=9)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bf16_rounding_points_follow_the_reference(tmp_path):
    """bfloat16 input: the plain version rounds where _xla_reference does."""
    p, blk = _blocks(tmp_path, 6)
    x = np.random.default_rng(7).standard_normal((2, 16, WIDTH)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    a, m = p["attn"], p["mlp"]
    cast = lambda w: w.astype(jnp.bfloat16)  # noqa: E731 - the JAX wrapper's weight cast
    ref = jax_fb._xla_reference(
        xb, p["ln1"]["scale"], p["ln1"]["bias"], cast(a["q"]["w"]), a["q"]["b"],
        cast(a["k"]["w"]), a["k"]["b"], cast(a["v"]["w"]), a["v"]["b"], cast(a["o"]["w"]),
        a["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"], cast(m["fc1"]["w"]), m["fc1"]["b"],
        cast(m["fc2"]["w"]), m["fc2"]["b"], None, heads=HEADS, n_real=16, causal=False,
        act="gelu", eps=1e-5, prenorm=True)
    with torch.no_grad():
        got = fb.fused_block_infer(torch.from_numpy(x).to(torch.bfloat16), blk, heads=HEADS)
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    # one bf16 ulp at the output's scale: the two frameworks may round a
    # float32 value that sits on a bf16 tie boundary differently
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref32).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref32, atol=ulp, rtol=0)


def test_unported_layouts_and_devices_raise(tmp_path):
    _, blk = _blocks(tmp_path, 8)
    x = torch.zeros(1, 4, WIDTH)
    with pytest.raises(ValueError, match="layout"):
        fb.fused_block_infer(x, blk, heads=HEADS, layout="sandwich")
    with pytest.raises(ValueError, match="activation"):
        fb.fused_block_infer(x, blk, heads=HEADS, act="relu")
    with pytest.raises(ValueError, match="device"):
        fb.fused_block_infer(x.to("meta"), blk, heads=HEADS)
    launches = fb.fused_block_infer.launches
    fb.fused_block_infer(x, blk, heads=HEADS)
    assert fb.fused_block_infer.launches == launches  # the CPU path launches nothing
