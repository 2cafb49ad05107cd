"""``--tune_text_encoder`` (BiomedCLIP LoRA in both towers) and K4, the port
against the JAX package on the CPU, at toy sizes; inputs from numpy with a
seed.

(a) The plain versions of K10's backward (``fused_mlp_backward_plain``), K5
raw-x's backward (``fused_ln_qkv_rawx_backward_plain``) and K4
(``dwconv7_per_sample``, forward, dx and dk) against ``jax.vjp`` of the JAX
Pallas functions in interpret mode, and the port's autograd through the
same ops on CPU tensors, max|d| <= 2e-5 * max(1, max|ref|). (b) The
post-norm epilogues' backwards (K6 post-LN: dq, dk, dv, dx; K9: dx) against
JAX's ``_bwd_rule`` and ``_postnorm_bwd_rule``, through
``_frozen.plain_backward``, the recomposition the card runs. (c) ``mha``'s
post-norm LoRA route (no LayerNorm, ``residual=x``, the key-padding bias)
against the JAX ``mha`` with the JAX dropout masks. (d) ``inject_lora_bert``
against the JAX one, and the ``.npz`` bridge of ``text/layers/i/attn/lora/``.
(e) Three AdamW updates (accumulation 2, clip 1.0) of a tiny BiomedCLIP
with LoRA in both towers, the text encoded in the step (text depth 2, LoRA
in 2 and in 1 of its layers: the layer above the LoRA runs the chain's
backwards), float32, against the JAX step: losses, gradient norms and the
trained tensors within 1e-4 relative (the key biases, whose gradient is
zero up to rounding, within the lr-sized steps AdamW makes of them; dropout
off on both sides: (c) holds the dropout to the JAX masks). (f) The
BiomedCLIP fine-tune CLI with ``--tune_text_encoder`` writes an adapter-only
best_model.npz: with ``--method lora`` both towers' LoRA tensors, which the
JAX package's tree loads; with ``--method mona`` the MONA tensors, the text
uncached.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lora import _jax_attention, _jax_masks, _port_attention

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.adapters import lora as jax_lora
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import bert as jax_bert
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.nn import attention as jax_attn
from nextgen_uia_tpu.ops.dwconv import dwconv7_per_sample as jax_dwconv7
from nextgen_uia_tpu.ops.fused_attn_o import fused_attn_o_residual as jax_attn_o
from nextgen_uia_tpu.ops.fused_ln_mlp import fused_postnorm_mlp_ln as jax_postnorm_mlp
from nextgen_uia_tpu.ops.fused_ln_qkv import fused_ln_qkv as jax_ln_qkv
from nextgen_uia_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.adapters.lora import inject_lora, inject_lora_bert
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import partition
from nextgen_uia_tpu_torch.models import bert
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.nn.attention import mha
from nextgen_uia_tpu_torch.ops import _frozen, dwconv, fused_attn_o, fused_ln_mlp, fused_ln_qkv
from nextgen_uia_tpu_torch.ops import fused_mlp
from nextgen_uia_tpu_torch.tasks import clip_finetune as ft
from synth_data import make_finetune_csv

EPS = 1e-12


def _close(got, want, rel=2e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(1.0, scale), f"max|d| {err:.3e} (max|ref| {scale:.3e})"


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _vjp(fn, inputs, cot):
    """(fn(*inputs), the vjp of fn at inputs applied to cot), traced and
    compiled as one program: eager dispatch compiles every primitive on its
    own, which is most of these tests' time on the CPU."""
    def run(args, c):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(c)

    return jax.jit(run)(jax.tree.map(jnp.asarray, tuple(inputs)), jax.tree.map(jnp.asarray, cot))


def _jax_shapes(fn):
    """The shapes of the JAX parameter tree fn(key0, key1, key2) makes,
    traced, not run: the tests fill it from a checkpoint (running the
    initialisers would compile each of their primitives on the CPU)."""
    return jax.eval_shape(fn, *(jax.random.key(i) for i in range(3)))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_k10_backward_plain_matches_jax(act):
    rng = np.random.default_rng(1)
    m, d, hid = 40, 128, 512
    x, g = (rng.standard_normal((m, d)).astype(np.float32) for _ in range(2))
    w1 = (rng.standard_normal((d, hid)) / math.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((hid, d)) / math.sqrt(hid)).astype(np.float32)
    b1, b2 = (0.1 * rng.standard_normal(n).astype(np.float32) for n in (hid, d))
    jw = [jnp.asarray(t) for t in (w1, b1, w2, b2)]
    out_j, (dx_j,) = _vjp(lambda x_: jax_fused_mlp(x_, *jw, act=act), (x,), g)

    tw = [torch.from_numpy(t) for t in (w1, b1, w2, b2)]
    _close(fused_mlp.fused_mlp_backward_plain(torch.from_numpy(x), tw[0], tw[1], tw[2],
                                              torch.from_numpy(g), act=act), dx_j)
    (xt,) = _leaves(x)
    out = fused_mlp.fused_mlp(xt, *tw, act=act)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), out_j)
    _close(xt.grad, dx_j)
    assert fused_mlp.fused_mlp_backward.launches == 0  # the CPU path launches nothing


def _bert_layer(seed, d=128, heads=2, hidden=512):
    """A port BertLayer with perturbed LayerNorms, and its JAX dict."""
    gen = torch.Generator().manual_seed(seed)
    layer = bert.BertLayer(gen, bert.BertConfig(width=d, heads=heads, intermediate=hidden))
    with torch.no_grad():
        for ln in (layer.attn_ln, layer.ffn_ln):
            ln.scale.add_(0.2 * torch.randn(d, generator=gen))
            ln.bias.add_(0.2 * torch.randn(d, generator=gen))

    def tree(m):
        return {k: jnp.asarray(v.detach().numpy()) for k, v in m.named_parameters()}

    return layer, {"attn": {k: tree(getattr(layer.attn, k)) for k in "qkvo"},
                   "attn_ln": tree(layer.attn_ln), "ffn_ln": tree(layer.ffn_ln),
                   "ffn": {k: tree(getattr(layer.ffn, k)) for k in ("fc1", "fc2")}}


def test_k5_rawx_backward_plain_matches_jax():
    b, n, d, h = 3, 40, 128, 2
    layer, jp = _bert_layer(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    cots = [rng.standard_normal((b, h, n, d // h)).astype(np.float32) for _ in range(3)]
    outs_j, (dx_j,) = _vjp(lambda x_: jax_ln_qkv(x_, None, jp["attn"], heads=h), (x,),
                           tuple(cots))

    w_qkv, _ = fused_ln_qkv._rawx_weights(layer.attn, torch.float32)
    got = fused_ln_qkv.fused_ln_qkv_rawx_backward_plain(
        w_qkv, *map(torch.from_numpy, cots), dtype=torch.float32)
    _close(got, dx_j)
    (xt,) = _leaves(x)
    outs = fused_ln_qkv.fused_ln_qkv(xt, None, layer.attn, heads=h)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for o, w in zip(outs, outs_j):
        _close(o.detach(), w)
    _close(xt.grad, dx_j)
    assert fused_ln_qkv.fused_ln_qkv_rawx_backward.launches == 0


@pytest.mark.parametrize("shape", [(3, 6, 7, 16), (2, 4, 4, 8), (2, 14, 14, 64)])
def test_k4_plain_matches_jax(shape):
    """Forward, dx and dk; (2, 4, 4, 8) is where the TPU kernel pads the
    map to 8 x 8 (MIN_HW), which the port does not copy."""
    rng = np.random.default_rng(sum(shape))
    x, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k = (0.2 * rng.standard_normal((shape[0], 7, 7, shape[3]))).astype(np.float32)
    out_j, (dx_j, dk_j) = _vjp(jax_dwconv7, (x, k), g)

    tx, tk, tg = map(torch.from_numpy, (x, k, g))
    _close(dwconv.dwconv7_per_sample_plain(tx, tk), out_j)
    dx, dk = dwconv.dwconv7_per_sample_backward_plain(tx, tk, tg)
    _close(dx, dx_j)
    _close(dk, dk_j)
    xt, kt = _leaves(x, k)
    out = dwconv.dwconv7_per_sample(xt, kt)
    (out * tg).sum().backward()
    _close(out.detach(), out_j)
    _close(xt.grad, dx_j)
    _close(kt.grad, dk_j)
    assert dwconv.dwconv7_per_sample.launches == dwconv.dwconv7_per_sample_backward.launches == 0


def _pad_bias(b, n):
    """[B, N] key-padding bias: 31 real keys, all N, and none (a row whose
    keys are all padding)."""
    mask = np.zeros((b, n), np.float32)
    mask[0, :31], mask[1, :] = 1.0, 1.0
    return (1.0 - mask) * -1e9


@pytest.mark.parametrize("op", ["k6_postln", "k9"])
def test_postnorm_backwards_match_jax_rules(op):
    """The recomposition ``plain_backward`` differentiates on the card
    (here on CPU tensors, the plain version standing in for the kernel)
    against JAX's ``_bwd_rule`` (post_ln) and ``_postnorm_bwd_rule``."""
    b, n, d, h = 3, 40, 128, 2
    layer, jp = _bert_layer(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    cot = rng.standard_normal((b, n, d)).astype(np.float32)
    bias = _pad_bias(b, n)
    if op == "k6_postln":
        qkv = [rng.standard_normal((b, h, n, d // h)).astype(np.float32) for _ in range(3)]
        inputs = (*qkv, x)

        def fn_j(q, k, v, x_):
            return jax_attn_o(q, k, v, x_, jp["attn"]["o"], heads=h, bias=jnp.asarray(bias),
                              post_ln=jp["attn_ln"], ln_eps=EPS)

        def plain(q, k, v, x_):
            return fused_attn_o.fused_attn_o_residual_plain(
                q, k, v, x_, layer.attn.o, heads=h, bias=torch.from_numpy(bias),
                post_ln=layer.attn_ln, ln_eps=EPS)
    else:
        inputs = (x,)

        def fn_j(x_):
            return jax_postnorm_mlp(x_, jp["ffn"], jp["ffn_ln"], act="gelu", eps=EPS)

        def plain(x_):
            return fused_ln_mlp.fused_postnorm_mlp_ln_plain(x_, layer.ffn, layer.ffn_ln,
                                                            act="gelu", eps=EPS)
    out_j, grads_j = _vjp(fn_j, inputs, cot)

    leaves = _leaves(*inputs)
    out = _frozen.plain_backward(plain, plain, *leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j)
    for leaf, want in zip(leaves, grads_j, strict=True):
        _close(leaf.grad, want)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_mha_postnorm_lora_route_matches_jax(tmp_path, dropout):
    """BERT's call: no LayerNorm, ``residual=x``, the key-padding bias (a
    wholly padded row too); the output and the gradients of x, every LoRA
    pair and the q/k/v/o biases."""
    dim, heads, r, b, n = 128, 2, 4, 3, 40
    p, ln = _jax_attention(7, dim, r)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    kb = _pad_bias(b, n)
    cot = rng.standard_normal((b, n, dim)).astype(np.float32)
    key = jax.random.key(10)

    def f(p_, x_):
        return jax_attn.mha(p_, x_, num_heads=heads, residual=x_,
                            key_padding_bias=jnp.asarray(kb), lora_alpha=32.0,
                            lora_dropout=dropout, lora_rng=key if dropout else None)

    out_j, (gp_j, gx_j) = _vjp(f, (p, x), cot)

    holder = _port_attention(tmp_path, p, ln, dim, r)
    trainable, _ = partition(holder.attn, lambda path: "lora" in path or path.endswith("/b"))
    masks = ({t: torch.from_numpy(m) for t, m in _jax_masks(key, dropout, (b, n, dim)).items()}
             if dropout else None)
    (xt,) = _leaves(x)
    out = mha(holder.attn, xt, num_heads=heads, residual=xt,
              key_padding_bias=torch.from_numpy(kb), lora_alpha=32.0, lora_dropout=dropout,
              lora_masks=masks)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j)
    _close(xt.grad, gx_j)
    want = dict(jax_flatten(gp_j))
    assert len(trainable) == 4 * 2 + 4
    top = max(np.abs(np.asarray(want[path])).max() for path in trainable)
    for path, prm in trainable.items():
        if path == "k/b":
            # softmax removes q . b_k from every score of a row: the exact
            # gradient is zero, both sides give rounding noise, held to the
            # largest gradient's scale
            _close(prm.grad / top, np.asarray(want[path]) / top)
            continue
        _close(prm.grad, want[path])


def test_inject_lora_bert_and_the_bridge(tmp_path):
    kw = dict(vocab_size=300, width=96, depth=3, heads=4, intermediate=192, context_length=32,
              embed_dim=64)
    jp = _jax_shapes(lambda k0, k1, _: jax_lora.inject_lora_bert(
        k1, jax_bert.bert_init(k0, jax_bert.BertConfig(**kw)), dim=96, r=8, num_layers=2)[0])
    nj = sum("lora" in layer["attn"] for layer in jp["layers"])
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda t: rng.standard_normal(t.shape).astype(t.dtype), jp)
    gen = torch.Generator().manual_seed(0)
    tower = bert.bert_init(gen, bert.BertConfig(**kw))
    _, n = inject_lora_bert(gen, tower, dim=96, r=8, num_layers=2)
    assert n == nj == 2 and "lora" not in tower.layers[2].attn._modules
    pair = tower.layers[1].attn.lora.v
    assert pair.a.shape == (96, 8) and pair.b.shape == (8, 96)
    assert pair.a.abs().max() <= 96 ** -0.5 and torch.count_nonzero(pair.b) == 0
    assert {k.replace(".", "/") for k in tower.state_dict()} == {k for k, _ in jax_flatten(jp)}

    # JAX tree -> port, then the port's LoRA tensors (changed) -> JAX
    root = {"text": jp}
    jax_ckpt.save(str(tmp_path / "jax.npz"), root)
    holder = torch.nn.Module()
    holder.text = tower
    _, n = ckpt.load_into(str(tmp_path / "jax.npz"), holder)
    assert n == len(holder.state_dict())
    with torch.no_grad():
        for name, t in holder.named_parameters():
            if "lora" in name:
                t.add_(0.5)
    n = ckpt.save(str(tmp_path / "lora.npz"), holder, keyword_filter=["lora"])
    saved = ckpt.load_flat(str(tmp_path / "lora.npz"))
    assert n == len(saved) == 2 * 4 * 2
    assert all(k.startswith(("text/layers/0/attn/lora/", "text/layers/1/attn/lora/"))
               for k in saved)
    loaded, n_j = jax_ckpt.load_into(str(tmp_path / "lora.npz"), root)
    assert n_j == len(saved)
    for path, arr in jax_flatten(loaded):
        if path in saved:
            np.testing.assert_array_equal(np.asarray(arr), saved[path])


def _tiny_biomedclip(cfg):
    vis = dataclasses.replace(cfg.vision, image_size=32, width=96, depth=2, heads=4, proj_dim=64)
    txt = dataclasses.replace(cfg.text, vocab_size=400, width=64, depth=2, heads=2,
                              intermediate=128, context_length=64, embed_dim=64)
    return cfg.replace(vision=vis, text=txt)


@pytest.mark.parametrize("lora_layers", [2, 1])
def test_tune_text_encoder_updates_match_jax(tmp_path, lora_layers):
    cfg = _tiny_biomedclip(clip_mod.clip_config("biomedclip", lora_dropout=0.0))
    gen = torch.Generator().manual_seed(0)
    model = clip_mod.clip_init(gen, cfg)
    inject_lora(gen, model.visual, dim=96, r=4)
    inject_lora_bert(gen, model.text, dim=64, r=4, num_layers=lora_layers)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if ".lora." in name and name.endswith(".b"):
                prm.copy_(torch.from_numpy(0.05 * rng.standard_normal(prm.shape)))
    n_saved = ckpt.save(str(tmp_path / "clip.npz"), model)

    # the JAX tree of the same shapes, every leaf loaded from the port's
    jcfg = _tiny_biomedclip(jax_clip.clip_config("biomedclip", lora_dropout=0.0))

    def init(k0, k1, k2):
        p = jax_clip.clip_init(k0, jcfg)
        p["visual"], _ = jax_lora.inject_lora(k1, p["visual"], dim=96, r=4)
        p["text"], _ = jax_lora.inject_lora_bert(k2, p["text"], dim=64, r=4,
                                                 num_layers=lora_layers)
        return p

    params, n = jax_ckpt.load_into(str(tmp_path / "clip.npz"), _jax_shapes(init))
    assert n == n_saved == len(jax.tree.leaves(params))
    trainable_j, frozen_j = jax_partition(params, jax_ft._lora_trainable_predicate(params))

    batches = []
    for _ in range(3):
        tokens = np.zeros((8, 64), np.int32)
        for i, n in enumerate(rng.integers(3, 31, 8)):
            tokens[i, :n] = rng.integers(1, 400, n)
        batches.append({"image": rng.integers(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8),
                        "tokens": ft.trim_token_padding(tokens).reshape(2, 4, -1)})

    def loss_j(tp, fz, mb, key):
        p = jax_merge(tp, fz)
        key, txt_key = jax.random.split(key)  # the JAX step's text stream
        img, _ = jax_clip.encode_image(p, jcfg, mb["image"].astype(jnp.float32) / 255.0, rng=key)
        txt = jax_clip.encode_text(p, jcfg, mb["tokens"], rng=txt_key)
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

    trainable, _ = partition(model, ft.lora_trainable_predicate(model))
    assert set(trainable) == {k for k, _ in jax_flatten(trainable_j)}
    assert sum(k.startswith("text/") for k in trainable) == lora_layers * (8 + 4)

    def loss_t(mb, g):
        img, _ = clip_mod.encode_image(model, cfg, mb["image"].float() / 255.0, gen=g)
        txt = clip_mod.encode_text(model, cfg, mb["tokens"], gen=g)
        return losses.info_nce(img, txt, temperature=0.07)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tkw)),
                       T.TrainConfig(**tkw), accum_steps=2, grad_clip=1.0)
    for b, (loss, norm) in zip(batches, metrics_j):
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        assert m["skipped"] == 0
        assert math.isclose(m["loss"], loss, rel_tol=1e-4)
        assert math.isclose(m["grad_norm"], norm, rel_tol=1e-4)
    assert metrics_j[-1][1] > 1.0  # the clip was in force
    want, start = dict(jax_flatten(state["params"])), dict(jax_flatten(trainable_j))
    for path, prm in trainable.items():
        w, got = np.asarray(want[path]), prm.detach().numpy()
        if path.endswith("/attn/k/b"):
            # softmax removes a constant added to every key's score: the key
            # bias's gradient is zero up to rounding, which AdamW scales to
            # steps of up to lr on either side; both stay within them
            for t in (w, got):
                assert np.abs(t - np.asarray(start[path])).max() <= 1.01 * 3 * 1e-3
            continue
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max() + 1e-8, path


@pytest.mark.parametrize("method", ["lora", "mona"])
def test_tune_text_encoder_cli_saves_adapter_only(tmp_path, monkeypatch, method):
    from nextgen_uia_tpu_torch.tasks.biomedclip.finetune import main

    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=24, img_size=32)
    monkeypatch.chdir(tmp_path)
    out = main(["--exp", "tt", "--method", method, "--tune_text_encoder", "--lora_layers", "1",
                "--debug_tiny", "--img_size", "32", "--batch_size", "8",
                "--accumulation_steps", "2", "--epochs", "1", "--device", "cpu",
                "--compute_dtype", "float32", "--num_workers", "2", "--finetune_csvs", csv,
                "--finetune_img_dirs", img_dir])
    assert np.isfinite(out["best_val_loss"]) and out["best_epoch"] == 0
    best = str(tmp_path / "runs" / "tt" / "best_model.npz")
    saved = ckpt.load_flat(best)
    log = open(tmp_path / "runs" / "tt" / "log.log").read()
    assert "Cached text features" not in log
    if method == "mona":
        assert saved and all("/mona/" in k for k in saved)
        assert "text-encoder layers" not in log
        return
    assert sorted({k.rsplit("/lora/", 1)[0] for k in saved}) == [
        "text/layers/0/attn", "visual/blocks/0/attn"]
    assert len(saved) == 2 * 4 * 2 and "Injected LoRA into 1 text-encoder layers" in log

    # the JAX package's --debug_tiny BiomedCLIP tree with LoRA in both towers
    # (its shapes: the loaded leaves are the saved arrays)
    jcfg = jax_clip.clip_config("biomedclip")
    jcfg = jcfg.replace(
        vision=dataclasses.replace(jcfg.vision, image_size=32, width=96, depth=4, heads=4,
                                   proj_dim=64),
        text=dataclasses.replace(jcfg.text, width=96, depth=2, heads=4, intermediate=192,
                                 embed_dim=64))

    def init(k0, k1, k2):
        p = jax_clip.clip_init(k0, jcfg)
        p["visual"], _ = jax_lora.inject_lora(k1, p["visual"], dim=96, num_layers=1)
        p["text"], _ = jax_lora.inject_lora_bert(k2, p["text"], dim=96, num_layers=1)
        return p

    loaded, n = jax_ckpt.load_into(best, _jax_shapes(init))
    assert n == len(saved)
    for path, arr in jax_flatten(loaded):
        if path in saved:
            np.testing.assert_array_equal(np.asarray(arr), saved[path])
    assert any(np.abs(v).max() > 0 for k, v in saved.items()
               if k.startswith("text/") and k.endswith("/b"))
