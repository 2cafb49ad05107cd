"""LoRA weights in the supervised CLIs, and the few-shot trainers, against
the JAX package on the CPU.

(a) The supervised seg model assembled from ``--lora_weights`` (a
``--debug_tiny`` BiomedCLIP, LoRA r = 4 in its four blocks, read back from
the file) by both packages' ``_build_supervised``, then three AdamW
updates of its train forward under run_supervised's DiceCE with LoRA
dropout 0.1, both sides fed the same masks (one a projection): losses
within 1e-4 relative, first-step gradients of every LoRA and head tensor
within 1e-4 * max|g|, with LoRA updates a fraction of the frozen
projections'; at 0.1 scale, where float32 rounding alone parts the two
packages by ~1e-3, the same step run in float64 by both agrees to 1e-10.
(b) A LoRA block is not one the whole-block kernel
takes, so eval and serving run the composed route; the seg predict CLI
serves with ``--lora_weights``. (c) The few-shot subsets and the batch
clamp of ``supervised_main(fewshot=True)`` and the dino mains equal JAX's
for cls and seg, by shots and by ratio; the dino mains take
``--lora_weights`` and say that it has no effect.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import by_keywords as jax_by_keywords
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.core.partition import merge as jax_merge
from nextgen_uia_tpu.core.partition import partition as jax_partition
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.models import heads as jax_heads
from nextgen_uia_tpu.nn import attention as jax_attention
from nextgen_uia_tpu.tasks import clip_tasks as jax_tasks
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu.tasks import other_tasks as jax_ot
from nextgen_uia_tpu.tasks import supervised as jax_supervised
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.adapters.lora import inject_lora
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.models.vit import ViTConfig, vit_init
from nextgen_uia_tpu_torch.nn import attention
from nextgen_uia_tpu_torch.ops.fused_block import fused_block_eligible
from nextgen_uia_tpu_torch.tasks import clip_tasks, common, other_tasks
from synth_data import make_synth_root

DIM, R, DEPTH, N = 96, 4, 4, 5  # --debug_tiny towers at 32 px: 2 x 2 patches + CLS


def _lora_file(path, seed, scale=0.02):
    """A LoRA component checkpoint as the fine-tune writes it, its updates
    a fraction of the frozen projections' (as trained pairs, whose b starts
    at zero, hold them)."""
    rng = np.random.default_rng(seed)
    flat = {f"visual/blocks/{i}/attn/lora/{t}/{ab}": (
        scale * rng.standard_normal((DIM, R) if ab == "a" else (R, DIM))).astype(np.float32)
        for i in range(DEPTH) for t in "qkvo" for ab in "ab"}
    np.savez(path, **flat)
    return flat


def _argv(lora):
    return ["--debug_tiny", "--img_size", "32", "--compute_dtype", "float32", "--lora_weights",
            lora, "--lora_r", "8", "--no-strong_augs", "--no-weak_augs"]


class _Float64:
    """A module's ``torch`` or ``jnp`` with float32 read as float64: both
    packages name float32 for their parameters, LayerNorm statistics,
    attention logits and losses, so patching that one name runs a whole
    step in float64."""

    def __init__(self, module, f64):
        self._module, self._f64 = module, f64

    def __getattr__(self, name):
        return self._f64 if name == "float32" else getattr(self._module, name)


def _in_float64(monkeypatch):
    """Every loaded module of both packages computes in float64 (and JAX
    keeps 64-bit types) until the test ends."""
    import sys

    for name, mod in list(sys.modules.items()):
        if name.startswith("nextgen_uia_tpu_torch.") and getattr(mod, "torch", None) is torch:
            monkeypatch.setattr(mod, "torch", _Float64(torch, torch.float64))
        elif name.startswith("nextgen_uia_tpu.") and getattr(mod, "jnp", None) is jnp:
            monkeypatch.setattr(mod, "jnp", _Float64(jnp, jnp.float64))
    x64 = jax.enable_x64(True)
    x64.__enter__()
    return x64


def _lora_steps(tmp_path, monkeypatch, scale, f64=False, nudge=0.0):
    """Both packages' supervised seg model from one ``--lora_weights`` file
    of ``scale``, three AdamW updates under the same LoRA dropout masks:
    (port's losses, JAX's losses, port's first gradients, JAX's), float32;
    with ``f64``, the port's first loss and gradients alone, in float64,
    its weights first scaled by 1 + ``nudge`` * N(0, 1)."""
    lora = _lora_file(str(tmp_path / "lora.npz"), 0, scale)
    args = common.base_parser("biomedclip_seg").parse_args(_argv(str(tmp_path / "lora.npz")))
    cfg, hcfg, model = clip_tasks._build_supervised(args, "biomedclip", "seg",
                                                    torch.Generator().manual_seed(0))
    state = model.state_dict()
    for key, arr in lora.items():  # r = 4 read from the file over --lora_r 8
        np.testing.assert_array_equal(state["backbone." + key.replace("/", ".")].numpy(), arr)
    assert cfg.vision.lora_dropout == 0.1
    path = str(tmp_path / "w.npz")
    ckpt.save(path, model)

    # JAX's model from the same flags: its init traced for the shapes only,
    # every tensor then loaded from the port's file
    args_j = jax_common.base_parser("biomedclip_seg").parse_args(_argv(str(tmp_path / "lora.npz")))
    held = []
    shapes = jax.eval_shape(lambda: held.append(jax_tasks._build_supervised(
        args_j, "biomedclip", "seg", jax.random.key(0))) or held[0][2])
    params_j, n = jax_ckpt.load_into(path, shapes)
    assert n == len(jax_flatten(shapes)) == len(state)
    jcfg, jhcfg = held[0][0], held[0][1]
    assert jcfg.vision.lora_dropout == 0.1
    x64 = _in_float64(monkeypatch) if f64 else None
    if f64:
        model.double()
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(1 + nudge * torch.randn(prm.shape, generator=gen, dtype=prm.dtype))
        params_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params_j)
    dtype = np.float64 if f64 else np.float32

    # the same LoRA dropout masks on both sides, one a projection
    rng = np.random.default_rng(1)
    masks = {t: (rng.random((2, N, DIM)) < 0.9).astype(dtype) / 0.9 for t in "qkvo"}

    def jax_drop(x, name, drop_keys, rate):
        if drop_keys is None or name not in drop_keys:
            return x
        assert rate == 0.1
        m = np.ones(x.shape, dtype)  # JAX pads the tokens; padded rows stay
        m[:, :N] = masks[name]
        return x * jnp.asarray(m)

    drawn = []

    def port_mask(gen, rate, shape, device=None):
        assert rate == 0.1 and tuple(shape) == (2, N, DIM) and gen is not None
        drawn.append("qkvo"[len(drawn) % 4])
        return torch.from_numpy(masks[drawn[-1]])

    monkeypatch.setattr(jax_attention, "_lora_drop", jax_drop)
    monkeypatch.setattr(attention, "dropout_mask", port_mask)

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 32, 32), dtype=np.uint8)
    msk = (rng.random((2, 32, 32)) < 0.3).astype(np.uint8)
    fwd_j = jax_tasks._make_forward(jcfg, jhcfg, types.SimpleNamespace(
        strong_augs=False, weak_augs=False, img_size=32), train=True)

    def loss_j(tp, frozen, key):
        logits, m = fwd_j(jax_merge(tp, frozen), jnp.asarray(imgs), jnp.asarray(msk), key)
        return jax_losses.dice_ce_loss(logits, jnp.moveaxis(m, -1, 1).astype(jnp.int32))

    tcfg = dict(lr=1e-4, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    trainable_j, frozen_j = jax_partition(params_j, jax_by_keywords("head", "mona", "lora"))
    opt_j, _ = jax_train.make_optimizer(jax_train.TrainConfig(**tcfg))

    @jax.jit
    def step_j(tp, opt_state, key):
        loss, grads = jax.value_and_grad(loss_j)(tp, frozen_j, key)
        updates, opt_state = opt_j.update(grads, opt_state, tp)
        return optax.apply_updates(tp, updates), opt_state, loss, grads

    try:
        tp, opt_state, losses_j, grads_j = trainable_j, opt_j.init(trainable_j), [], None
        for i in range(3):
            tp, opt_state, loss, grads = step_j(tp, opt_state, jax.random.key(i))
            losses_j.append(float(loss))
            grads_j = grads_j or {k: np.asarray(g) for k, g in jax_flatten(grads)}
    finally:
        if x64 is not None:
            x64.__exit__(None, None, None)
    assert all(g.dtype == dtype for g in grads_j.values())

    trainable, _ = partition(model, by_keywords("head", "mona", "lora"))
    assert set(trainable) == set(grads_j)
    assert sum("/lora/" in k for k in trainable) == len(lora)
    fwd = clip_tasks.make_forward(cfg, hcfg, train=True)

    def loss_t(mb, gen):
        logits, m = fwd(model, mb["image"], mb["mask"], gen)
        return losses.dice_ce_loss(logits, m)

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tcfg)),
                       T.TrainConfig(**tcfg))
    mb = {"image": torch.from_numpy(imgs)[None], "mask": torch.from_numpy(msk)[None]}
    if f64:  # TrainStep sums gradients in float32: the first step's by one backward
        loss = loss_t({k: v[0] for k, v in mb.items()}, torch.Generator())
        loss.backward()
        losses_t = [loss.item()]
    else:
        losses_t = [step(mb, torch.Generator())["loss"]]
    assert drawn == list("qkvo") * DEPTH
    grads_t = {k: p.grad.numpy().copy() for k, p in trainable.items()}
    assert all(g.dtype == dtype for g in grads_t.values())
    if not f64:
        losses_t += [step(mb, torch.Generator())["loss"] for _ in range(2)]
    return losses_t, losses_j, grads_t, grads_j


def _worst(grads, ref):
    """max over tensors of max|d| / max|ref|."""
    return max(np.abs(grads[k] - r).max() / np.abs(r).max() for k, r in ref.items())


def test_supervised_lora_steps_match_jax(tmp_path, monkeypatch):
    losses_t, losses_j, grads_t, grads_j = _lora_steps(tmp_path, monkeypatch, 0.02)
    for name, want in grads_j.items():
        assert np.abs(grads_t[name] - want).max() <= 1e-4 * np.abs(want).max(), name
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4, atol=0)
    assert losses_t[-1] != losses_t[0]


def test_supervised_lora_float64_at_full_scale(tmp_path, monkeypatch):
    """At 0.1 scale (LoRA updates about 3x the frozen projections) both
    packages' float32 gradients part by up to ~1e-3 of max|g| with dropout
    on. In float64 they agree to rounding, so that gap is not a difference
    of the LoRA dropout route: the step is ill-conditioned there, and
    moving the float64 weights by float32's half ulp (6e-8, relative) moves
    the gradients by ~1e-4, on the same tensors that part in float32."""
    runs = {}
    for tag, f64, nudge in (("32", False, 0.0), ("64", True, 0.0), ("nudged", True, 6e-8)):
        (tmp_path / tag).mkdir()
        runs[tag] = _lora_steps(tmp_path / tag, monkeypatch, 0.1, f64, nudge)
        monkeypatch.undo()
    losses_t, losses_j, grads_t, grads_j = runs["64"]
    gap32, gap64 = _worst(runs["32"][2], runs["32"][3]), _worst(grads_t, grads_j)
    port32, jax32 = _worst(runs["32"][2], grads_j), _worst(runs["32"][3], grads_j)
    nudged = _worst(runs["nudged"][2], grads_j)
    print(f"worst max|d| / max|ref| at 0.1 scale, dropout on: float32 port vs JAX {gap32:.3e}, "
          f"float64 {gap64:.3e}; float32 vs JAX's float64: port {port32:.3e}, JAX {jax32:.3e}; "
          f"float64 with the weights nudged by 6e-8 {nudged:.3e}")
    np.testing.assert_allclose(losses_t, losses_j[:1], rtol=1e-12, atol=0)
    assert gap64 <= 1e-10


def test_whole_block_kernel_declines_lora():
    """Eval and serving: a block with LoRA takes the composed route, at a
    width the whole-block kernel otherwise takes."""
    gen = torch.Generator().manual_seed(0)
    vit = vit_init(gen, ViTConfig(image_size=32, width=128, heads=2, depth=1))
    x = torch.zeros(1, N, 128)
    assert fused_block_eligible(x, vit.blocks[0], heads=2, act="gelu")
    inject_lora(gen, vit, dim=128, r=R)
    assert not fused_block_eligible(x, vit.blocks[0], heads=2, act="gelu")


@pytest.fixture()
def synth(tmp_path, monkeypatch):
    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=30, img_size=32)
    monkeypatch.chdir(tmp_path)
    return str(root)


def test_seg_predict_serves_lora_weights(tmp_path, synth):
    from nextgen_uia_tpu_torch.tasks.biomedclip import predict

    _lora_file(str(tmp_path / "lora.npz"), 3)
    out = predict.main(["--task", "seg", "--images", str(tmp_path / "data" / "all" / "images"),
                        "--debug_tiny", "--img_size", "32", "--device", "cpu",
                        "--compute_dtype", "float32", "--batch_size", "8", "--num_workers", "1",
                        "--lora_weights", str(tmp_path / "lora.npz")])
    lines = open(f"{out['out']}/index.csv").read().splitlines()
    assert len(lines) == 31 and all(line.split(",")[2] == "ok" for line in lines[1:])
    log = open(f"{out['out']}/log.log").read()
    assert f"Loaded {len(list(np.load(tmp_path / 'lora.npz')))} LoRA tensors" in log

    # the supervised trainer's best_model.npz (LoRA under params/backbone/)
    # serves as both --lora_weights and --head_weights
    flat = {f"params/backbone/{k}": v for k, v in np.load(tmp_path / "lora.npz").items()}
    np.savez(tmp_path / "best.npz", **flat)
    out = predict.main(["--task", "seg", "--images", str(tmp_path / "data" / "all" / "images"),
                        "--debug_tiny", "--img_size", "32", "--device", "cpu",
                        "--compute_dtype", "float32", "--batch_size", "8", "--num_workers", "1",
                        "--lora_weights", str(tmp_path / "best.npz"), "--head_weights",
                        str(tmp_path / "best.npz"), "--out", str(tmp_path / "rooted")])
    log = open(f"{out['out']}/log.log").read()
    assert f"Loaded {len(flat)} LoRA tensors" in log


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, seen):
    def run_supervised(args, bundle, datasets, *rest):
        seen.append((list(datasets["train"].names), args.batch_size))
        raise _Captured

    monkeypatch.setattr(module, "run_supervised", run_supervised)


@pytest.mark.parametrize("task", ["cls", "seg"])
@pytest.mark.parametrize("sampling", [["--shots_per_class", "2"], ["--train_ratio", "0.5"],
                                      ["--train_ratio", "0.5", "--no-stratified"], []])
def test_fewshot_subsets_match_jax(synth, monkeypatch, task, sampling):
    """The sampled train names and the clamped batch of both packages'
    few-shot trainers: the CLIP family's and the dino mains'."""
    argv = ["--data_root", synth, "--debug_tiny", "--img_size", "32", "--batch_size", "8",
            "--seed", "3", *sampling]
    seen_j, seen_t = [], []
    _capture(monkeypatch, jax_supervised, seen_j)
    _capture(monkeypatch, jax_ot, seen_j)
    _capture(monkeypatch, clip_tasks, seen_t)
    _capture(monkeypatch, other_tasks, seen_t)
    # JAX's models are never run here: a stand-in skips their eager init
    cfg = jax_clip.clip_config("biomedclip")
    hcfg = jax_heads.PyramidHeadConfig(task=task)
    monkeypatch.setattr(jax_tasks, "_build_supervised", lambda *a: (cfg, hcfg, {}))
    monkeypatch.setattr(jax_ot, "build_dino_cls_bundle", lambda *a: None)
    monkeypatch.setattr(jax_ot, "build_dino_seg_bundle", lambda *a: None)
    dino_j = jax_ot.dino_classification_main if task == "cls" else jax_ot.dino_segmentation_main
    dino_t = (other_tasks.dino_classification_main if task == "cls"
              else other_tasks.dino_segmentation_main)
    for run_j, run_t in ((lambda a: jax_tasks.supervised_main("biomedclip", task, a, fewshot=True),
                          lambda a: clip_tasks.supervised_main("biomedclip", task, a + [
                              "--device", "cpu"], fewshot=True)),
                         (lambda a: dino_j(a, fewshot=True),
                          lambda a: dino_t(a + ["--device", "cpu", "--img_size", "28"],
                                           fewshot=True))):
        for run, a in ((run_j, argv), (run_t, argv)):
            with pytest.raises(_Captured):
                run(list(a))
    assert seen_t == seen_j and len(seen_t) == 2
    names, batch = seen_t[0]
    assert 1 <= len(names) < 10 and batch == min(8, len(names))
    if task == "cls" and sampling[:1] == ["--shots_per_class"]:
        labels = [int(n[4:7]) % 2 for n in names]  # make_synth_root labels i % 2
        assert sorted(labels) == [0, 0, 1, 1]


def test_dino_main_takes_lora_weights(synth, monkeypatch):
    seen = []
    _capture(monkeypatch, other_tasks, seen)
    with pytest.raises(_Captured):
        other_tasks.dino_segmentation_main(["--data_root", synth, "--debug_tiny", "--img_size",
                                            "28", "--device", "cpu", "--lora_weights", "x.npz"])
    log = open("runs/dino_segmentation/BUSI/train/log.log").read()
    assert "--lora_weights has no effect on DINOv2" in log
