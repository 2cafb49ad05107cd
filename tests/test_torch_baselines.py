"""The port's ResNet/UNet baselines and CLIP's ModifiedResNet against the JAX
package, on the CPU, at toy sizes.

(a) The layers they add: the strided, explicitly padded and bias-free
convolution (on odd sizes, where stride 2 rounds), the 3x3/2 max pool over
-inf padding, the 2x2 max pool and the k x k average pool, within 2e-5 *
max|ref|; (b) the ResNet parameter and
BatchNorm-state trees, names and shapes, equal to JAX's for all five archs
(JAX's by ``jax.eval_shape``); (c) ResNet-18 and ResNet-50 at 32 px, batch
4, with BatchNorm away from its init: eval logits within 2e-5 * max|ref|;
train-mode logits and the new running statistics within 1e-10 * max|ref|
and every gradient within 1e-9 * its max|g|, in float64 in both packages
(float32 rounding, amplified by the last stage's BatchNorm over 4 values,
parts them by more than the float32 limits: the test's docstring has the
numbers); (d) the UNet (``init_channels`` 4) at 1 and 3 input channels, eval
and train mode with both packages handed the same dropout masks: logits and
new statistics within 2e-5 * max|ref|; (e) ModifiedResNet
(layers (1, 1, 1, 1), width 8, 2 heads, 64 px) from an OpenAI-layout state
dict through ``python -m nextgen_uia_tpu_torch.convert modified_resnet``,
the file filling every tensor, its features within 2e-5 * max|ref|; (f)
three AdamW updates of each baseline bundle, augmentation off, against
JAX's ``make_train_step``: losses within 1e-4 relative, the BatchNorm state
within 2e-5; (g) the five CLIs on the synthetic dataset: segmentation and
its predict round trip (the masks equal the bundle's eval argmax, the
port's best_model.npz loading into the JAX bundle), classification from a
converted torchvision resnet18 (``__state__/`` statistics merged, the
1000-way fc skipped) and its predict round trip (the probabilities equal
the eval softmax), and both few-shot trainers.
"""

import copy
import csv
import glob
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nextgen_uia_tpu import losses as jax_losses
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core import train as jax_train
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.models import clip_resnet as jcr
from nextgen_uia_tpu.models import resnet as jres
from nextgen_uia_tpu.models import unet as junet
from nextgen_uia_tpu.nn import layers as jl
from nextgen_uia_tpu.tasks import other_tasks as jot
from nextgen_uia_tpu_torch import losses
from nextgen_uia_tpu_torch.convert import torch_to_npz as C
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import flatten_with_paths, partition
from nextgen_uia_tpu_torch.models import clip_resnet as cr
from nextgen_uia_tpu_torch.models import resnet as res
from nextgen_uia_tpu_torch.models import unet
from nextgen_uia_tpu_torch.nn import layers as L
from nextgen_uia_tpu_torch.tasks import other_tasks as ot
from nextgen_uia_tpu_torch.tasks.common import base_parser
from synth_data import make_synth_root


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    # (kernel, stride, padding, bias): the stem, a strided 3x3, the 1x1 down, "same"
    cases = [(7, 2, 3, False), (3, 2, 1, True), (1, 2, 0, False), (3, 1, "same", False)]
    for k, stride, pad, bias in cases:
        p = L.Conv(gen, k, k, 5, 6, bias=bias)
        assert (p.b is not None) == bias
        pj = {"w": jnp.asarray(p.w.numpy()), **({"b": jnp.asarray(p.b.numpy())} if bias else {})}
        want = jl.conv2d(pj, jnp.asarray(x), stride=stride,
                         padding="SAME" if pad == "same" else ((pad, pad), (pad, pad)))
        _close(L.conv2d(p, _t(x), stride=stride, padding=pad), want, 2e-5, (k, stride, pad))
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf)
    want = jax.lax.reduce_window(padded, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 "VALID")
    _close(L.max_pool(_t(x), 3, 2, 1), want, 2e-5, "3x3/2 max pool")
    _close(L.max_pool(_t(x), 2, 2), junet._maxpool2(jnp.asarray(x)), 2e-5, "2x2 max pool")
    for k in (1, 2, 3):
        _close(L.avg_pool(_t(x), k), jcr._avg_pool(jnp.asarray(x), k), 2e-5, f"avg pool {k}")


@pytest.mark.parametrize("arch", sorted(res.SPECS))
def test_resnet_trees_match_jax(arch):
    params, state = res.resnet_init(torch.Generator().manual_seed(0), arch, in_channels=1,
                                    num_classes=3)
    params_j, state_j = jax.eval_shape(lambda: jres.resnet_init(jax.random.key(0), arch,
                                                                in_channels=1, num_classes=3))
    for port, jax_tree in ((params, params_j), (state, state_j)):
        got = {k: tuple(v.shape) for k, v in flatten_with_paths(port)}
        want = {k: tuple(v.shape) for k, v in jax_flatten(jax_tree)}
        assert got == want


def _off_init(params, state, seed):
    """BatchNorm scale, bias and running statistics moved off their init
    (the identity would hide an error in them)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, t in list(params.state_dict().items()) + list(state.state_dict().items()):
            if k.endswith(("bn.scale", "bn1.scale", "bn2.scale", ".var")):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif k.endswith(("bn.bias", "bn1.bias", "bn2.bias", ".mean")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))


def _to_jax(tmp_path, name, module, shapes):
    path = str(tmp_path / f"{name}.npz")
    ckpt.save(path, module)
    tree, n = jax_ckpt.load_into(path, shapes)
    assert n == len(module.state_dict())
    return tree


def _grads_match(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(got[k].numpy() - w).max() <= tol * np.abs(w).max(), k


class _Float64:
    """A module's ``torch`` or ``jnp`` with float32 read as float64: both
    packages name float32 for their parameters and BatchNorm statistics."""

    def __init__(self, module, f64):
        self._module, self._f64 = module, f64

    def __getattr__(self, name):
        return self._f64 if name == "float32" else getattr(self._module, name)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax(tmp_path, monkeypatch, arch):
    """Eval mode in float32. Train mode (logits, the new statistics, every
    gradient) in float64 in both packages: at 32 px the last stage is 1 x 1,
    so its train-mode BatchNorm normalizes over the batch's 4 values and
    amplifies float32 rounding (on the CPU the packages' float32 train
    logits part by 2.0e-5 of max|ref| for ResNet-18 and 1.5e-3 for
    ResNet-50, gradients up to 1.2e-4 and 2.7e-1 of their own max|g|; in
    float64 by 4e-14 and 2e-12, and 1.4e-13 and 4.8e-11)."""
    params, state = res.resnet_init(torch.Generator().manual_seed(1), arch, num_classes=3)
    _off_init(params, state, 2)
    shapes = jax.eval_shape(lambda: jres.resnet_init(jax.random.key(0), arch, num_classes=3))
    params_j, state_j = (_to_jax(tmp_path, n, m, s)
                         for n, m, s in zip(("p", "s"), (params, state), shapes))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3))
    ct = rng.standard_normal((4, 3))

    want, _ = jax.jit(lambda p, s, x: jres.resnet_apply(p, s, x, arch))(
        params_j, state_j, jnp.asarray(x, jnp.float32))
    with torch.no_grad():
        _close(res.resnet_apply(params, state, _t(x.astype(np.float32)), arch), want, 2e-5,
               "eval")

    for name, mod in list(sys.modules.items()):
        if name.startswith("nextgen_uia_tpu_torch.") and getattr(mod, "torch", None) is torch:
            monkeypatch.setattr(mod, "torch", _Float64(torch, torch.float64))
        elif name.startswith("nextgen_uia_tpu.") and getattr(mod, "jnp", None) is jnp:
            monkeypatch.setattr(mod, "jnp", _Float64(jnp, jnp.float64))
    with jax.enable_x64(True):
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params_j, state_j))

        @jax.jit
        def grad_j(p, s):
            def loss(p):
                logits, ns = jres.resnet_apply(p, s, jnp.asarray(x), arch, train=True)
                return jnp.sum(logits * ct), (logits, ns)
            return jax.grad(loss, has_aux=True)(p)

        grads_j, (want, new_state) = grad_j(p64, s64)
        grads_j, want, new_state = jax.tree.map(np.asarray, (grads_j, want, new_state))
    params.double()
    trained = copy.deepcopy(state).double()
    for prm in params.parameters():
        prm.requires_grad_(True)
    logits = res.resnet_apply(params, trained, _t(x), arch, train=True)
    (logits * _t(ct)).sum().backward()
    assert logits.dtype == torch.float64 and want.dtype == np.float64
    _close(logits, want, 1e-10, "train")
    for k, v in jax_flatten(new_state):
        _close(trained.state_dict()[k.replace("/", ".")], v, 1e-10, k)
    _grads_match({k: prm.grad for k, prm in params.named_parameters()},
                 {k.replace("/", "."): g for k, g in jax_flatten(grads_j)}, 1e-9)


_MASK_RATES = unet.DROPOUTS


def _unet_masks(monkeypatch, b, size, ch):
    """The same pre-scaled dropout masks for both packages, one a level
    (keyed by its rate, each level's own)."""
    rng = np.random.default_rng(11)
    masks = {r: ((rng.random((b, size >> i, size >> i, ch << i)) >= r) / (1 - r)).astype(
        np.float32) for i, r in enumerate(_MASK_RATES)}

    def jax_dropout(key, x, rate):
        return x if key is None or rate <= 0 else x * jnp.asarray(masks[rate])

    def port_mask(gen, rate, shape, device=None):
        assert gen is not None and tuple(shape) == masks[rate].shape
        return torch.from_numpy(masks[rate])

    monkeypatch.setattr(junet, "dropout", jax_dropout)
    monkeypatch.setattr(unet, "dropout_mask", port_mask)


@pytest.mark.parametrize("in_ch", [1, 3])
def test_unet_matches_jax(tmp_path, monkeypatch, in_ch):
    params, state = unet.unet_init(torch.Generator().manual_seed(4), in_ch, 2, init_channels=4)
    _off_init(params, state, 5)
    shapes = jax.eval_shape(lambda: junet.unet_init(jax.random.key(0), in_ch, 2,
                                                    init_channels=4))
    params_j, state_j = (_to_jax(tmp_path, n, m, s)
                         for n, m, s in zip(("p", "s"), (params, state), shapes))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, in_ch)).astype(np.float32)
    want, _ = jax.jit(junet.unet_apply)(params_j, state_j, jnp.asarray(x))
    with torch.no_grad():
        _close(unet.unet_apply(params, state, _t(x)), want, 2e-5, "eval")

    _unet_masks(monkeypatch, 4, 32, 4)
    want, new_state = jax.jit(lambda p: junet.unet_apply(p, state_j, jnp.asarray(x), train=True,
                                                         rng=jax.random.key(0)))(params_j)
    with torch.no_grad():
        _close(unet.unet_apply(params, state, _t(x), train=True, gen=torch.Generator()), want,
               2e-5, "train")
    for k, v in jax_flatten(new_state):
        _close(state.state_dict()[k.replace("/", ".")], v, 2e-5, k)


def _openai_modified_resnet(cfg, seed):
    """A seeded OpenAI-layout ModifiedResNet under ``visual.`` (convs of std
    fan_in^-0.5, BatchNorm away from its init), with a text tensor the
    converter must leave out."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"visual.{name}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * (
            cin * k * k) ** -0.5

    def bn(name, c):
        sd[f"visual.{name}.weight"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"visual.{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"visual.{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"visual.{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv(f"conv{i}", cout, cin, 3)
        bn(f"bn{i}", cout)
    cin = w
    for stage, nblocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        for b in range(nblocks):
            base = f"layer{stage + 1}.{b}"
            for ci, (co, ci_, k) in enumerate(((planes, cin, 1), (planes, planes, 3),
                                               (planes * 4, planes, 1)), 1):
                conv(f"{base}.conv{ci}", co, ci_, k)
                bn(f"{base}.bn{ci}", co)
            if b == 0:
                conv(f"{base}.downsample.0", planes * 4, cin, 1)
                bn(f"{base}.downsample.1", planes * 4)
            cin = planes * 4
    d = cfg.embed_dim
    sd["visual.attnpool.positional_embedding"] = torch.randn(cfg.grid ** 2 + 1, d,
                                                             generator=gen) * d ** -0.5
    for n, out in (("q", d), ("k", d), ("v", d), ("c", cfg.output_dim)):
        sd[f"visual.attnpool.{n}_proj.weight"] = torch.randn(out, d, generator=gen) * d ** -0.5
        sd[f"visual.attnpool.{n}_proj.bias"] = 0.1 * torch.randn(out, generator=gen)
    sd["token_embedding.weight"] = torch.randn(10, 4, generator=gen)
    return sd


def test_modified_resnet_from_the_converter_matches_jax(tmp_path, capsys):
    cfg = cr.ModifiedResNetConfig(layers=(1, 1, 1, 1), output_dim=32, heads=2,
                                  input_resolution=64, width=8)
    jcfg = jcr.ModifiedResNetConfig(layers=(1, 1, 1, 1), output_dim=32, heads=2,
                                    input_resolution=64, width=8)
    src, dst = str(tmp_path / "rn.pt"), str(tmp_path / "rn.npz")
    torch.save(_openai_modified_resnet(cfg, 7), src)
    C.main(["modified_resnet", src, dst])
    flat = ckpt.load_flat(dst)
    params, state = cr.modified_resnet_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.merge_flat(flat, params)
    _, ns = ckpt.merge_flat(flat, torch.nn.ModuleDict({"__state__": state}))
    assert n == len(params.state_dict()) and ns == len(state.state_dict())
    assert n + ns == len(flat)

    shapes = jax.eval_shape(lambda: jcr.modified_resnet_init(jax.random.key(0), jcfg))
    loaded, nj = jax_ckpt.load_into(dst, {**shapes[0], "__state__": shapes[1]})
    assert nj == len(flat)
    x = np.random.default_rng(8).random((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, x: jcr.modified_resnet_apply(p, s, x, jcfg))(
        {k: v for k, v in loaded.items() if k != "__state__"}, loaded["__state__"],
        jnp.asarray(x))
    with torch.no_grad():
        got = cr.modified_resnet_apply(params, state, _t(x), cfg)
    assert got.shape == (2, 32)
    _close(got, want, 2e-5, "features")


def _args(task, **kw):
    base = dict(version="resnet18", in_channels=3 if task == "cls" else 1, num_classes=2,
                init_channels=4, backbone_ckpt=None, img_size=32, strong_augs=False,
                weak_augs=False)
    return types.SimpleNamespace(**{**base, **kw})


def _jax_bundle(task, args):
    """JAX's bundle with its init traced for the shapes only (eager init of
    the towers costs seconds); returns (bundle, (params, bn) shapes)."""
    build = jot.build_baseline_cls_bundle if task == "cls" else jot.build_baseline_seg_bundle
    held = []
    shapes = jax.eval_shape(lambda: (held.append(build(args, jax.random.key(0))),
                                     (held[0].params, held[0].bn_state))[1])
    return held[0], shapes


def _batch(task, n=4, size=32, seed=5):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size)).astype(np.uint8)
    if task == "cls":
        return {"image": imgs, "label": np.arange(n) % 2}
    masks = np.zeros((n, size, size), np.uint8)
    masks[:, size // 4:3 * size // 4, size // 3:] = 1
    return {"image": imgs, "mask": masks}


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_three_updates_match_jax(tmp_path, monkeypatch, task):
    """The JAX baselines bundle's step (run_supervised's loss with the
    BatchNorm state as aux) against the port's TrainStep over the port's
    bundle: three AdamW updates, augmentation off, the UNet's dropout under
    the same masks."""
    args = _args(task)
    build = ot.build_baseline_cls_bundle if task == "cls" else ot.build_baseline_seg_bundle
    bundle = build(args, torch.Generator().manual_seed(3))
    _off_init(bundle.params["model"], bundle.bn_state, 4)
    bundle_j, shapes = _jax_bundle(task, args)
    params_j, bn_j = (_to_jax(tmp_path, n, m, s) for n, m, s in
                      zip(("p", "s"), (bundle.params, bundle.bn_state), shapes))
    if task == "seg":
        _unet_masks(monkeypatch, 4, 32, 4)
    batch = _batch(task)

    def loss_j(tp, bn, mb, key):
        logits, m, new_bn = bundle_j.forward_train(tp, bn, mb, key)
        loss = (jax_losses.focal_loss(logits, mb["label"]) if task == "cls"
                else jax_losses.dice_ce_loss(logits, m))
        return loss, new_bn

    def loss_j_step(tp, frozen, mb, key):
        return loss_j(tp, frozen["bn"], mb, key)

    # lr 1e-5: Adam moves a bias whose gradient is rounding noise by ~lr an
    # update, and the UNet's conv biases ahead of a BatchNorm enter its
    # running mean
    tcfg = dict(lr=1e-5, lr_min=1e-8, weight_decay=0.01, beta1=0.9, beta2=0.95,
                total_updates=10)
    jcfg = jax_train.TrainConfig(**tcfg, grad_clip=0.0, accum_steps=1)
    opt_j, _ = jax_train.make_optimizer(jcfg)
    step_j = jax_train.make_train_step(loss_j_step, opt_j, jcfg, donate=False, has_aux=True)
    state = jax_train.init_state(params_j, opt_j)
    fz, losses_j = {"bn": bn_j}, []
    mb_j = {k: jnp.asarray(v)[None] for k, v in batch.items()}
    for i in range(3):
        state, m = step_j(state, fz, mb_j, jax.random.key(i))
        fz = {"bn": m["aux"]}
        losses_j.append(float(m["loss"]))

    trainable, _ = partition(bundle.params, bundle.trainable_pred)
    assert len(trainable) == len(jax_flatten(params_j))

    def loss_t(mb, g):
        logits, m = bundle.forward_train(bundle.params, mb, g)
        return (losses.focal_loss(logits, mb["label"]) if task == "cls"
                else losses.dice_ce_loss(logits, m))

    step = T.TrainStep(loss_t, T.make_optimizer(trainable.values(), T.TrainConfig(**tcfg)),
                       T.TrainConfig(**tcfg))
    mb_t = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    losses_t = [step(mb_t, torch.Generator())["loss"] for _ in range(3)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4, atol=0)
    assert losses_t[-1] != losses_t[0]
    got = {k: v for k, v in flatten_with_paths(bundle.bn_state)}
    want = dict(jax_flatten(fz["bn"]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(got[k].numpy() - np.asarray(w)).max() <= 2e-5, k


@pytest.fixture()
def synth(tmp_path, monkeypatch):
    root, _, _ = make_synth_root(tmp_path / "data", dataset="BUSI", n=12, img_size=32)
    monkeypatch.chdir(tmp_path)
    return str(root)


COMMON = ["--dataset", "BUSI", "--img_size", "32", "--batch_size", "4", "--num_workers", "2",
          "--device", "cpu", "--val_interval", "1", "--patience", "3"]


def _chunks(paths, size=32, batch=4):
    from nextgen_uia_tpu_torch.data.datasets import load_image

    for s in range(0, len(paths), batch):
        yield torch.from_numpy(np.stack([load_image(p, size) for p in paths[s:s + batch]]))


def test_segmentation_cli_and_predict_round_trip(synth, tmp_path):
    from nextgen_uia_tpu_torch.tasks.baselines import predict, segmentation

    stats = segmentation.main(COMMON + ["--data_root", synth, "--exp", "bseg", "--epochs", "1",
                                        "--init_channels", "2"])
    assert np.isfinite(stats["loss"]) and "dice_mean" in stats
    run = tmp_path / "runs" / "bseg" / "BUSI" / "train"
    best = str(run / "best_model.npz")
    (results,) = glob.glob(str(run / "*_iou=*" / "results.csv"))
    keys = ckpt.peek_keys(best)
    assert any(k.startswith("bn/enc0/bn1/") for k in keys)
    assert all(k.startswith(("params/model/", "bn/")) for k in keys)
    # the JAX package's seg bundle loads the port's file whole
    _, shapes = _jax_bundle("seg", _args("seg", init_channels=2))
    _, n = jax_ckpt.load_into(best, {"params": shapes[0], "bn": shapes[1]})
    assert n == len(keys)

    images = sorted(glob.glob(os.path.join(synth, "all", "images", "*.png")))
    out = predict.main(COMMON + ["--task", "seg", "--images", os.path.dirname(images[0]),
                                 "--init_channels", "2", "--head_weights", best,
                                 "--out", str(tmp_path / "served")])["out"]
    bundle = ot.build_baseline_seg_bundle(_args("seg", init_channels=2),
                                          torch.Generator().manual_seed(0))
    ckpt.load_into(best, torch.nn.ModuleDict({"params": bundle.params, "bn": bundle.bn_state}))
    with torch.no_grad():
        want = torch.cat([bundle.forward_eval(bundle.params, b) for b in _chunks(images)])
    want = want.argmax(1).numpy()
    with open(os.path.join(out, "index.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["path"] for r in rows] == images and all(r["status"] == "ok" for r in rows)
    for r, w in zip(rows, want):
        np.testing.assert_array_equal(np.asarray(Image.open(r["mask"])) > 0, w == 1)


def _torchvision_resnet18(seed, classes):
    """A seeded torchvision-layout resnet18 state dict (BatchNorm running
    statistics away from their init)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * (cin * k * k) ** -0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage in range(4):
        cout = 64 * 2 ** stage
        for b in range(2):
            base = f"layer{stage + 1}.{b}"
            conv(f"{base}.conv1", cout, cin if b == 0 else cout, 3)
            bn(f"{base}.bn1", cout)
            conv(f"{base}.conv2", cout, cout, 3)
            bn(f"{base}.bn2", cout)
            if b == 0 and stage > 0:
                conv(f"{base}.downsample.0", cout, cin, 1)
                bn(f"{base}.downsample.1", cout)
        cin = cout
    sd["fc.weight"] = torch.randn(classes, 512, generator=gen) * 512 ** -0.5
    sd["fc.bias"] = torch.zeros(classes)
    return sd


def test_classification_cli_from_a_converted_torchvision_resnet(synth, tmp_path, capsys):
    from nextgen_uia_tpu_torch.tasks.baselines import classification, predict

    files = {}
    for classes in (1000, 2):
        src, dst = str(tmp_path / f"rn{classes}.pt"), str(tmp_path / f"rn{classes}.npz")
        torch.save(_torchvision_resnet18(9, classes), src)
        C.main(["resnet18", src, dst])
        files[classes] = dst
    converted = ckpt.load_flat(files[1000])
    p = base_parser("baselines_classification")
    ot.add_baseline_cls_flags(p)
    for classes, path in files.items():
        bundle = ot.build_baseline_cls_bundle(p.parse_args(["--backbone_ckpt", path]),
                                              torch.Generator().manual_seed(0))
        model = dict(flatten_with_paths(bundle.params["model"]))
        for k, v in flatten_with_paths(bundle.bn_state):
            np.testing.assert_array_equal(v.numpy(), converted[f"__state__/{k}"], k)
        np.testing.assert_array_equal(model["layer3/0/down/conv/w"].numpy(),
                                      converted["layer3/0/down/conv/w"])
        # the 1000-way head is left at init (the task replaces it), a 2-way one loads
        assert (classes == 2) == np.array_equal(model["fc/w"].numpy(),
                                                ckpt.load_flat(path)["fc/w"])

    stats = classification.main(COMMON + ["--data_root", synth, "--exp", "bcls", "--epochs", "1",
                                          "--backbone_ckpt", files[1000]])
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["acc"])
    best = str(tmp_path / "runs" / "bcls" / "BUSI" / "train" / "best_model.npz")
    log = open(glob.glob(str(tmp_path / "runs" / "bcls" / "BUSI" / "train" / "*_acc=*" /
                             "log.log"))[0]).read()
    assert "reinitializing fc" in log and "Loaded 60 ResNet tensors (+40 BN state)" in log

    images = sorted(glob.glob(os.path.join(synth, "all", "images", "*.png")))
    out = predict.main(COMMON + ["--images", os.path.dirname(images[0]), "--head_weights", best,
                                 "--out", str(tmp_path / "served")])["out"]
    bundle = ot.build_baseline_cls_bundle(_args("cls"), torch.Generator().manual_seed(0))
    _, n = ckpt.load_into(best, torch.nn.ModuleDict({"params": bundle.params,
                                                     "bn": bundle.bn_state}))
    assert n == len(ckpt.peek_keys(best)) == 62 + 40
    with torch.no_grad():
        want = torch.softmax(torch.cat([bundle.forward_eval(bundle.params, b)
                                        for b in _chunks(images)]).double(), -1).numpy()
    with open(os.path.join(out, "predictions.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["path"] for r in rows] == images
    got = np.array([[float(r["prob_0"]), float(r["prob_1"])] for r in rows])
    assert np.abs(got - want).max() <= 1e-6
    assert [int(r["pred"]) for r in rows] == list(want.argmax(1))


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_fewshot_clis(synth, tmp_path, task):
    from nextgen_uia_tpu_torch.tasks.baselines import (fewshot_classification,
                                                       fewshot_segmentation)

    if task == "cls":
        stats = fewshot_classification.main(COMMON + ["--data_root", synth, "--exp", "fs",
                                                      "--epochs", "1", "--shots_per_class", "1"])
        assert "acc" in stats
    else:
        stats = fewshot_segmentation.main(COMMON + ["--data_root", synth, "--exp", "fs",
                                                    "--epochs", "1", "--train_ratio", "0.5",
                                                    "--init_channels", "2"])
        assert "dice_mean" in stats
    log = open(glob.glob(str(tmp_path / "runs" / "fs" / "BUSI" / "train" / "*" /
                             "log.log"))[0]).read()
    assert f"Few-shot training subset: {2 if task == 'cls' else 2} samples" in log


def test_baselines_refuse_several_devices_and_serve_no_unknown_family(synth):
    from nextgen_uia_tpu_torch.tasks import serve
    from nextgen_uia_tpu_torch.tasks.baselines import fewshot_segmentation, segmentation

    # several devices take a torchrun launch of as many processes
    for main in (segmentation.main, fewshot_segmentation.main):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            main(COMMON + ["--data_root", synth, "--n_data", "2"])
    with pytest.raises(ValueError, match="no predict CLI serves the 'resnet' family"):
        serve.predict_main("resnet", ["--images", synth])
