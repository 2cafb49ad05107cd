"""Serving export (tasks/serve.py::export_program, the kernels as registered
torch ops) against the JAX package's ``--export``.

(a) Both packages' predict CLIs with ``--export`` on the same ``.npz``
weights: BiomedCLIP cls with hybrid MONA (debug_tiny, float32; the
backbone, MONA and head files as the trainers write them) and the
baselines' UNet seg (BatchNorm statistics moved off their init, carried as
arguments under bn/). The port's program, loaded back with its
``load_exported_params`` weights, against JAX's deserialized program on
its own, on one seeded batch: logits within 1e-4 * max(1, max|ref|).
(b) A weight tree that does not round-trip through the loader refuses and
leaves no file.
(c) A fake-CUDA trace: under FakeTensorMode the weights and images lie on
"cuda" and the forwards export as they would on the card, the kernels as
their ``nextgen_uia::`` ops (their register_fake shapes; a CPU-only
machine has no card). The graph holds exactly the expected ops, the
outputs' shapes and dtypes equal the CPU export's, the program saves and
loads back, and nothing was built, launched or counted. On a CPU-only
torch, Python's indexing and ``contiguous`` of a fake CUDA tensor reach a
CUDA device guard that does not exist, so the trace runs under
``ViewIndexing``, which gives them as the view ops they stand for
(select, slice, unsqueeze, clone).
"""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from nextgen_uia_tpu.tasks.serve import load_exported_params as jax_load_params
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.ops import build, registry
from nextgen_uia_tpu_torch.tasks import other_tasks as OT
from nextgen_uia_tpu_torch.tasks import serve

BATCH, IMG = 4, 32


def _images(tmp_path, n=5):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 40), np.uint8)).save(img_dir / f"{i}.png")
    return str(img_dir)


def _biomedclip_files(tmp_path):
    """The .npz files of a seeded debug_tiny BiomedCLIP, written as the
    packages write them: backbone, MONA slots and a cls head rooted as the
    supervised params (the port writes them: JAX's eager init is slow)."""
    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.models.heads import PyramidHeadConfig, pyramid_head_init
    from nextgen_uia_tpu_torch.tasks.common import build_clip_model

    argv = ["--task", "cls", "--debug_tiny", "--mona_variant", "hybrid", "--num_classes", "3",
            "--compute_dtype", "float32"]
    args = serve.predict_args("biomedclip", argv + ["--images", "x", "--img_size", str(IMG)])
    gen = torch.Generator().manual_seed(3)
    _, clip = build_clip_model(args, "biomedclip", gen=gen)
    files = {k: str(tmp_path / f"{k}.npz") for k in ("backbone_ckpt", "mona_weights",
                                                       "head_weights")}
    ckpt.save(files["backbone_ckpt"], clip)
    inject_mona(gen, clip.visual, dim=96, variant="hybrid")
    ckpt.save(files["mona_weights"], clip, keyword_filter=["mona"])
    head = pyramid_head_init(gen, PyramidHeadConfig(feature_dim=96, num_classes=3,
                                                    img_size=IMG, task="cls"))
    ckpt.save(files["head_weights"], torch.nn.ModuleDict({"backbone": clip, "head": head}))
    return argv + [a for k, v in files.items() for a in (f"--{k}", v)]


def _unet_files(tmp_path):
    """The port's UNet seg bundle (init channels 2) with its BatchNorm
    running statistics moved off 0 / 1, written as the trainer writes it."""
    args = serve.predict_args("baselines", ["--task", "seg", "--init_channels", "2",
                                            "--images", "x"])
    bundle = OT.build_baseline_seg_bundle(args, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, b in bundle.bn_state.named_buffers():
            if b.is_floating_point():
                b.copy_(b * (0.5 + torch.rand(b.shape, generator=gen))
                        + 0.1 * torch.randn(b.shape, generator=gen) * ("mean" in name))
    path = str(tmp_path / "unet.npz")
    ckpt.save(path, torch.nn.ModuleDict({"params": bundle.params, "bn": bundle.bn_state}))
    return ["--task", "seg", "--init_channels", "2", "--head_weights", path]


CASES = {"biomedclip": (_biomedclip_files, "biomedclip"),
         "unet": (_unet_files, "baselines")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_program_matches_jax(tmp_path, monkeypatch, case):
    from nextgen_uia_tpu.tasks.serve import predict_main as jax_predict

    monkeypatch.chdir(tmp_path)
    files, family = CASES[case]
    common = ["--images", _images(tmp_path), "--img_size", str(IMG), "--batch_size",
              str(BATCH), "--num_workers", "1", "--device", "cpu", *files(tmp_path)]
    out_j = jax_predict(family, common + ["--out", str(tmp_path / "jax"), "--export", "f"])
    out_t = serve.predict_main(family, common + ["--out", str(tmp_path / "port"),
                                                 "--export", "f.pt2"])
    x = np.random.default_rng(1).integers(0, 256, (BATCH, IMG, IMG), dtype=np.uint8)
    with open(os.path.join(out_j["out"], "f"), "rb") as f:
        exported = jax.export.deserialize(f.read())
    want = np.asarray(exported.call(jax_load_params(os.path.join(out_j["out"],
                                                                 "f.params.npz")), x))
    path = os.path.join(out_t["out"], "f.pt2")
    with open(path, "rb") as f:
        program = torch.export.load(f)
    weights = serve.load_exported_params(path + ".params.npz")
    got = program.module()(weights, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((BATCH, 3) if case == "biomedclip"
                                       else (BATCH, 2, IMG, IMG))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))
    # the program holds no weight (they are all in the .params.npz) and, on
    # the CPU, no kernel op: the plain versions
    assert not program.state_dict and not registry.graph_ops(program.graph)
    if case == "unet":
        assert any(k.startswith("bn/") for k in ckpt.peek_keys(path + ".params.npz"))


def test_export_refuses_a_tree_that_does_not_round_trip(tmp_path):
    """A dict whose keys are all digits comes back from the loader as a
    list: refused before anything is published, and no file is left."""
    tree = torch.nn.ModuleDict({"0": torch.nn.Linear(3, 2), "1": torch.nn.Linear(3, 2)})
    args = type("Args", (), {"batch_size": 2, "img_size": 3, "export": "f.pt2"})()

    def fn(x):
        return tree["0"](x.float()) + tree["1"](x.float())

    with pytest.raises(SystemExit, match="does not round-trip"):
        serve.export_program(fn, tree, args, str(tmp_path), "cpu")
    assert os.listdir(tmp_path) == []


# -- the fake-CUDA trace -----------------------------------------------------


def _expand(x, idx):
    idx = idx if isinstance(idx, tuple) else (idx,)
    spec = sum(1 for i in idx if i is not None and i is not Ellipsis)
    for k, i in enumerate(idx):
        if i is Ellipsis:
            return idx[:k] + (slice(None),) * (x.dim() - spec) + idx[k + 1:]
    return idx + (slice(None),) * (x.dim() - spec)


def _view(x, idx):
    """x[idx] as the ops Python's indexing stands for: basic indices (ints,
    slices, None, Ellipsis) as views, tensor indices among full slices as
    aten.index."""
    full = _expand(x, idx)
    if any(torch.is_tensor(i) for i in full):
        if not all(torch.is_tensor(i) or i == slice(None) for i in full):
            raise NotImplementedError(f"index {idx!r} in a fake-CUDA trace")
        return torch.ops.aten.index.Tensor(x, [i if torch.is_tensor(i) else None for i in full])
    out, dim = x, 0
    for i in full:
        if i is None:
            out, dim = out.unsqueeze(dim), dim + 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            start, stop, step = i.indices(out.shape[dim])
            out, dim = torch.ops.aten.slice.Tensor(out, dim, start, stop, step), dim + 1
        else:
            raise NotImplementedError(f"index {i!r} in a fake-CUDA trace")
    return out


class ViewIndexing(TorchFunctionMode):
    """Indexing, index assignment and ``contiguous`` as view ops and clones,
    so that a CPU-only torch traces them on fake CUDA tensors."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return _view(*args)
        if func is torch.Tensor.__setitem__:
            x, idx, value = args
            _view(x, idx).copy_(value)
            return None
        if func is torch.Tensor.contiguous:
            x = args[0]
            return x if x.is_contiguous() else x.clone(memory_format=torch.contiguous_format)
        return func(*args, **kwargs)


def _small_clip(monkeypatch):
    """The clip configs shrunk to a kernel-sized vision tower: width 128,
    2 heads (head dim 64), depth 2, 32 px."""
    from nextgen_uia_tpu_torch.models import clip as clip_mod

    full = clip_mod.clip_config

    def small(family, **kw):
        cfg = full(family, **kw)
        return cfg.replace(
            vision=dataclasses.replace(cfg.vision, image_size=IMG, width=128, depth=2, heads=2,
                                       proj_dim=64),
            text=dataclasses.replace(cfg.text, width=64, depth=1, heads=2, intermediate=128,
                                     embed_dim=64))

    monkeypatch.setattr(clip_mod, "clip_config", small)


def _served_cls_mona(monkeypatch, tmp_path):
    """The served BiomedCLIP cls forward with hybrid MONA, eval route."""
    from nextgen_uia_tpu_torch.adapters.mona import inject_mona

    _small_clip(monkeypatch)
    args = serve.predict_args("biomedclip", ["--task", "cls", "--images", "x", "--img_size",
                                             str(IMG), "--device", "cpu"])
    served = serve.build_served("biomedclip", args, "cpu", torch.Generator().manual_seed(0))
    inject_mona(torch.Generator().manual_seed(1), served.params["backbone"].visual, dim=128,
                variant="hybrid")
    return lambda x: served.forward(served.params, x), served.export_tree


def _composed_vit(monkeypatch, tmp_path):
    """A MONA ViT through the composed block route (no whole-block kernel:
    block_impl 'auto', as a train forward runs it), under no_grad."""
    from nextgen_uia_tpu_torch.adapters.mona import inject_mona
    from nextgen_uia_tpu_torch.models.vit import ViTConfig, vit_apply, vit_init

    cfg = ViTConfig(image_size=IMG, width=128, depth=2, heads=2, mona_variant="hybrid")
    vit = vit_init(torch.Generator().manual_seed(0), cfg)
    inject_mona(torch.Generator().manual_seed(1), vit, dim=128, variant="hybrid")

    def fn(x):
        images = (x.to(torch.float32) / 255.0).unsqueeze(-1).expand(-1, -1, -1, 3)
        return vit_apply(vit, cfg, images, dtype=torch.bfloat16)[0]

    return fn, vit


def _served_dino(monkeypatch, tmp_path):
    """The served DINOv2 seg forward, debug_tiny (head dim 16) in float32
    at 56 px: 17 tokens, so K5 takes the LayerNorm and q/k/v."""
    args = serve.predict_args("dino", ["--task", "seg", "--images", "x", "--debug_tiny",
                                       "--img_size", "56", "--compute_dtype", "float32",
                                       "--device", "cpu"])
    served = serve.build_served("dino", args, "cpu", torch.Generator().manual_seed(0))
    return lambda x: served.forward(served.params, x), served.export_tree


def _served_unet(monkeypatch, tmp_path):
    args = serve.predict_args("baselines", ["--task", "seg", "--init_channels", "2",
                                            "--images", "x", "--device", "cpu"])
    served = serve.build_served("baselines", args, "cpu", torch.Generator().manual_seed(0))
    return lambda x: served.forward(served.params, x), served.export_tree


FAKE_CASES = {  # case -> (model maker, image size, the nextgen_uia ops of its graph)
    "biomedclip_cls_mona": (_served_cls_mona, IMG, ["block_fwd", "mona_spatial"]),
    "composed_vit_mona": (_composed_vit, IMG, ["attn_o", "ln_mlp", "ln_qkv", "mona_spatial"]),
    "dino_seg": (_served_dino, 56, ["flash_fwd", "ln_qkv", "mlp"]),
    "unet_seg": (_served_unet, IMG, []),
}


def _counts():
    from nextgen_uia_tpu_torch.ops import (dwconv, flash_attention, fused_attn_o, fused_block,
                                           fused_ln_mlp, fused_ln_qkv, fused_mlp)

    return [f.launches for f in (fused_block.fused_block_infer, dwconv.mona_spatial,
                                 fused_ln_qkv.fused_ln_qkv, fused_attn_o.fused_attn_o_residual,
                                 flash_attention.flash_attention,
                                 fused_ln_mlp.fused_ln_mlp_residual, fused_mlp.fused_mlp)]


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_cuda_export_holds_the_kernel_ops(monkeypatch, tmp_path, case):
    make, size, want_ops = FAKE_CASES[case]
    fn, tree = make(monkeypatch, tmp_path)
    weights = serve.weight_tree(tree)
    x = torch.zeros(2, size, size, dtype=torch.uint8)
    cpu_program, _ = serve.export_forward(fn, tree, x, weights)
    want = cpu_program.module()(weights, x)
    assert registry.graph_ops(cpu_program.graph) == []  # the CPU route: plain versions

    built, counts = build.library.cache_info().currsize, _counts()
    with FakeTensorMode(allow_non_fake_inputs=True), ViewIndexing():
        fake_weights = torch.utils._pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"), weights)
        program, _ = serve.export_forward(fn, tree, torch.zeros(2, size, size, dtype=torch.uint8,
                                                                device="cuda"), fake_weights)
    assert registry.graph_ops(program.graph) == want_ops
    (out,) = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    val = out.meta["val"]
    assert val.device.type == "cuda"
    assert tuple(val.shape) == tuple(want.shape) and val.dtype == want.dtype
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    assert registry.graph_ops(torch.export.load(buf).graph) == want_ops
    assert build.library.cache_info().currsize == built and _counts() == counts
