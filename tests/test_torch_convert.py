"""The port's checkpoint converter (nextgen_uia_tpu_torch/convert) against the
JAX package's, on the CPU.

(a) Every converter kind on a seeded synthetic state dict, saved with
``torch.save`` and converted by both packages' ``main``: the two ``.npz``
files hold the same keys and bitwise equal arrays; (b) an HF ``BertModel``
converted by the port and run by its ``bert_apply`` (the frozen kernels'
plain versions and the ``mlp_impl='xla'`` layer) against HF within 2e-4;
(c) ``main``'s load order: a state dict, one wrapped under
``state_dict``, and a pickled module, each loading whole into the port's
OpenAI-layout CLIP.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nextgen_uia_tpu.convert import torch_to_jax as jax_convert
from nextgen_uia_tpu_torch.convert import torch_to_npz as C
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.models import bert
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.models.resnet import SPECS
from nextgen_uia_tpu_torch.nn.layers import gelu

D, H, P, E = 8, 32, 2, 4   # width, MLP hidden (4 D), patch, embedding: toy sizes


class _Draw:
    """Seeded float32 tensors, one new draw per call."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape):
        return torch.from_numpy(self.rng.standard_normal(shape).astype(np.float32))


def _ln(sd, t, name, d=D):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = t(d), t(d)


def _lin(sd, t, name, d_in=D, d_out=D, bias=True):
    sd[f"{name}.weight"] = t(d_out, d_in)
    if bias:
        sd[f"{name}.bias"] = t(d_out)


def _bn(sd, t, name, c=D):
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{name}.{k}"] = t(c)


def _timm_trunk(sd, t, prefix, depth, *, layerscale=False, block_name=lambda i: f"blocks.{i}"):
    sd[prefix + "patch_embed.proj.weight"] = t(D, 3, P, P)
    sd[prefix + "patch_embed.proj.bias"] = t(D)
    sd[prefix + "cls_token"] = t(1, 1, D)
    sd[prefix + "pos_embed"] = t(1, 5, D)
    for i in range(depth):
        b = f"{prefix}{block_name(i)}."
        _lin(sd, t, b + "attn.qkv", D, 3 * D)
        _lin(sd, t, b + "attn.proj")
        _ln(sd, t, b + "norm1")
        _ln(sd, t, b + "norm2")
        _lin(sd, t, b + "mlp.fc1", D, H)
        _lin(sd, t, b + "mlp.fc2", H, D)
        if layerscale:
            sd[b + "ls1.gamma"], sd[b + "ls2.gamma"] = t(D), t(D)
    _ln(sd, t, prefix + "norm")


def _openai_tower(sd, t, prefix, depth):
    for i in range(depth):
        b = f"{prefix}resblocks.{i}."
        sd[b + "attn.in_proj_weight"], sd[b + "attn.in_proj_bias"] = t(3 * D, D), t(3 * D)
        _lin(sd, t, b + "attn.out_proj")
        _ln(sd, t, b + "ln_1")
        _ln(sd, t, b + "ln_2")
        _lin(sd, t, b + "mlp.c_fc", D, H)
        _lin(sd, t, b + "mlp.c_proj", H, D)


def _openai_clip(t, depth=12, prefix=""):
    sd = {}
    sd["visual.conv1.weight"] = t(D, 3, P, P)
    sd["visual.class_embedding"] = t(D)
    sd["visual.positional_embedding"] = t(5, D)
    _ln(sd, t, "visual.ln_pre")
    _openai_tower(sd, t, "visual.transformer.", depth)
    _ln(sd, t, "visual.ln_post")
    sd["visual.proj"] = t(D, E)
    sd["token_embedding.weight"] = t(30, D)
    sd["positional_embedding"] = t(7, D)
    _openai_tower(sd, t, "transformer.", depth)
    _ln(sd, t, "ln_final")
    sd["text_projection"] = t(D, E)
    sd["logit_scale"] = t(1)[0]
    return {prefix + k: v for k, v in sd.items()}


def _biomedclip(t):
    sd = {}
    _timm_trunk(sd, t, "visual.trunk.", 12)
    sd["visual.head.proj.weight"] = t(E, D)
    tt = "text.transformer."
    for name, rows in (("word", 30), ("position", 9), ("token_type", 2)):
        sd[f"{tt}embeddings.{name}_embeddings.weight"] = t(rows, D)
    _ln(sd, t, tt + "embeddings.LayerNorm")
    for i in range(12):
        b = f"{tt}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            _lin(sd, t, b + "attention.self." + n)
        _lin(sd, t, b + "attention.output.dense")
        _ln(sd, t, b + "attention.output.LayerNorm")
        _lin(sd, t, b + "intermediate.dense", D, H)
        _lin(sd, t, b + "output.dense", H, D)
        _ln(sd, t, b + "output.LayerNorm")
    sd["text.proj.0.weight"], sd["text.proj.2.weight"] = t(6, D), t(E, 6)
    sd["logit_scale"] = t(1)[0]
    return sd


def _clipseg(t):
    sd = {"clip.text_projection.weight": t(D, D)}  # not the decoder's: dropped
    _lin(sd, t, "decoder.film_mul", E, D)
    _lin(sd, t, "decoder.film_add", E, D)
    for i in range(3):
        _lin(sd, t, f"decoder.reduces.{i}", 6, D)
        b = f"decoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, t, b + "self_attn." + n)
        _ln(sd, t, b + "layer_norm1")
        _ln(sd, t, b + "layer_norm2")
        _lin(sd, t, b + "mlp.fc1", D, H)
        _lin(sd, t, b + "mlp.fc2", H, D)
    sd["decoder.transposed_convolution.0.weight"] = t(D, D, 3, 3)
    sd["decoder.transposed_convolution.0.bias"] = t(D)
    sd["decoder.transposed_convolution.2.weight"] = t(D, 4, 2, 2)   # [in, out, kh, kw]
    sd["decoder.transposed_convolution.2.bias"] = t(4)
    sd["decoder.transposed_convolution.4.weight"] = t(4, 1, 2, 2)
    sd["decoder.transposed_convolution.4.bias"] = t(1)
    return sd


def _dinov2(t):
    # BlockChunk naming (blocks.<chunk>.<index>.) under a 'backbone.' prefix
    sd = {}
    _timm_trunk(sd, t, "backbone.", 4, layerscale=True,
                block_name=lambda i: f"blocks.{i // 2}.{i}")
    sd["backbone.mask_token"] = t(1, D)
    return sd


def _pyramid_head(t, cls_head):
    sd = {"clip_model.visual.proj": t(D, E)}
    for i in range(3):
        _lin(sd, t, f"reduces.{i}", D, 6)
        _ln(sd, t, f"blocks.{i}.0", 6)
        _lin(sd, t, f"blocks.{i}.1", 6, 12)
        _lin(sd, t, f"blocks.{i}.3", 12, 6)
    if cls_head == "seg":
        sd["seg_head.1.weight"], sd["seg_head.1.bias"] = t(2, 6, 3, 3), t(2)
    elif cls_head == "hidden":
        _lin(sd, t, "cls_head.2", 6, 12)
        _lin(sd, t, "cls_head.5", 12, 3)
    else:
        _lin(sd, t, "cls_head.3", 6, 3)
    return sd


def _conv(sd, t, name, cin=D, cout=D, k=3, bias=True):
    sd[f"{name}.weight"] = t(cout, cin, k, k)
    if bias:
        sd[f"{name}.bias"] = t(cout)


def _unet_decoder(t):
    sd = {}
    for i in range(1, 5):
        b = f"up{i}."
        sd[b + "upconv.weight"], sd[b + "upconv.bias"] = t(D, 4, 2, 2), t(4)
        _conv(sd, t, b + "conv.0")
        _bn(sd, t, b + "conv.1")
        _conv(sd, t, b + "skip_conv.0")
        _bn(sd, t, b + "skip_conv.1")
    return sd


def _unet(t):
    sd = {}

    def convblock(base):
        _conv(sd, t, base + ".0")
        _bn(sd, t, base + ".1")
        _conv(sd, t, base + ".4")
        _bn(sd, t, base + ".5")

    convblock("encoder.in_conv.conv_conv")
    for i in range(1, 5):
        convblock(f"encoder.down{i}.maxpool_conv.1.conv_conv")
        _conv(sd, t, f"decoder.up{i}.conv1x1", k=1)
        convblock(f"decoder.up{i}.conv.conv_conv")
    _conv(sd, t, "decoder.out_conv", cout=2, k=1)
    return sd


def _resnet(t, arch):
    kind, layout = SPECS[arch]
    sd = {}
    _conv(sd, t, "conv1", 3, D, 7, bias=False)
    _bn(sd, t, "bn1")
    for stage, nblocks in enumerate(layout):
        for b in range(nblocks):
            base = f"layer{stage + 1}.{b}"
            for ci in range(1, (2 if kind == "basic" else 3) + 1):
                _conv(sd, t, f"{base}.conv{ci}", bias=False)
                _bn(sd, t, f"{base}.bn{ci}")
            if b == 0 and (stage > 0 or kind == "bottleneck"):
                _conv(sd, t, f"{base}.downsample.0", k=1, bias=False)
                _bn(sd, t, f"{base}.downsample.1")
    _lin(sd, t, "fc", D, 3)
    return sd


def _modified_resnet(t):
    sd = {}
    for i in (1, 2, 3):
        _conv(sd, t, f"visual.conv{i}", bias=False)
        _bn(sd, t, f"visual.bn{i}")
    for stage, nblocks in enumerate((1, 2, 1, 1)):
        for b in range(nblocks):
            base = f"visual.layer{stage + 1}.{b}"
            for ci in (1, 2, 3):
                _conv(sd, t, f"{base}.conv{ci}", bias=False)
                _bn(sd, t, f"{base}.bn{ci}")
            if b == 0:
                _conv(sd, t, f"{base}.downsample.0", k=1, bias=False)
                _bn(sd, t, f"{base}.downsample.1")
    sd["visual.attnpool.positional_embedding"] = t(5, D)
    for n in "qkvc":
        _lin(sd, t, f"visual.attnpool.{n}_proj")
    sd["token_embedding.weight"] = t(30, D)  # the text tower: not the converter's
    return sd


STATE_DICTS = {
    "biomedclip": _biomedclip,
    "openai_clip": _openai_clip,
    "metaclip": _openai_clip,
    "unimedclip": lambda t: _openai_clip(t, prefix="module."),
    "clipseg_decoder": _clipseg,
    "dinov2": _dinov2,
    "pyramid_head_seg": lambda t: _pyramid_head(t, "seg"),
    "pyramid_head_cls": lambda t: _pyramid_head(t, "cls"),
    "pyramid_head_cls_hidden": lambda t: _pyramid_head(t, "hidden"),
    "dinov2_cls_head": lambda t: {"linear.weight": t(3, 2 * D), "linear.bias": t(3)},
    "dinov2_linear_decoder": lambda t: {"decoder.weight": t(2, D, 1, 1), "decoder.bias": t(2)},
    "unet": _unet,
    "dinov2_unet_decoder": _unet_decoder,
    "modified_resnet": _modified_resnet,
    **{arch: (lambda a: lambda t: _resnet(t, a))(arch) for arch in SPECS},
}


def test_every_kind_is_covered():
    kinds = set(jax_convert.CONVERTERS) | set(jax_convert.STATEFUL_CONVERTERS)
    kinds |= {"modified_resnet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"}
    assert set(STATE_DICTS) == kinds
    assert set(C.CONVERTERS) == set(jax_convert.CONVERTERS)
    assert set(C.STATEFUL_CONVERTERS) == set(jax_convert.STATEFUL_CONVERTERS)


@pytest.mark.parametrize("kind", sorted(STATE_DICTS))
def test_both_converters_write_equal_npz(tmp_path, capsys, kind):
    src = tmp_path / "src.pt"
    torch.save(STATE_DICTS[kind](_Draw(sorted(STATE_DICTS).index(kind))), src)
    jax_convert.main([kind, str(src), str(tmp_path / "jax.npz")])
    C.main([kind, str(src), str(tmp_path / "port.npz")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(" to ")[0] == lines[1].split(" to ")[0]  # "Wrote N tensors"
    want, got = (ckpt.load_flat(str(tmp_path / f)) for f in ("jax.npz", "port.npz"))
    assert len(got) > 0 and sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        assert got[key].tobytes() == arr.tobytes(), key
    if kind == "unimedclip":  # module. stripped, the visual tower only
        assert all(k.startswith("visual/") or k == "logit_scale" for k in got)
    if kind == "dinov2":  # chunked block names normalised, depth inferred
        assert {k.split("/")[1] for k in got if k.startswith("blocks/")} == {"0", "1", "2", "3"}


@pytest.mark.parametrize("mlp_impl", ["auto", "xla"])
def test_bert_conversion_golden(mlp_impl):
    """HF BertModel -> the port's converter -> the port's ``bert_apply``:
    with identity projections the output is gelu of HF's CLS state."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(2)
    hf = transformers.BertModel(
        transformers.BertConfig(vocab_size=60, hidden_size=32, num_hidden_layers=2,
                                num_attention_heads=4, intermediate_size=64,
                                max_position_embeddings=20),
        add_pooling_layer=False).eval()
    ids = torch.randint(1, 59, (2, 10))
    ids[1, 6:] = 0  # the padding id: masked for HF, -1e9 key bias in the port
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=(ids != 0).long()).last_hidden_state[:, 0]

    sd = {f"text.transformer.{k}": v for k, v in hf.state_dict().items()}
    sd["text.proj.0.weight"] = torch.eye(32)
    sd["text.proj.2.weight"] = torch.eye(32)
    trunk = {k: v for k, v in _biomedclip(_Draw(0)).items() if k.startswith("visual.")}
    flat = {k[len("text/"):]: v for k, v in C.convert_biomedclip(
        {**sd, **trunk}, depth=12, text_depth=2).items() if k.startswith("text/")}

    cfg = bert.BertConfig(vocab_size=60, width=32, depth=2, heads=4, intermediate=64,
                          max_positions=20, embed_dim=32, context_length=10, mlp_impl=mlp_impl)
    tower = bert.bert_init(torch.Generator().manual_seed(0), cfg)
    _, n = ckpt.merge_flat(flat, tower)
    assert n == len(flat) == len(tower.state_dict())
    with torch.no_grad():
        out = bert.bert_apply(tower, cfg, ids)
    np.testing.assert_allclose(out.numpy(), gelu(ref).numpy(), atol=2e-4, rtol=2e-4)


class _Wrapper(torch.nn.Module):
    """A pickled module, whose state dict ``main`` takes."""

    def __init__(self, sd):
        super().__init__()
        for k, v in sd.items():
            self.register_buffer(k.replace(".", "__"), v)

    def state_dict(self, *args, **kwargs):
        return {k.replace("__", "."): v for k, v in super().state_dict(*args, **kwargs).items()}


@pytest.mark.parametrize("form", ["state_dict", "wrapped", "module"])
def test_main_round_trips_a_torch_save_file(tmp_path, form):
    """A tiny OpenAI-layout CLIP saved by ``torch.save`` (a state dict, one
    under 'state_dict', a pickled module): ``main`` converts it and every
    tensor of the port's CLIP at the same sizes loads from it, equal to the
    source after the layout rules."""
    depth = 12  # the 'openai_clip' kind converts 12 blocks a tower
    sd = _openai_clip(_Draw(5), depth=depth)
    obj = {"state_dict": sd, "wrapped": {"state_dict": sd, "epoch": 3},
           "module": _Wrapper(sd)}[form]
    torch.save(obj, tmp_path / "src.pt")
    C.main(["openai_clip", str(tmp_path / "src.pt"), str(tmp_path / "out.npz")])

    cfg = clip_mod.clip_config("openai")
    cfg = cfg.replace(
        vision=dataclasses.replace(cfg.vision, image_size=4, patch_size=P, width=D, depth=depth,
                                   heads=2, proj_dim=E),
        text=dataclasses.replace(cfg.text, context_length=7, vocab_size=30, width=D,
                                 depth=depth, heads=2, embed_dim=E))
    model = clip_mod.clip_init(torch.Generator().manual_seed(0), cfg)
    saved = ckpt.load_flat(str(tmp_path / "out.npz"))
    _, n = ckpt.load_into(str(tmp_path / "out.npz"), model)
    assert n == len(saved) == len(model.state_dict())
    blk = model.visual.blocks[1]
    w = sd["visual.transformer.resblocks.1.attn.in_proj_weight"]
    np.testing.assert_array_equal(blk.attn.k.w.numpy(), w[D:2 * D].T.numpy())
    np.testing.assert_array_equal(model.visual.patch.w.numpy(),
                                  sd["visual.conv1.weight"].permute(2, 3, 1, 0).numpy())
