"""Torch checkpoint converters for every backbone the reference loads: the
port's own copy of nextgen_uia_tpu/convert/torch_to_jax.py (numpy arrays,
the ResNet table from models/resnet.py; the two write equal ``.npz`` files).

Covers the checkpoint layouts the reference loads:
  - open_clip/timm BiomedCLIP (visual.trunk timm ViT + HF BERT text tower)
  - OpenAI CLIP jit archives / state dicts, also MetaCLIP and UniMedCLIP,
    which use the same module layout via open_clip
    (visual.transformer.resblocks); UniMedCLIP additionally strips a
    DataParallel ``module.`` prefix and keeps only visual weights
  - HF CLIPSeg decoder (CIDAS/clipseg-rd64-refined)
  - DINOv2 ViT-B/14 (dinov2_vitb14_pretrain.pth)
  - torchvision ResNets and CLIP's ModifiedResNet

All converters take a {name: array or tensor} state dict and return the
flat path -> numpy array dict that core/checkpoint.py reads, saved as .npz.
Weight layout rules: Linear [out,in] -> [in,out] transpose; Conv OIHW ->
HWIO; ConvTranspose [in,out,kh,kw] -> [kh,kw,in,out]; fused qkv split three
ways.

    python -m nextgen_uia_tpu_torch.convert <kind> src.pt dst.npz
"""

from __future__ import annotations

import numpy as np

from ..models.resnet import SPECS  # (block kind, blocks per stage) of each torchvision arch


def _lin(sd, name):
    out = {"w": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["b"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _conv(sd, name):
    out = {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["b"] = sd[f"{name}.bias"]
    return out


def _convT(sd, name):
    out = {"w": sd[f"{name}.weight"].transpose(2, 3, 0, 1)}
    if f"{name}.bias" in sd:
        out["b"] = sd[f"{name}.bias"]
    return out


def _split_qkv(w, b=None):
    """Fused [3D, D] qkv -> separate q/k/v in [in, out] layout."""
    d = w.shape[0] // 3
    out = {}
    for i, n in enumerate(("q", "k", "v")):
        out[n] = {"w": w[i * d:(i + 1) * d].T}
        if b is not None:
            out[n]["b"] = b[i * d:(i + 1) * d]
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                out.update(_flat(item, f"{key}/{i}"))
        else:
            out[key] = np.asarray(v)
    return out


def _numpy_sd(sd):
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# timm-style ViT trunk (BiomedCLIP visual, DINOv2 core layout)
# ---------------------------------------------------------------------------


def convert_timm_vit(sd, prefix="", depth=12, *, layerscale=False):
    """timm VisionTransformer (fused qkv) -> our vit params tree."""
    g = lambda n: sd[f"{prefix}{n}"]
    blocks = []
    for i in range(depth):
        b = f"{prefix}blocks.{i}."
        attn = _split_qkv(sd[b + "attn.qkv.weight"], sd.get(b + "attn.qkv.bias"))
        attn["o"] = {"w": sd[b + "attn.proj.weight"].T, "b": sd[b + "attn.proj.bias"]}
        if b + "mlp.w12.weight" in sd:  # SwiGLUFFNFused (DINOv2 giant2)
            mlp = {"w12": _lin(sd, b + "mlp.w12"), "w3": _lin(sd, b + "mlp.w3")}
        else:
            mlp = {"fc1": _lin(sd, b + "mlp.fc1"), "fc2": _lin(sd, b + "mlp.fc2")}
        blk = {
            "ln1": {"scale": sd[b + "norm1.weight"], "bias": sd[b + "norm1.bias"]},
            "attn": attn,
            "ln2": {"scale": sd[b + "norm2.weight"], "bias": sd[b + "norm2.bias"]},
            "mlp": mlp,
        }
        if layerscale:
            blk["ls1"] = sd[b + "ls1.gamma"]
            blk["ls2"] = sd[b + "ls2.gamma"]
        blocks.append(blk)
    tree = {
        "patch": {"w": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),
                  "b": g("patch_embed.proj.bias")},
        "cls": g("cls_token").reshape(-1),
        "pos": g("pos_embed").reshape(g("pos_embed").shape[-2], -1),
        "blocks": blocks,
        "norm": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    return tree


def convert_biomedclip(sd, depth=12, text_depth=12):
    """open_clip BiomedCLIP: visual.trunk (timm) + visual head proj + HF BERT
    text tower + mlp text proj + logit_scale."""
    sd = _numpy_sd(sd)
    visual = convert_timm_vit(sd, "visual.trunk.", depth)
    # open_clip TimmModel head: visual.head.proj Linear(768, 512, bias=False)
    for cand in ("visual.head.proj.weight", "visual.head.weight", "visual.proj"):
        if cand in sd:
            w = sd[cand]
            visual["proj"] = {"w": w.T if cand.endswith(".weight") else w}
            break

    t = "text.transformer."
    layers = []
    for i in range(text_depth):
        b = f"{t}encoder.layer.{i}."
        layers.append({
            "attn": {
                "q": _lin(sd, b + "attention.self.query"),
                "k": _lin(sd, b + "attention.self.key"),
                "v": _lin(sd, b + "attention.self.value"),
                "o": _lin(sd, b + "attention.output.dense"),
            },
            "attn_ln": _ln(sd, b + "attention.output.LayerNorm"),
            "ffn": {"fc1": _lin(sd, b + "intermediate.dense"),
                    "fc2": _lin(sd, b + "output.dense")},
            "ffn_ln": _ln(sd, b + "output.LayerNorm"),
        })
    text = {
        "embeddings": {
            "word": {"w": sd[t + "embeddings.word_embeddings.weight"]},
            "position": {"w": sd[t + "embeddings.position_embeddings.weight"]},
            "token_type": {"w": sd[t + "embeddings.token_type_embeddings.weight"]},
            "ln": _ln(sd, t + "embeddings.LayerNorm"),
        },
        "layers": layers,
        "proj": {"fc1": {"w": sd["text.proj.0.weight"].T},
                 "fc2": {"w": sd["text.proj.2.weight"].T}},
    }
    tree = {"visual": visual, "text": text}
    if "logit_scale" in sd:
        tree["logit_scale"] = sd["logit_scale"].reshape(())
    return _flat(tree)


# ---------------------------------------------------------------------------
# OpenAI-style CLIP (OpenAI / MetaCLIP / UniMedCLIP)
# ---------------------------------------------------------------------------


def _convert_openai_tower(sd, prefix, depth):
    blocks = []
    for i in range(depth):
        b = f"{prefix}resblocks.{i}."
        attn = _split_qkv(sd[b + "attn.in_proj_weight"], sd.get(b + "attn.in_proj_bias"))
        attn["o"] = {"w": sd[b + "attn.out_proj.weight"].T, "b": sd[b + "attn.out_proj.bias"]}
        blocks.append({
            "ln1": _ln(sd, b + "ln_1"),
            "attn": attn,
            "ln2": _ln(sd, b + "ln_2"),
            "mlp": {"fc1": _lin(sd, b + "mlp.c_fc"), "fc2": _lin(sd, b + "mlp.c_proj")},
        })
    return blocks


def convert_openai_clip(sd, depth=12, text_depth=12, *, strip_module=False,
                        visual_only=False):
    """OpenAI CLIP / MetaCLIP / UniMedCLIP state dict -> flat tree.

    strip_module handles DataParallel checkpoints (unimedclip/finetune.py:81);
    visual_only reproduces UniMedCLIP's visual-only filter (:86-88).
    """
    sd = _numpy_sd(sd)
    if strip_module:
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}

    visual = {
        "patch": {"w": sd["visual.conv1.weight"].transpose(2, 3, 1, 0)},
        "cls": sd["visual.class_embedding"].reshape(-1),
        "pos": sd["visual.positional_embedding"],
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": _convert_openai_tower(sd, "visual.transformer.", depth),
        "norm": _ln(sd, "visual.ln_post"),
        "proj": {"w": sd["visual.proj"]},  # stored [width, embed] = [in, out]
    }
    tree = {"visual": visual}
    if not visual_only and "token_embedding.weight" in sd:
        tree["text"] = {
            "token_embedding": {"w": sd["token_embedding.weight"]},
            "pos": sd["positional_embedding"],
            "blocks": _convert_openai_tower(sd, "transformer.", text_depth),
            "ln_final": _ln(sd, "ln_final"),
            "proj": {"w": sd["text_projection"]},
        }
    if "logit_scale" in sd:
        tree["logit_scale"] = sd["logit_scale"].reshape(())
    return _flat(tree)


# ---------------------------------------------------------------------------
# HF CLIPSeg decoder
# ---------------------------------------------------------------------------


def convert_pyramid_head(sd, *, num_layers=3, task="seg", cls_hidden=False,
                         prefix="", strip_clip=True):
    """Reference CLIPAdapter/TimmCLIPAdapter head weights -> our PyramidHead.

    Layout sources: openai_clip/clip_adapter.py:30-58 and
    timm/clip_adapter.py:29-56 — reduces.N, blocks.N.(0 LN, 1 fc1, 3 fc2),
    seg_head.1 conv, cls_head (timm: .3 linear; openai cls_hidden: .2 + .5).
    ``strip_clip`` drops the frozen clip_model.* entries (head-only
    checkpoints are what the reference training loop saves).
    """
    sd = _numpy_sd(sd)
    if strip_clip:
        sd = {k: v for k, v in sd.items() if not k.startswith("clip_model.")}
    flat = {}
    for i in range(num_layers):
        flat.update(_flat(_lin(sd, f"{prefix}reduces.{i}"), f"reduces/{i}"))
        flat.update(_flat(_ln(sd, f"{prefix}blocks.{i}.0"), f"blocks/{i}/ln"))
        flat.update(_flat(_lin(sd, f"{prefix}blocks.{i}.1"), f"blocks/{i}/fc1"))
        flat.update(_flat(_lin(sd, f"{prefix}blocks.{i}.3"), f"blocks/{i}/fc2"))
    if task == "seg":
        flat.update(_flat(_conv(sd, f"{prefix}seg_head.1"), "seg_head"))
    elif cls_hidden:
        flat.update(_flat(_lin(sd, f"{prefix}cls_head.2"), "cls_head/fc1"))
        flat.update(_flat(_lin(sd, f"{prefix}cls_head.5"), "cls_head/fc2"))
    else:
        flat.update(_flat(_lin(sd, f"{prefix}cls_head.3"), "cls_head"))
    return flat


def convert_clipseg_decoder(sd, depth=3):
    """HF CLIPSegForImageSegmentation (or bare decoder) state dict -> our
    clipseg decoder tree. Accepts keys with or without a 'decoder.' prefix."""
    sd = _numpy_sd(sd)
    if any(k.startswith("decoder.") for k in sd):
        sd = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    layers = []
    for i in range(depth):
        b = f"layers.{i}."
        layers.append({
            "attn": {"q": _lin(sd, b + "self_attn.q_proj"),
                     "k": _lin(sd, b + "self_attn.k_proj"),
                     "v": _lin(sd, b + "self_attn.v_proj"),
                     "o": _lin(sd, b + "self_attn.out_proj")},
            "ln1": _ln(sd, b + "layer_norm1"),
            "mlp": {"fc1": _lin(sd, b + "mlp.fc1"), "fc2": _lin(sd, b + "mlp.fc2")},
            "ln2": _ln(sd, b + "layer_norm2"),
        })
    tree = {
        "film_mul": _lin(sd, "film_mul"),
        "film_add": _lin(sd, "film_add"),
        "reduces": [_lin(sd, f"reduces.{i}") for i in range(depth)],
        "layers": layers,
        "trans_conv1": _conv(sd, "transposed_convolution.0"),
        "trans_up1": _convT(sd, "transposed_convolution.2"),
        "trans_up2": _convT(sd, "transposed_convolution.4"),
    }
    return _flat(tree)


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------


def convert_dinov2(sd, depth=None):
    """DINOv2 pretrain checkpoint (any size variant). Keys may carry the
    reference loader's remaps (dinov2.py:272-273) or be raw hub keys.
    depth=None infers the block count from the state dict, so the CLI works
    for vit_small/base/large/giant2 alike."""
    sd = _numpy_sd(sd)
    # normalize: strip 'encoder.'/'backbone.' prefixes, undo chunked-block
    # naming (BlockChunk pads with identities so the global index is the
    # SECOND numeric segment: 'blocks.<chunk>.<idx>.' -> 'blocks.<idx>.',
    # vision_transformer.py:142-148)
    import re as _re

    def norm_key(k):
        for p in ("encoder.", "backbone."):
            if k.startswith(p):
                k = k[len(p):]
        return _re.sub(r"^blocks\.\d+\.(\d+)\.", r"blocks.\1.", k)

    sd = {norm_key(k): v for k, v in sd.items()}
    if depth is None:
        idxs = [int(m.group(1)) for k in sd
                if (m := _re.match(r"blocks\.(\d+)\.", k))]
        if not idxs:
            raise ValueError(
                "convert_dinov2: no 'blocks.<i>.*' keys found — this does "
                "not look like a DINOv2 backbone state dict (got keys like "
                f"{sorted(sd)[:3]}...)")
        depth = 1 + max(idxs)
    tree = convert_timm_vit(sd, "", depth, layerscale=True)
    return _flat(tree)


# ---------------------------------------------------------------------------
# torchvision ResNet
# ---------------------------------------------------------------------------


def _bn(sd, name):
    return ({"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]},
            {"mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]})


def convert_resnet(sd, arch="resnet18"):
    """torchvision resnet state dict -> (flat params, flat state)."""
    sd = _numpy_sd(sd)
    kind, layout = SPECS[arch]
    p, s = {}, {}
    bnp, bns = _bn(sd, "bn1")
    p["stem"] = {"conv": {"w": sd["conv1.weight"].transpose(2, 3, 1, 0)}, "bn": bnp}
    s["stem"] = {"bn": bns}

    def conv_bn(conv_name, bn_name):
        bp, bs = _bn(sd, bn_name)
        return ({"conv": {"w": sd[conv_name + ".weight"].transpose(2, 3, 1, 0)}, "bn": bp},
                {"bn": bs})

    for stage, nblocks in enumerate(layout):
        ps, ss = [], []
        for bidx in range(nblocks):
            base = f"layer{stage+1}.{bidx}"
            bp, bs = {}, {}
            n_convs = 2 if kind == "basic" else 3
            for ci in range(1, n_convs + 1):
                bp[f"c{ci}"], bs[f"c{ci}"] = conv_bn(f"{base}.conv{ci}", f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in sd:
                bp["down"], bs["down"] = conv_bn(f"{base}.downsample.0", f"{base}.downsample.1")
            ps.append(bp)
            ss.append(bs)
        p[f"layer{stage+1}"] = ps
        s[f"layer{stage+1}"] = ss
    p["fc"] = _lin(sd, "fc")
    return _flat(p), _flat(s)


def convert_modified_resnet(sd, layers=None, prefix="visual."):
    """CLIP ModifiedResNet tower -> (flat params, flat state).

    Layout: the reference's src/third_party/openai_clip/model.py
    (Bottleneck :10-59, AttentionPool2d :62-99, ModifiedResNet :102-160).
    ``prefix`` defaults to the tower's keys inside a full CLIP state dict;
    pass "" for a standalone tower dict. ``layers=None`` infers the stage
    depths from the checkpoint keys (RN50 is (3,4,6,3)).
    """
    sd = _numpy_sd({k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)} if prefix else sd)
    if layers is None:
        if not any(k.startswith("layer1.") for k in sd):
            raise ValueError(
                "state dict has no layerN.* keys under prefix "
                f"{prefix!r} — not a ModifiedResNet tower (ViT CLIP "
                "checkpoints convert via the 'clip' kind)")
        layers = tuple(
            1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith(f"layer{st}."))
            for st in (1, 2, 3, 4))

    def conv_bn(conv_name, bn_name):
        bp, bs = _bn(sd, bn_name)
        return ({"conv": {"w": sd[conv_name + ".weight"].transpose(2, 3, 1, 0)},
                 "bn": bp}, {"bn": bs})

    p, s = {}, {}
    for i in (1, 2, 3):
        p[f"stem{i}"], s[f"stem{i}"] = conv_bn(f"conv{i}", f"bn{i}")
    for stage, nblocks in enumerate(layers):
        ps, ss = [], []
        for bidx in range(nblocks):
            base = f"layer{stage + 1}.{bidx}"
            bp, bs = {}, {}
            for ci in (1, 2, 3):
                bp[f"c{ci}"], bs[f"c{ci}"] = conv_bn(
                    f"{base}.conv{ci}", f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in sd:
                bp["down"], bs["down"] = conv_bn(
                    f"{base}.downsample.0", f"{base}.downsample.1")
            ps.append(bp)
            ss.append(bs)
        p[f"layer{stage + 1}"] = ps
        s[f"layer{stage + 1}"] = ss
    p["attnpool"] = {
        "pos": sd["attnpool.positional_embedding"],
        "q": _lin(sd, "attnpool.q_proj"),
        "k": _lin(sd, "attnpool.k_proj"),
        "v": _lin(sd, "attnpool.v_proj"),
        "c": _lin(sd, "attnpool.c_proj"),
    }
    return _flat(p), _flat(s)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def convert_dinov2_cls_head(sd, prefix=""):
    """DINOv2 ClassificationHead (dino/dinov2.py:33-100): a single Linear
    over concatenated cls/avg-patch features."""
    sd = _numpy_sd(sd)
    return _flat({"linear": _lin(sd, f"{prefix}linear")})


def convert_dinov2_linear_decoder(sd, prefix=""):
    """DINOv2 LinearDecoder (dino/dinov2.py:103-127): one 1x1 Conv2d."""
    sd = _numpy_sd(sd)
    return _flat({"conv": _conv(sd, f"{prefix}decoder")})


def convert_dinov2_unet_decoder(sd, prefix=""):
    """DINOv2 UNetDecoder (dino/dinov2.py:130-200): 4 up blocks of
    (ConvTranspose2d upconv, conv3x3+BN, skip conv3x3+BN). Reference up1..4
    map to our up0..3. Returns (flat params, flat bn state)."""
    sd = _numpy_sd(sd)
    p, s = {}, {}
    for i in range(4):
        b = f"{prefix}up{i + 1}."
        cbp, cbs = _bn(sd, b + "conv.1")
        sbp, sbs = _bn(sd, b + "skip_conv.1")
        p[f"up{i}"] = {"upconv": _convT(sd, b + "upconv"),
                       "conv": _conv(sd, b + "conv.0"), "conv_bn": cbp,
                       "skip_conv": _conv(sd, b + "skip_conv.0"),
                       "skip_bn": sbp}
        s[f"up{i}"] = {"conv_bn": cbs, "skip_bn": sbs}
    return _flat(p), _flat(s)


def convert_unet(sd, prefix=""):
    """Baseline UNet (third_party/unet.py:119-143) -> (flat params, flat bn
    state). ConvBlock Sequential indices: 0 conv1, 1 bn1, 4 conv2, 5 bn2."""
    sd = _numpy_sd(sd)

    def convblock(base):
        b1p, b1s = _bn(sd, base + ".1")
        b2p, b2s = _bn(sd, base + ".5")
        return ({"conv1": _conv(sd, base + ".0"), "bn1": b1p,
                 "conv2": _conv(sd, base + ".4"), "bn2": b2p},
                {"bn1": b1s, "bn2": b2s})

    p, s = {}, {}
    p["enc0"], s["enc0"] = convblock(f"{prefix}encoder.in_conv.conv_conv")
    for i in range(1, 5):
        p[f"enc{i}"], s[f"enc{i}"] = convblock(
            f"{prefix}encoder.down{i}.maxpool_conv.1.conv_conv")
    for i in range(4):
        # UpBlock bilinear=True default: conv1x1 + parameter-free Upsample
        p[f"upconv{i}"] = _conv(sd, f"{prefix}decoder.up{i + 1}.conv1x1")
        p[f"dec{i}"], s[f"dec{i}"] = convblock(
            f"{prefix}decoder.up{i + 1}.conv.conv_conv")
    p["out"] = _conv(sd, f"{prefix}decoder.out_conv")
    return _flat(p), _flat(s)


CONVERTERS = {
    "biomedclip": convert_biomedclip,
    "openai_clip": convert_openai_clip,
    "metaclip": convert_openai_clip,
    "unimedclip": lambda sd: convert_openai_clip(sd, strip_module=True, visual_only=True),
    "clipseg_decoder": convert_clipseg_decoder,
    "dinov2": convert_dinov2,
    "pyramid_head_seg": lambda sd: convert_pyramid_head(sd, task="seg"),
    "pyramid_head_cls": lambda sd: convert_pyramid_head(sd, task="cls"),
    "pyramid_head_cls_hidden": lambda sd: convert_pyramid_head(
        sd, task="cls", cls_hidden=True),
    "dinov2_cls_head": convert_dinov2_cls_head,
    "dinov2_linear_decoder": convert_dinov2_linear_decoder,
}

# converters that return (params, state) pairs — state rides under __state__/
STATEFUL_CONVERTERS = {
    "unet": convert_unet,
    "dinov2_unet_decoder": convert_dinov2_unet_decoder,
}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser("nextgen_uia_tpu_torch.convert")
    ap.add_argument("kind", choices=list(CONVERTERS) + list(STATEFUL_CONVERTERS)
                    + ["modified_resnet", *SPECS])
    ap.add_argument("src", help=".pt/.pth/.bin state dict or torch.jit archive")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)

    import torch

    try:
        sd = torch.load(args.src, map_location="cpu", weights_only=True)
    except Exception:
        try:
            sd = torch.jit.load(args.src, map_location="cpu").state_dict()
        except Exception:
            sd = torch.load(args.src, map_location="cpu", weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]

    if args.kind.startswith("resnet"):
        flat, state = convert_resnet(sd, args.kind)
        flat.update({f"__state__/{k}": v for k, v in state.items()})
    elif args.kind == "modified_resnet":
        prefix = "visual." if any(k.startswith("visual.") for k in sd) else ""
        flat, state = convert_modified_resnet(sd, prefix=prefix)
        flat.update({f"__state__/{k}": v for k, v in state.items()})
    elif args.kind in STATEFUL_CONVERTERS:
        flat, state = STATEFUL_CONVERTERS[args.kind](sd)
        flat.update({f"__state__/{k}": v for k, v in state.items()})
    else:
        flat = CONVERTERS[args.kind](sd)
    np.savez(args.dst, **flat)
    print(f"Wrote {len(flat)} tensors to {args.dst}")


if __name__ == "__main__":
    main()
