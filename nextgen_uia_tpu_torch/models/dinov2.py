"""DINOv2 backbone and heads (counterpart of nextgen_uia_tpu/models/dinov2.py).

  - ViT-B/14 trained at 518 px (grid 37), evaluated at other sizes through
    DINO's bicubic positional-embedding interpolation;
  - LayerScale blocks (``ls1``/``ls2``, models/vit.py's LayerScale route:
    the flash-attention kernel K7 and the fused-MLP kernel K10), gelu MLP,
    final LayerNorm over all tokens;
  - ``get_intermediate_layers``: the last-n block outputs, final norm
    applied, as (patch tokens, cls token) in shallow-to-deep order;
  - heads: the 4-layer classification head, the linear decoder (1x1 conv +
    bilinear upsample) and the UNet decoder over 5 layers with skip convs
    and BatchNorm, whose running statistics are a module of buffers of its
    own (``unet_decoder_state``), saved beside the parameters.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (BatchNorm, BatchNormState, Conv, LayerNorm, Linear, batchnorm,
                         conv2d, conv2d_cat, conv_transpose2d, layernorm, linear, normal, param,
                         resize_bicubic, resize_bilinear, resize_bilinear_align_corners)
from ..ops import KERNELS
from .vit import Block, ViTConfig, block_apply

DINOV2_B14 = ViTConfig(image_size=518, patch_size=14, width=768, depth=12, heads=12, act="gelu",
                       proj_dim=None, ln_eps=1e-6)
DINOV2_S14 = dataclasses.replace(DINOV2_B14, width=384, depth=12, heads=6)
DINOV2_L14 = dataclasses.replace(DINOV2_B14, width=1024, depth=24, heads=16)
DINOV2_G14 = dataclasses.replace(DINOV2_B14, width=1536, depth=40, heads=24, ffn="swiglufused")

DINOV2_ARCHS = {"vit_small": DINOV2_S14, "vit_base": DINOV2_B14, "vit_large": DINOV2_L14,
                "vit_giant2": DINOV2_G14}


def dinov2_config(arch: str = "vit_base") -> ViTConfig:
    if arch not in DINOV2_ARCHS:
        raise ValueError(f"Unknown DINOv2 arch {arch!r}; choose from {sorted(DINOV2_ARCHS)}")
    return DINOV2_ARCHS[arch]


class DinoV2(nn.Module):
    """``dinov2_init``: patch conv (HWIO, bias), cls [D], pos [37^2 + 1, D],
    LayerScale blocks (ls1 = ls2 = 1e-5), final norm."""

    def __init__(self, gen, cfg: ViTConfig = DINOV2_B14):
        super().__init__()
        scale = cfg.width ** -0.5
        self.patch = Conv(gen, cfg.patch_size, cfg.patch_size, 3, cfg.width)
        self.cls = param(normal(gen, (cfg.width,), scale))
        self.pos = param(normal(gen, (cfg.seq_len, cfg.width), scale))
        self.blocks = nn.ModuleList(Block(gen, cfg, layerscale=1e-5) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.width)


def dinov2_init(gen: torch.Generator, cfg: ViTConfig = DINOV2_B14) -> DinoV2:
    return DinoV2(gen, cfg)


@functools.lru_cache(maxsize=16)
def _torch_bicubic_taps(n_in: int, n_out: int, scale: float):
    """Gather indices [n_out, 4] and weights of torch ``F.interpolate(mode=
    'bicubic')`` (align_corners=False, a = -0.75, border-replicated taps)
    with the explicit ``scale`` factor: src = (dst + 0.5) / scale - 0.5."""
    a = -0.75
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    offs = np.arange(-1, 3)
    idx = np.clip(i0[:, None] + offs[None, :], 0, n_in - 1)
    d = np.abs(t[:, None] - offs[None, :])
    w = np.where(d <= 1.0, (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0,
                 a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a)
    return idx, w.astype(np.float32)


def interp_pos(pos, grid_out: int, width: int):
    """DinoVisionTransformer.interpolate_pos_encoding: torch bicubic with
    DINO's +0.1 scale-factor offset, applied separably (rows, then
    columns); the CLS row is kept. Identity at the trained grid."""
    cls_pos, patch_pos = pos[:1], pos[1:]
    g0 = int(round(patch_pos.shape[0] ** 0.5))
    if g0 == grid_out:
        return pos
    idx, w = _torch_bicubic_taps(g0, grid_out, (grid_out + 0.1) / g0)
    idx, w = torch.from_numpy(idx).to(pos.device), torch.from_numpy(w).to(pos.device)
    grid = patch_pos.reshape(g0, g0, width).to(torch.float32)
    grid = torch.einsum("rt,rtcd->rcd", w, grid[idx])
    grid = torch.einsum("ct,rctd->rcd", w, grid[:, idx])
    return torch.cat([cls_pos, grid.reshape(grid_out * grid_out, width).to(pos.dtype)], dim=0)


def embed(p: DinoV2, cfg: ViTConfig, images, *, dtype=None):
    """images [B, H, W, 3] -> tokens [B, 1 + grid^2, D]."""
    grid = images.shape[1] // cfg.patch_size
    w = p.patch.w
    if dtype is not None:
        images, w = images.to(dtype), w.to(dtype)
    x = F.conv2d(images.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2) + p.patch.b.to(x.dtype)
    x = torch.cat([p.cls.to(x.dtype).expand(x.shape[0], 1, cfg.width), x], dim=1)
    return x + interp_pos(p.pos, grid, cfg.width).to(x.dtype)


def forward_features(p: DinoV2, images, cfg: ViTConfig = DINOV2_B14, *, dtype=None,
                     ops=KERNELS):
    """-> {'x_norm_clstoken': [B, D], 'x_norm_patchtokens': [B, N, D]}."""
    x = embed(p, cfg, images, dtype=dtype)
    for blk in p.blocks:
        x = block_apply(blk, x, cfg, dtype=dtype, ops=ops)
    x = layernorm(p.norm, x, eps=cfg.ln_eps)
    return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}


def get_intermediate_layers(p: DinoV2, images, n: int, cfg: ViTConfig = DINOV2_B14, *,
                            dtype=None, ops=KERNELS):
    """The last ``n`` block outputs with the final norm applied, as
    (patch_tokens, cls_token) tuples, shallow to deep."""
    x = embed(p, cfg, images, dtype=dtype)
    depth = len(p.blocks)
    outs = []
    for i, blk in enumerate(p.blocks):
        x = block_apply(blk, x, cfg, dtype=dtype, ops=ops)
        if i >= depth - n:
            outs.append(layernorm(p.norm, x, eps=cfg.ln_eps))
    return [(o[:, 1:], o[:, 0]) for o in outs]


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


class ClsHead(nn.Module):
    """``cls_head_init``: one linear (std 0.01) over 2D (1 layer) or 5D (4
    layers: four cls tokens and the last layer's mean patch token) inputs."""

    def __init__(self, gen, embed_dim: int, num_classes: int = 2, layers: int = 4):
        super().__init__()
        if layers not in (1, 4):
            raise ValueError("ClassificationHead supports layers in {1, 4}")
        in_dim = 2 * embed_dim if layers == 1 else 5 * embed_dim
        self.linear = Linear(gen, in_dim, num_classes, std=0.01)


def cls_head_apply(p: ClsHead, features, *, layers: int = 4):
    if layers == 1:
        feat = torch.cat([features["x_norm_clstoken"],
                          features["x_norm_patchtokens"].mean(dim=1)], dim=1)
    else:
        feat = torch.cat([features[i][1] for i in range(4)] + [features[3][0].mean(dim=1)],
                         dim=1)
    return linear(p.linear, feat)


class LinearDecoder(nn.Module):
    """``linear_decoder_init``: a 1x1 conv to the classes."""

    def __init__(self, gen, in_ch: int, num_classes: int = 2):
        super().__init__()
        self.conv = Conv(gen, 1, 1, in_ch, num_classes)


def linear_decoder_apply(p: LinearDecoder, patch_tokens, *, image_size: int,
                         patch_size: int = 14):
    g = image_size // patch_size
    b, _, c = patch_tokens.shape
    y = conv2d(p.conv, patch_tokens.reshape(b, g, g, c))
    return resize_bilinear(y, (image_size, image_size)).permute(0, 3, 1, 2)


def _unet_chans(embed_dim: int, num_classes: int):
    return [embed_dim, embed_dim // 2, embed_dim // 4, embed_dim // 8, num_classes]


class UNetDecoder(nn.Module):
    """``unet_decoder_init``'s parameters: up0..up3, each upconv (2x2,
    stride 2), conv (3x3 over the concat), conv_bn, skip_conv (3x3 from the
    encoder width), skip_bn."""

    def __init__(self, gen, embed_dim: int, num_classes: int = 2):
        super().__init__()
        chans = _unet_chans(embed_dim, num_classes)
        for i in range(4):
            up = nn.Module()
            up.upconv = Conv(gen, 2, 2, chans[i], chans[i + 1])
            up.conv = Conv(gen, 3, 3, chans[i + 1] * 2, chans[i + 1])
            up.conv_bn = BatchNorm(chans[i + 1])
            up.skip_conv = Conv(gen, 3, 3, embed_dim, chans[i + 1])
            up.skip_bn = BatchNorm(chans[i + 1])
            self.add_module(f"up{i}", up)


def unet_decoder_state(embed_dim: int, num_classes: int = 2) -> nn.Module:
    """The decoder's BatchNorm running statistics, the JAX package's state
    tree ``up{i}/{conv_bn,skip_bn}/{mean,var}`` as buffers."""
    chans = _unet_chans(embed_dim, num_classes)
    state = nn.Module()
    for i in range(4):
        st = nn.Module()
        st.conv_bn = BatchNormState(chans[i + 1])
        st.skip_bn = BatchNormState(chans[i + 1])
        state.add_module(f"up{i}", st)
    return state


def unet_decoder_apply(p: UNetDecoder, state, layer_feats, *, image_size: int,
                       patch_size: int = 14, train: bool = False, dtype=None):
    """layer_feats: 5 (patch_tokens, cls) tuples from get_intermediate_layers;
    the deepest is the trunk, layers 3..0 feed the skips. Train mode
    normalizes by the batch statistics and updates ``state`` in place.
    Returns NCHW float32 logits, bicubic-resized (jax.image.resize's
    antialiased bicubic) to image_size. ``dtype`` runs the decoder's
    activations in that type (the JAX package's --head_dtype)."""
    g = image_size // patch_size

    def to_map(i):
        t = layer_feats[i][0]
        t = t if dtype is None else t.to(dtype)
        return t.reshape(t.shape[0], g, g, t.shape[-1])

    x = to_map(4)
    skips = [to_map(3), to_map(2), to_map(1), to_map(0)]
    for i in range(4):
        up, st = getattr(p, f"up{i}"), getattr(state, f"up{i}")
        x = conv_transpose2d(up.upconv, x, stride=2, dtype=dtype)
        sk = torch.relu(batchnorm(up.skip_bn, st.skip_bn,
                                  conv2d(up.skip_conv, skips[i], dtype=dtype), train=train))
        sk = resize_bilinear_align_corners(sk, (x.shape[1], x.shape[2]))
        x = torch.relu(batchnorm(up.conv_bn, st.conv_bn, conv2d_cat(up.conv, x, sk, dtype=dtype),
                                 train=train))
    x = resize_bicubic(x.to(torch.float32), (image_size, image_size))
    return x.permute(0, 3, 1, 2)
