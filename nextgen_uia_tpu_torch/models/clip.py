"""CLIP assembly, vision side (counterpart of nextgen_uia_tpu/models/clip.py).

BiomedCLIP's image tower is the timm ViT-B/16. The PubMedBERT text tower
(``encode_text``) is not ported yet: ROADMAP.md, section A, item 10.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..nn.layers import param
from ..ops import KERNELS
from .vit import VIT_B16_TIMM, ViTConfig, vit_apply, vit_init

FAMILIES = ("biomedclip",)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    family: str
    vision: ViTConfig
    compute_dtype: str = "float32"      # 'bfloat16' for the serving path on the card

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def clip_config(family: str, *, compute_dtype: str = "float32",
                mona_variant: str = "hybrid") -> CLIPConfig:
    if family not in FAMILIES:
        raise NotImplementedError(
            f"CLIP family {family!r} is not ported yet (ROADMAP.md, section A, "
            f"item 10); ported: {FAMILIES}")
    vision = dataclasses.replace(VIT_B16_TIMM, mona_variant=mona_variant)
    return CLIPConfig(family, vision, compute_dtype=compute_dtype)


class CLIP(nn.Module):
    """``clip_init``'s tree without the text tower: visual, logit_scale."""

    def __init__(self, gen, cfg: CLIPConfig):
        super().__init__()
        self.visual = vit_init(gen, cfg.vision)
        self.logit_scale = param(torch.tensor(math.log(1.0 / 0.07)))


def clip_init(gen: torch.Generator, cfg: CLIPConfig) -> CLIP:
    return CLIP(gen, cfg)


def infer_cfg(cfg: CLIPConfig) -> CLIPConfig:
    """Forward-only variant of a config: every tower block runs through the
    whole-block kernel (ops/fused_block.py). Use it only on paths autograd
    never differentiates (eval, serving): that kernel has no backward."""
    return cfg.replace(vision=dataclasses.replace(cfg.vision, block_impl="fused_infer"))


def encode_image(params: CLIP, cfg: CLIPConfig, images, *, extract_layers=(), ops=KERNELS,
                 gen=None):
    """images [B, H, W, 3] -> ([B, embed], activations). ``gen``: the
    dropout generator of a train forward (None: eval)."""
    return vit_apply(params.visual, cfg.vision, images, dtype=cfg.dtype,
                     extract_layers=extract_layers, ops=ops, gen=gen)


def normalize(x, dim=-1, eps=1e-12):
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)
