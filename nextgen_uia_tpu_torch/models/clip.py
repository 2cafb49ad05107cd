"""CLIP assembly (counterpart of nextgen_uia_tpu/models/clip.py).

  family       vision layout            text tower
  ----------   ----------------------   ---------------------------------
  biomedclip   timm ViT-B/16 (gelu)     PubMedBERT + MLP proj, ctx 256
  openai       OpenAI ViT-B/16 (qgelu)  CLIP text transformer, BPE, ctx 77
  metaclip     OpenAI ViT-B/16 (qgelu)  CLIP text transformer, BPE, ctx 77
  unimedclip   OpenAI ViT-B/16 (qgelu)  CLIP text transformer, ctx 77 (*)

(*) UniMedCLIP's text weights are never loaded by the reference: the tower
exists and holds converted weights only if they are given. Its tokenizer is
BiomedBERT's where cached, else the CLIP BPE (tasks/common.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..nn.layers import param
from ..ops import KERNELS
from .bert import BertConfig, bert_apply, bert_init
from .text_clip import TextConfig, text_apply, text_init
from .vit import VIT_B16_OPENAI, VIT_B16_TIMM, ViTConfig, vit_apply, vit_init

FAMILIES = ("biomedclip", "openai", "metaclip", "unimedclip")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    family: str
    vision: ViTConfig
    compute_dtype: str = "float32"      # 'bfloat16' for the paths on the card
    text_kind: str = "bert"             # 'clip' | 'bert'
    text: TextConfig | BertConfig | None = None

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def clip_config(family: str, *, compute_dtype: str = "float32", mona_variant: str = "hybrid",
                lora_alpha: float = 32.0, lora_dropout: float = 0.0) -> CLIPConfig:
    if family not in FAMILIES:
        raise ValueError(f"Unknown CLIP family {family!r}; choose from {FAMILIES}")
    adapters = dict(mona_variant=mona_variant, lora_alpha=lora_alpha, lora_dropout=lora_dropout)
    if family == "biomedclip":
        return CLIPConfig(family, dataclasses.replace(VIT_B16_TIMM, **adapters),
                          compute_dtype=compute_dtype, text_kind="bert",
                          text=BertConfig(lora_alpha=lora_alpha, lora_dropout=lora_dropout))
    return CLIPConfig(family, dataclasses.replace(VIT_B16_OPENAI, **adapters),
                      compute_dtype=compute_dtype, text_kind="clip", text=TextConfig())


class CLIP(nn.Module):
    """``clip_init``'s tree: visual, text (the CLIP text tower, or BERT for
    BiomedCLIP), logit_scale."""

    def __init__(self, gen, cfg: CLIPConfig):
        super().__init__()
        self.visual = vit_init(gen, cfg.vision)
        if cfg.text is not None:
            self.text = (bert_init if cfg.text_kind == "bert" else text_init)(gen, cfg.text)
        self.logit_scale = param(torch.tensor(math.log(1.0 / 0.07)))


def clip_init(gen: torch.Generator, cfg: CLIPConfig) -> CLIP:
    return CLIP(gen, cfg)


def infer_cfg(cfg: CLIPConfig, *, vision: bool = True, text: bool = True) -> CLIPConfig:
    """Forward-only variant of a config: the chosen towers' blocks run
    through the whole-block kernel (ops/fused_block.py; LoRA blocks decline
    it; BERT's layers take it only where opted in, models/bert.py). Use it
    only on paths autograd never differentiates (eval, serving, the frozen
    text tower): that kernel has no backward. A tower at ``mlp_impl='xla'``
    (full fine-tuning) keeps its plain routes: each tower's block gates the
    kernel on ``mlp_impl == 'auto'``, as in the JAX package."""
    kw = {}
    if vision:
        kw["vision"] = dataclasses.replace(cfg.vision, block_impl="fused_infer")
    if text and cfg.text is not None:
        kw["text"] = dataclasses.replace(cfg.text, block_impl="fused_infer")
    return cfg.replace(**kw)


def encode_image(params: CLIP, cfg: CLIPConfig, images, *, extract_layers=(), ops=KERNELS,
                 gen=None):
    """images [B, H, W, 3] -> ([B, embed], activations). ``gen``: the
    dropout generator of a train forward (None: eval)."""
    return vit_apply(params.visual, cfg.vision, images, dtype=cfg.dtype,
                     extract_layers=extract_layers, ops=ops, gen=gen)


def encode_text(params: CLIP, cfg: CLIPConfig, token_ids, *, ops=KERNELS, gen=None):
    """token_ids [B, L] -> [B, embed]. ``gen``: the dropout generator of a
    train forward through BERT's LoRA pairs (None: eval); the CLIP text
    tower carries no LoRA."""
    if cfg.text_kind == "bert":
        return bert_apply(params.text, cfg.text, token_ids, dtype=cfg.dtype, ops=ops, gen=gen)
    return text_apply(params.text, cfg.text, token_ids, dtype=cfg.dtype, ops=ops)


def normalize(x, dim=-1, eps=1e-12):
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)
