"""The system under test for ``biomedclip_mona``: the port's BiomedCLIP with
hybrid MONA in every block, built through its normal path (``clip_config``,
``clip_init``, ``inject_mona``, ``partition``), the benchmark's seeded
weights loaded through the module's own ``load_state_dict`` and the frozen
tensors rounded to bf16 values, as the port's CLIs and bench do.

- ``Train``: the MONA contrastive fine-tune step (``TrainStep`` over
  ``encode_image`` and ``info_nce`` against text features cached once
  through the frozen PubMedBERT tower by ``make_text_encoder``).
- ``Infer``: zero-shot logits (``make_zero_shot_logits_fn``) against seeded
  L2-normalised prompt features.
"""

from __future__ import annotations

import dataclasses

import torch

from nextgen_uia_tpu_torch.adapters.mona import inject_mona
from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import by_keywords, partition
from nextgen_uia_tpu_torch.losses import info_nce
from nextgen_uia_tpu_torch.models import clip as clip_mod
from nextgen_uia_tpu_torch.tasks import prompts as PR
from nextgen_uia_tpu_torch.tasks.clip_finetune import make_text_encoder
from nextgen_uia_tpu_torch.tasks.clip_tasks import make_zero_shot_logits_fn

from benchmark import harness as H
from benchmark.reference import biomedclip_mona as R


def port_config(s: dict, *, text: bool = True) -> clip_mod.CLIPConfig:
    cfg = clip_mod.clip_config("biomedclip", compute_dtype=s["compute_dtype"],
                               mona_variant=s["mona_variant"])
    vision = dataclasses.replace(cfg.vision, image_size=s["image_size"],
                                 patch_size=s["patch_size"], width=s["width"],
                                 depth=s["depth"], heads=s["heads"],
                                 mlp_ratio=s["mlp_dim"] / s["width"], proj_dim=s["embed_dim"],
                                 ln_eps=s["ln_eps"], act=s["act"])
    bert = dataclasses.replace(cfg.text, vocab_size=s["vocab_size"], width=s["text_width"],
                               depth=s["text_depth"], heads=s["text_heads"],
                               intermediate=s["text_intermediate"],
                               max_positions=s["max_positions"], type_vocab=s["type_vocab"],
                               context_length=s["context_length"], embed_dim=s["embed_dim"],
                               ln_eps=s["text_ln_eps"])
    return cfg.replace(vision=vision, text=bert if text else None)


def build_model(s: dict, weights: dict, device, *, text: bool = True):
    """(cfg, CLIP module on ``device`` holding ``weights``, trainable dict):
    the skeleton made on the meta device, then the weights loaded whole."""
    cfg = port_config(s, text=text)
    with torch.device("meta"):
        params = clip_mod.clip_init(torch.Generator(), cfg)
        inject_mona(torch.Generator(), params.visual, dim=s["width"],
                    bottleneck=s["mona_bottleneck"], variant=s["mona_variant"])
    params = params.to_empty(device=device)
    params.load_state_dict(weights, strict=True)
    trainable, frozen = partition(params, by_keywords("mona"))
    with torch.no_grad():
        for p in frozen.values():
            p.copy_(H.bf16_round(p))
    return cfg, params, trainable


def images_per_step(s: dict, traffic: dict) -> int:
    return traffic["batch"]


def train_inputs(s: dict, traffic: dict, seed: int, device) -> dict:
    """The pool: float images [P, B, S, S, 3] in [0, 1] and token ids
    [P, B, ctx] in [1, 30000), every row drawn apart, from the seed."""
    p, b, n = traffic["pool"], traffic["batch"], s["image_size"]
    gen = H.generator(seed, 1, device)
    images = torch.rand((p, b, n, n, 3), generator=gen, device=device)
    tokens = torch.randint(1, 30000, (p, b, s["context_length"]), generator=gen, device=device)
    return {"images": images, "tokens": tokens}


class Train:
    """The fine-tune step on pool batch ``i % P`` (``step``) and the objects
    the checks read (``train_step``, ``leaves``, ``gen``)."""

    def __init__(self, s: dict, traffic: dict, seed: int, device):
        self.s, self.traffic, self.device = s, traffic, device
        weights = H.make_weights(R.param_spec(s), seed, device)
        self.cfg, self.params, trainable = build_model(s, weights, device)
        del weights
        inputs = train_inputs(s, traffic, seed, device)
        encode = make_text_encoder(self.params, self.cfg, device)
        self.pool = [{"image": inputs["images"][j][None],
                      "txt_feat": encode(inputs["tokens"][j])[None]}
                     for j in range(traffic["pool"])]
        o = s["optimizer"]
        tcfg = T.TrainConfig(lr=o["lr"], lr_min=o["lr_min"], weight_decay=o["weight_decay"],
                             beta1=o["beta1"], beta2=o["beta2"],
                             total_updates=o["total_updates"])

        def loss_fn(mb, gen):
            img, _ = clip_mod.encode_image(self.params, self.cfg, mb["image"], gen=gen)
            return info_nce(img, mb["txt_feat"], temperature=s["temperature"])

        self.loss_fn = loss_fn
        self.train_step = T.TrainStep(loss_fn, T.make_optimizer(trainable.values(), tcfg), tcfg,
                                      grad_clip=o["grad_clip"])
        self.names = [k.replace("/", ".") for k in trainable]
        self.gen = H.generator(seed, 3, device)

    def step(self, i: int) -> dict:
        return self.train_step(self.pool[i % len(self.pool)], self.gen)

    def leaves(self) -> dict:
        """Every tensor the step changes, by path."""
        return dict(zip(self.names, self.train_step.params))


def draws(s: dict, traffic: dict, device, state) -> list:
    """The uniform draws each block's MONA dropout takes from the step's
    generator in state ``state``: one [B, N, C] tensor a block, in block
    order (``nn/layers.py::dropout_mask`` under ``mona_apply``)."""
    g = torch.Generator(device=device)
    g.set_state(state)
    n = (s["image_size"] // s["patch_size"]) ** 2 + 1
    shape = (traffic["batch"], n, s["mona_bottleneck"])
    return [torch.rand(shape, generator=g, device=device) for _ in range(s["depth"])]


def reference_train(s: dict, traffic: dict, seed: int, device, draws: list, q,
                    start=None) -> tuple:
    """The reference's ``len(draws)`` steps from the same weights and pool:
    the first steps, on pool batches 0, 1, ..., or the steps from ``start``
    (``reference._common.adamw_steps``'s, with the program's 'leaves' and
    its next pool batch 'pool')."""
    weights = H.make_weights(R.param_spec(s), seed, device)
    inputs = train_inputs(s, traffic, seed, device)
    j = 0 if start is None else start["pool"]
    p = traffic["pool"]
    batches = [{"images": inputs["images"][(j + t) % p], "tokens": inputs["tokens"][(j + t) % p],
                "draws": d} for t, d in enumerate(draws)]
    return R.train_reference(weights, s, batches, len(draws), q, start)


def infer_inputs(s: dict, traffic: dict, seed: int, device) -> dict:
    """uint8 images [P, B, S, S, 3] and per class [n, embed] L2-normalised
    prompt features, from the seed."""
    p, b, n = traffic["pool"], traffic["batch"], s["image_size"]
    gen = H.generator(seed, 1, device)
    images = torch.randint(0, 256, (p, b, n, n, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    prompts = {}
    for c in PR.LESION_TYPES:
        f = torch.randn((traffic["prompts_per_class"], s["embed_dim"]), generator=gen,
                        device=device)
        prompts[c] = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    return {"images": images, "prompts": prompts}


class Infer:
    """Zero-shot classification of one batch: ``host_pool`` holds the pinned
    uint8 batches, ``infer(x)`` takes one on the card and returns (the
    answer to copy back, the logits compared)."""

    def __init__(self, s: dict, traffic: dict, seed: int, device):
        weights = H.make_weights(R.param_spec(s, text=False), seed, device)
        self.cfg, self.params, _ = build_model(s, weights, device, text=False)
        del weights
        inputs = infer_inputs(s, traffic, seed, device)
        self.host_pool = [x.cpu().pin_memory() if x.is_cuda else x.cpu()
                          for x in inputs["images"]]
        self.logits_fn = make_zero_shot_logits_fn(self.cfg, inputs["prompts"])

    def infer(self, x):
        logits, _ = self.logits_fn(self.params, x)
        return logits, logits


def logit_scale(s: dict, traffic: dict, seed: int, device) -> float:
    """The largest |logit| any unit image feature can take against these
    prompts: 100 * max over classes of the norm of the prompts' mean."""
    prompts = infer_inputs(s, traffic, seed, device)["prompts"]
    return max(100.0 * float(torch.linalg.vector_norm(p.mean(dim=0))) for p in prompts.values())


def reference_infer(s: dict, traffic: dict, seed: int, device, pool_ids, q) -> dict:
    """pool index -> the reference's logits [B, n_classes]."""
    weights = H.make_weights(R.param_spec(s, text=False), seed, device)
    inputs = infer_inputs(s, traffic, seed, device)
    return {j: R.zero_shot_logits(weights, s, inputs["images"][j], inputs["prompts"], q)
            for j in pool_ids}
