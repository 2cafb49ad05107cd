"""The system under test for ``dinov2_seg``: the port's DINOv2 segmentation
bundle (``tasks/other_tasks.py::build_dino_seg_bundle``: the frozen ViT-B/14
and the UNet decoder with its BatchNorm state) at the ``dino/segmentation``
CLI's defaults with augmentation off, its skeleton made on the meta device
and the benchmark's seeded weights loaded through the modules' own
``load_state_dict``, the frozen encoder's tensors rounded to bf16 values.

- ``Train``: ``TrainStep`` over the bundle's ``forward_train`` and the seg
  trainer's DiceCE (``losses.py::dice_ce_loss``), AdamW over the decoder.
- ``Infer``: ``forward_eval``, then the class map (argmax, uint8) that the
  predict CLI writes.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from nextgen_uia_tpu_torch.core import train as T
from nextgen_uia_tpu_torch.core.partition import partition
from nextgen_uia_tpu_torch.losses import dice_ce_loss
from nextgen_uia_tpu_torch.tasks.other_tasks import build_dino_seg_bundle

from benchmark import harness as H
from benchmark.reference import dinov2_seg as R


def cli_args(s: dict) -> SimpleNamespace:
    """The dino segmentation CLI's arguments at their defaults, augmentation
    off (``debug_tiny``: the CLI's tiny encoder, for the harness's tests)."""
    return SimpleNamespace(dino_arch="vit_base", debug_tiny=s.get("debug_tiny", False),
                           backbone_ckpt=None, lora_weights=None, decoder_type=s["decoder"],
                           num_classes=s["num_classes"], img_size=s["image_size"],
                           patch_size=s["patch_size"], compute_dtype=s["compute_dtype"],
                           head_dtype=s["head_dtype"], strong_augs=False, weak_augs=False)


def build_bundle(s: dict, weights: dict, device):
    """The bundle on ``device`` holding ``weights``, the encoder rounded to
    bf16 values."""
    with torch.device("meta"):
        bundle = build_dino_seg_bundle(cli_args(s), torch.Generator())
    bundle.params.to_empty(device=device)
    bundle.bn_state.to_empty(device=device)
    bundle.params.load_state_dict({k: v for k, v in weights.items() if not k.startswith("bn.")},
                                  strict=True)
    bundle.bn_state.load_state_dict({k[3:]: v for k, v in weights.items()
                                     if k.startswith("bn.")}, strict=True)
    with torch.no_grad():
        for p in bundle.params.encoder.parameters():
            p.copy_(H.bf16_round(p))
    return bundle


def images_per_step(s: dict, traffic: dict) -> int:
    return traffic["batch"]


def lesions(gen, count: int, n: int, traffic: dict):
    """``count`` seeded uint8 grayscale images [count, n, n] and their masks:
    a lesion per image where a smooth field (``lesion_grid`` squared
    uniforms, upsampled bilinearly) passes the image's threshold (drawn from
    ``threshold``), brighter than its speckle by the image's ``contrast``."""
    dev = gen.device
    g = traffic["lesion_grid"]
    field = F.interpolate(torch.rand((count, 1, g, g), generator=gen, device=dev), size=(n, n),
                          mode="bilinear", align_corners=False)[:, 0]
    lo, hi = traffic["threshold"]
    thr = lo + (hi - lo) * torch.rand((count, 1, 1), generator=gen, device=dev)
    masks = field > thr
    lo, hi = traffic["contrast"]
    contrast = lo + (hi - lo) * torch.rand((count, 1, 1), generator=gen, device=dev)
    speckle = torch.rand((count, n, n), generator=gen, device=dev)
    images = ((1 - contrast) * speckle + contrast * masks) * 255
    return images.round().to(torch.uint8), masks.to(torch.uint8)


def weights(s: dict, traffic: dict, seed: int, device) -> dict:
    """The seeded weights, the decoder's BatchNorm running statistics set to
    those of a seeded calibration batch through the plain reference (a
    decoder past its first epochs, whose statistics fit its inputs)."""
    w = H.make_weights(R.param_spec(s), seed, device)
    images, _ = lesions(H.generator(seed, 2, device), traffic["calibration_images"],
                        s["image_size"], traffic)
    w = R.calibrate_bn(w, s, images)
    if w["bn.up0.conv_bn.mean"].is_cuda:
        # the calibration's float32 cuDNN workspaces (~30 GB) are the
        # benchmark's, not the program's: release them and restart the peak
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return w


def train_inputs(s: dict, traffic: dict, seed: int, device) -> dict:
    """The pool: uint8 images and masks [P, B, S, S], every row drawn apart,
    from the seed."""
    p, b, n = traffic["pool"], traffic["batch"], s["image_size"]
    images, masks = lesions(H.generator(seed, 1, device), p * b, n, traffic)
    return {"images": images.view(p, b, n, n), "masks": masks.view(p, b, n, n)}


class Train:
    def __init__(self, s: dict, traffic: dict, seed: int, device):
        self.s = s
        w = weights(s, traffic, seed, device)
        self.bundle = build_bundle(s, w, device)
        del w
        trainable, _ = partition(self.bundle.params, self.bundle.trainable_pred)
        inputs = train_inputs(s, traffic, seed, device)
        self.pool = [{"image": inputs["images"][j][None], "mask": inputs["masks"][j][None]}
                     for j in range(traffic["pool"])]
        o = s["optimizer"]
        tcfg = T.TrainConfig(lr=o["lr"], lr_min=o["lr_min"], weight_decay=o["weight_decay"],
                             beta1=o["beta1"], beta2=o["beta2"],
                             total_updates=o["total_updates"])
        params = self.bundle.params

        def loss_fn(mb, gen):
            logits, masks = self.bundle.forward_train(params, mb, gen)
            return dice_ce_loss(logits, masks)

        self.train_step = T.TrainStep(loss_fn, T.make_optimizer(trainable.values(), tcfg), tcfg,
                                      grad_clip=o["grad_clip"])
        self.names = [k.replace("/", ".") for k in trainable]
        self.gen = H.generator(seed, 3, device)

    def step(self, i: int) -> dict:
        return self.train_step(self.pool[i % len(self.pool)], self.gen)

    def leaves(self) -> dict:
        """Every tensor the step changes: the decoder and its statistics."""
        out = dict(zip(self.names, self.train_step.params))
        out.update({f"bn.{k}": v for k, v in self.bundle.bn_state.named_buffers()})
        return out


def reference_train(s: dict, traffic: dict, seed: int, device, draws: list, q,
                    start=None) -> tuple:
    """The reference's ``len(draws)`` steps, as ``biomedclip_mona``'s."""
    w = weights(s, traffic, seed, device)
    inputs = train_inputs(s, traffic, seed, device)
    j = 0 if start is None else start["pool"]
    p = traffic["pool"]
    batches = [{"images": inputs["images"][(j + t) % p], "masks": inputs["masks"][(j + t) % p]}
               for t in range(len(draws))]
    return R.train_reference(w, s, batches, len(draws), q, start)


def infer_inputs(s: dict, traffic: dict, seed: int, device) -> dict:
    p, b, n = traffic["pool"], traffic["batch"], s["image_size"]
    images, _ = lesions(H.generator(seed, 1, device), p * b, n, traffic)
    return {"images": images.view(p, b, n, n)}


class Infer:
    """Segmentation of one batch: ``host_pool`` holds the pinned uint8
    batches, ``infer(x)`` returns (the class map to copy back, the logits
    behind it)."""

    def __init__(self, s: dict, traffic: dict, seed: int, device):
        w = weights(s, traffic, seed, device)
        self.bundle = build_bundle(s, w, device)
        del w
        images = infer_inputs(s, traffic, seed, device)["images"]
        self.host_pool = [x.cpu().pin_memory() if x.is_cuda else x.cpu() for x in images]

    def infer(self, x):
        with torch.no_grad():
            logits = self.bundle.forward_eval(self.bundle.params, x)
        return logits.argmax(dim=1).to(torch.uint8), logits


def reference_infer(s: dict, traffic: dict, seed: int, device, pool_ids, q) -> dict:
    w = weights(s, traffic, seed, device)
    images = infer_inputs(s, traffic, seed, device)["images"]
    return {j: R.predict_logits(w, s, images[j], q) for j in pool_ids}
