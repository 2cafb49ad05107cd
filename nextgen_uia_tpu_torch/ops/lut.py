"""Per-image table lookup and 256-bin histogram on the byte grid
(counterpart of nextgen_uia_tpu/ops/lut.py: ``lut_apply`` and
``hist256_fact``), batched, as the augmentation's equalize op calls them:

    lut_apply(img, lut)[b, ...] = lut[b, u8(img[b, ...])]   (float32)
    hist256(img)[b, v]          = #{pixels of img[b] with u8 == v}

with ``u8(x) = clip(round(x * 255), 0, 255)`` (round half to even). On a
CUDA tensor each launches its hand-written kernel of csrc/lut.cu (counted in
``lut_apply.launches`` and ``hist256.launches``); on a CPU tensor it runs
its plain version below. Both are integer-exact, so kernel, plain version
and the JAX functions agree bit for bit. The JAX package's 16 x 16 one-hot
factorization is a TPU workaround (gathers serialize there) and is not
copied.
"""

from __future__ import annotations

import torch

from . import build


def to_bytes(img01):
    """u8 = clip(round(img01 * 255), 0, 255) as int64 (round half to even)."""
    return torch.clamp(torch.round(img01.to(torch.float32) * 255.0), 0, 255).long()


def lut_apply_plain(img01, lut):
    """img01 [B, ...] float in [0, 1], lut [B, 256] integer -> lut[b, u8]
    as float32 of img01's shape."""
    b = img01.shape[0]
    u8 = to_bytes(img01).reshape(b, -1)
    return torch.gather(lut.long(), 1, u8).to(torch.float32).reshape(img01.shape)


def hist256_plain(img01):
    """img01 [B, ...] -> [B, 256] int32 counts of u8."""
    b = img01.shape[0]
    u8 = to_bytes(img01).reshape(b, -1)
    counts = torch.zeros(b, 256, dtype=torch.int64, device=img01.device)
    counts.scatter_add_(1, u8, torch.ones_like(u8))
    return counts.to(torch.int32)


def _flat_cuda(img01, what):
    if img01.dtype != torch.float32:
        raise ValueError(f"{what} CUDA kernel takes float32 images, not {img01.dtype}")
    if img01.dim() < 2 or not 1 <= img01.shape[0] <= 65535:
        raise ValueError(f"{what} CUDA kernel takes [B, ...] images with 1 <= B <= 65535, "
                         f"not {tuple(img01.shape)}")
    b = img01.shape[0]
    return img01.contiguous().reshape(b, -1), b


def lut_apply(img01, lut):
    """lut[b, u8(img01[b])] as float32 [B, ...]: the kernel on a CUDA tensor,
    ``lut_apply_plain`` on a CPU tensor."""
    if img01.device.type == "cpu":
        return lut_apply_plain(img01, lut)
    if img01.device.type != "cuda":
        raise ValueError(f"lut_apply: unsupported device {img01.device}")
    flat, b = _flat_cuda(img01, "lut_apply")
    if tuple(lut.shape) != (b, 256):
        raise ValueError(f"lut_apply: lut {tuple(lut.shape)} for {b} images (want [B, 256])")
    table = lut.to(device=flat.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(flat)
    lib = build.library()
    with torch.cuda.device(flat.device):
        build.check(lib.nx_lut_apply(build.ptr(flat, "img"), build.ptr(table), build.ptr(out),
                                     b, flat.shape[1], build.stream(flat.device)), "lut_apply")
    lut_apply.launches += 1
    return out.reshape(img01.shape)


def hist256(img01):
    """[B, 256] int32 histogram of u8(img01[b]): the kernel on a CUDA tensor,
    ``hist256_plain`` on a CPU tensor."""
    if img01.device.type == "cpu":
        return hist256_plain(img01)
    if img01.device.type != "cuda":
        raise ValueError(f"hist256: unsupported device {img01.device}")
    flat, b = _flat_cuda(img01, "hist256")
    hist = torch.zeros(b, 256, dtype=torch.int32, device=flat.device)
    lib = build.library()
    with torch.cuda.device(flat.device):
        build.check(lib.nx_hist256(build.ptr(flat, "img"), build.ptr(hist), b, flat.shape[1],
                                   build.stream(flat.device)), "hist256")
    hist256.launches += 1
    return hist


lut_apply.launches = 0
hist256.launches = 0
