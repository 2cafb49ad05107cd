"""The augmentation's equalize op, and the per-image table lookup and
256-bin histogram it is made of (counterpart of nextgen_uia_tpu/ops/lut.py:
``lut_apply`` and ``hist256_fact``, and of the table that
nextgen_uia_tpu/data/augment.py::_equalize builds between them), batched:

    equalize_(x, idx): x[i] = equalize(x[i]) in place for each i in idx
    lut_apply(img, lut)[b, ...] = lut[b, u8(img[b, ...])]   (float32)
    hist256(img)[b, v]          = #{pixels of img[b] with u8 == v}

with ``u8(x) = clip(round(x * 255), 0, 255)`` (round half to even) and
equalize PIL ImageOps.equalize on the uint8 grid. On a CUDA tensor each
launches its hand-written kernel of csrc/lut.cu (counted in
``equalize_.launches``, ``lut_apply.launches`` and ``hist256.launches``):
equalize and hist256 one cluster of CTAs an image (``_eq_grid``); on a CPU
tensor it runs its plain version below. All are integer-exact, so kernel,
plain version and the JAX functions agree bit for bit. The JAX package's
16 x 16 one-hot factorization is a TPU workaround (gathers serialize there)
and is not copied.
"""

from __future__ import annotations

import functools

import torch

from . import build

# csrc/lut.cu::equalize_kernel's grid (``_eq_grid``): the largest cluster,
# the CTAs that fill the H100's 132 SMs about one and a half times, and a
# CTA's slice of the image in floats, at least and at most
EQ_MAX_CLUSTER, EQ_FILL, EQ_MIN_SLICE, EQ_MAX_SLICE = 16, 192, 4096, 36864


def to_bytes(img01):
    """u8 = clip(round(img01 * 255), 0, 255) as int64 (round half to even)."""
    return torch.clamp(torch.round(img01.to(torch.float32) * 255.0), 0, 255).long()


def quantize_u8(x):
    """The uint8 grid PIL images live on between ops."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


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


def equalize_lut(hist):
    """PIL ImageOps.equalize's table from [n, 256] counts: step = (total -
    count of the last non-zero bin) // 255, lut = (shifted cumsum + step //
    2) // step, the identity where step is 0."""
    h = hist.long()
    last = 255 - (h > 0).flip(-1).to(torch.uint8).argmax(-1)
    step = (h.sum(-1) - h.gather(1, last[:, None])[:, 0]) // 255
    cum = h.cumsum(-1)
    shifted = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    ident = torch.arange(256, device=h.device).expand_as(h)
    lut = torch.where(step[:, None] > 0,
                      (shifted + (step // 2)[:, None]) // step.clamp(min=1)[:, None], ident)
    return lut.clamp(0, 255)


def _index(idx, n, device, dtype=torch.int64):
    """idx as ``dtype`` on ``device``; a host list is checked (distinct, in
    range) on the way, since the kernel writes each image in place; a
    device list is not (see ``equalize_``)."""
    idx = torch.as_tensor(idx)
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(f"equalize: idx must be a 1-D integer list, not {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device.type == "cpu" and len(idx) and (
            int(idx.min()) < 0 or int(idx.max()) >= n or len(torch.unique(idx)) != len(idx)):
        raise ValueError(f"equalize: idx must hold distinct images of 0..{n - 1}, "
                         f"not {idx.tolist()}")
    return idx.to(dtype=dtype).to(device=device)


def equalize_plain(x, idx):
    """x [B, ...] float32 in place: each image x[i], i in idx, replaced by
    ``quantize_u8(lut_apply_plain(x[i], equalize_lut(hist256_plain(x[i]))) /
    255)``. Returns x."""
    idx = _index(idx, x.shape[0], x.device)
    sel = x.index_select(0, idx)
    x.index_copy_(0, idx, quantize_u8(lut_apply_plain(sel, equalize_lut(hist256_plain(sel)))
                                      / 255.0))
    return x


@functools.cache
def unit_grid(device):
    """[256] float32: byte v on the unit grid as the plain path rounds it on
    ``device`` (``quantize_u8(v / 255)``), which equalize's kernel stores.
    On the CPU it is v / 255 itself (tests/test_torch_hopper_lut.py); torch's
    CUDA division by a Python number multiplies by its float reciprocal,
    so the card's grid is built there by the same operations."""
    v = torch.arange(256, dtype=torch.float32, device=device)
    return quantize_u8(v / 255.0)


def _eq_grid(n: int, hw: int) -> tuple[int, int]:
    """(cluster, slice) of equalize_kernel for n images of hw pixels: one
    cluster of CTAs an image, a power of two up to 16 that makes n * cluster
    reach EQ_FILL CTAs, as long as a CTA's contiguous slice keeps at least
    EQ_MIN_SLICE floats, and large enough that it holds at most
    EQ_MAX_SLICE; the slice a multiple of 4 floats (16-byte loads)."""
    cluster = 1
    while cluster < EQ_MAX_CLUSTER and (
            hw > cluster * EQ_MAX_SLICE
            or (n * cluster < EQ_FILL and hw >= 2 * cluster * EQ_MIN_SLICE)):
        cluster *= 2
    return cluster, 4 * -(-hw // (4 * cluster))


def _flat_cuda(img01, what):
    if img01.dtype != torch.float32:
        raise ValueError(f"{what} CUDA kernel takes float32 images, not {img01.dtype}")
    if img01.dim() < 2 or not 1 <= img01.shape[0] <= 65535:
        raise ValueError(f"{what} CUDA kernel takes [B, ...] images with 1 <= B <= 65535, "
                         f"not {tuple(img01.shape)}")
    b = img01.shape[0]
    return img01.contiguous().reshape(b, -1), b


def equalize_(x, idx):
    """Equalize the images x[i], i in idx, in place (x [B, ...] float32; idx
    distinct image indices, on the host or on x's device) and return x: the
    kernel on a CUDA tensor (one launch, each selected image read and
    written once), ``equalize_plain`` on a CPU tensor.

    A host list (what ``apply_plan`` passes) is checked, distinct and in
    range, before it is copied to the card. A list already on the card is
    taken unchecked, since checking it would wait for the card: the caller
    must make it distinct and in range. An index out of range stops the
    kernel with a trap, which ends the CUDA context; a repeated index makes
    two clusters rewrite one image at once, and the result is wrong."""
    if x.device.type == "cpu":
        return equalize_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"equalize: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("equalize: x must be contiguous (it is written in place)")
    flat, b = _flat_cuda(x, "equalize")
    idx = _index(idx, b, x.device, torch.int32)
    if len(idx) > 65535:
        raise ValueError(f"equalize: {len(idx)} images (at most 65535)")
    if len(idx):
        _launch_equalize(flat, idx, *_eq_grid(len(idx), flat.shape[1]))
        equalize_.launches += 1
    return x


def _launch_equalize(flat, idx, cluster, slice_):
    """nx_equalize on x [B, HW] (in place; any 4-byte aligned address) at
    the int32 device list idx."""
    grid = unit_grid(flat.device)
    lib = build.library()
    with torch.cuda.device(flat.device):
        build.check(lib.nx_equalize(flat.data_ptr(), build.ptr(idx), build.ptr(grid),
                                    len(idx), flat.shape[0], flat.shape[1], cluster, slice_,
                                    build.stream(flat.device)), "equalize")


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
    """[B, 256] int32 histogram of u8(img01[b]): the kernel on a CUDA tensor
    (equalize's kernel in its histogram mode), ``hist256_plain`` on a CPU
    tensor."""
    if img01.device.type == "cpu":
        return hist256_plain(img01)
    if img01.device.type != "cuda":
        raise ValueError(f"hist256: unsupported device {img01.device}")
    flat, b = _flat_cuda(img01, "hist256")
    hist = torch.empty(b, 256, dtype=torch.int32, device=flat.device)
    cluster, slice_ = _eq_grid(b, flat.shape[1])
    lib = build.library()
    with torch.cuda.device(flat.device):
        build.check(lib.nx_hist256(flat.data_ptr(), build.ptr(hist), b, flat.shape[1],
                                   cluster, slice_, build.stream(flat.device)), "hist256")
    hist256.launches += 1
    return hist


equalize_.launches = 0
lut_apply.launches = 0
hist256.launches = 0
