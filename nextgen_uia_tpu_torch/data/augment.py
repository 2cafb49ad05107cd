"""On-device batch augmentation (counterpart of nextgen_uia_tpu/data/augment.py).

The reference's per-sample PIL pipeline, applied to a whole batch on the
device: the strong (intensity) list [identity, autocontrast, equalize, blur,
contrast, brightness, sharpness, posterize, solarize] and the weak
(geometric, mask-paired) list [resized crop, hflip, vflip, identity], each
composed as k ~ U{0..n} ops drawn uniformly with replacement and applied in
order with magnitudes drawn per application; images round-trip through the
uint8 grid after every strong op; with both lists on, each image is
augmented with probability 0.5.

torch cannot reproduce ``jax.random``'s streams, so the JAX package's one
function is split in two: ``sample_plan`` draws everything from an explicit
``torch.Generator`` on the batch's device (per image the op ids, one unit
uniform per strong slot, the crop's ten scale draws and two offset draws
per weak slot, and the gate), and ``apply_plan`` applies a plan. Each op
maps its unit uniform to its magnitude with the JAX expression, in float32,
so a plan rebuilt from ``jax.random``'s draws reproduces the JAX output.

Where the JAX package's vmapped switch evaluates every branch for every
image, ``apply_plan`` runs each op once per slot over the images that drew
it (the plan's op ids come to the host once per batch); equalize
(``ops.equalize``, csrc/lut.cu) takes the batch and that subset's indices
and rewrites those images in place, one launch a slot. Images are float32
[B, H, W, 1] in [0, 1] (grayscale), masks float32 {0, 1} of the same shape,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.layers import scale_translate_weights, triangle_kernel
from ..ops import KERNELS
from ..ops.lut import equalize_lut, quantize_u8  # noqa: F401  (equalize_lut: importable here)

N_STRONG = 9  # [identity, autocontrast, equalize, blur, contrast, brightness, sharpness,
#               posterize, solarize] - the reference get_strong_aug_list order
EQUALIZE = 2
N_WEAK = 4    # [crop, hflip, vflip, identity] - the reference WeakAugmentation order
WEAK_IDENTITY = 3
F32 = torch.float32


# ---------------------------------------------------------------------------
# Intensity ops: x [n, H, W] float32 in [0, 1], u [n] unit uniforms
# ---------------------------------------------------------------------------


def _per_image(v):
    return v[:, None, None]


def _u8(x):
    return torch.clamp(torch.round(x * 255.0), 0, 255)


def _autocontrast(x, u, ops):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.clamp((x - lo) * scale, 0.0, 1.0)


def _equalize(x, u, ops):
    """Every image of x equalized (a copy, through the in-place
    ``ops.equalize``; ``apply_plan`` calls that on the batch itself)."""
    return ops.equalize(x.clone(), torch.arange(len(x)))


def _band(taps, size):
    """[n, size, size] matrices M with M[j, c] = taps[n, j - c + r] inside
    the band |j - c| <= r (taps has 2r + 1 entries), zero outside: x @ M is
    the zero-padded SAME correlation along x's last axis."""
    r = taps.shape[-1] // 2
    pos = torch.arange(size, device=taps.device)
    off = pos[:, None] - pos[None, :] + r
    inside = (off >= 0) & (off <= 2 * r)
    gathered = taps[:, off.clamp(0, 2 * r).reshape(-1)].reshape(-1, size, size)
    return torch.where(inside, gathered, torch.zeros((), dtype=taps.dtype, device=taps.device))


def _blur(x, u, ops):
    """Separable gaussian, radius 4 (9 taps, normalized), zero-padded SAME:
    along the width, then the height. sigma = U[0.75, 1.25) as
    jax.random.uniform(minval, maxval) maps the unit draw."""
    sigma = torch.clamp_min(u * (1.25 - 0.75) + 0.75, 0.75)
    t = torch.arange(-4, 5, dtype=F32, device=x.device)
    k = torch.exp(-0.5 * (t[None, :] / sigma[:, None]) ** 2)
    k = k / k.sum(-1, keepdim=True)
    y = x @ _band(k, x.shape[2])
    return _band(k, x.shape[1]).transpose(1, 2) @ y


def _enhance_factor(u):
    return 1.25 - 0.5 * u


def _contrast(x, u, ops):
    mean = torch.round(torch.round(x * 255.0).mean(dim=(1, 2), keepdim=True)) / 255.0
    return torch.clamp(mean + (x - mean) * _per_image(_enhance_factor(u)), 0.0, 1.0)


def _brightness(x, u, ops):
    return torch.clamp(x * _per_image(_enhance_factor(u)), 0.0, 1.0)


def _tridiagonal_ones(size, device):
    pos = torch.arange(size, device=device)
    return ((pos[:, None] - pos[None, :]).abs() <= 1).to(F32)


def _sharpness(x, u, ops):
    """PIL's SMOOTH kernel [[1,1,1],[1,5,1],[1,1,1]] / 13 (the 3x3 box sum
    plus 4x the centre), border pixels kept, blended by the factor."""
    _, h, w = x.shape
    box = _tridiagonal_ones(h, x.device) @ x @ _tridiagonal_ones(w, x.device)
    smooth = (box + 4.0 * x) / 13.0
    interior = torch.zeros(h, w, dtype=torch.bool, device=x.device)
    interior[1:-1, 1:-1] = True
    smooth = torch.where(interior, smooth, x)
    return torch.clamp(smooth + (x - smooth) * _per_image(_enhance_factor(u)), 0.0, 1.0)


def _posterize(x, u, ops):
    bits = 8 - torch.clamp_min(torch.ceil(4.0 * u), 1).long()
    mask = (0xFF << (8 - bits)) & 0xFF
    return (_u8(x).long() & _per_image(mask)).to(F32) / 255.0


def _solarize(x, u, ops):
    thr = 256 - torch.clamp_min(torch.ceil(255.0 * u), 1)
    v = _u8(x)
    return torch.where(v >= _per_image(thr), 255.0 - v, v) / 255.0


STRONG_OPS = (None, _autocontrast, _equalize, _blur, _contrast, _brightness, _sharpness,
              _posterize, _solarize)


# ---------------------------------------------------------------------------
# Geometric ops
# ---------------------------------------------------------------------------


def crop_params(crop_s, crop_ij, size: int):
    """torchvision RandomResizedCrop.get_params(scale=(0.8, 1.2), ratio=(1, 1))
    on a square ``size`` image, from unit draws: crop_s [n, 10] (ten
    attempts, s = U(0.8, 1.2), side = round(sqrt(s) * size), the first side
    <= size wins, else the full image) and crop_ij [n, 2] (offsets
    floor(U * (size - side + 1))). Returns float32 (side, i, j), each [n]."""
    lo, hi = torch.tensor(0.8, dtype=F32), torch.tensor(1.2, dtype=F32)
    s = torch.maximum(crop_s * (hi - lo).to(crop_s.device) + lo.to(crop_s.device),
                      lo.to(crop_s.device))
    sides = torch.round(torch.sqrt(s) * size)
    ok = sides <= size
    first = ok.to(torch.uint8).argmax(-1)
    side = torch.where(ok.any(-1), sides.gather(1, first[:, None])[:, 0],
                       torch.full_like(sides[:, 0], float(size)))
    span = size - side + 1
    return side, torch.floor(crop_ij[:, 0] * span), torch.floor(crop_ij[:, 1] * span)


def resized_crop(x, side, i, j, out_size: int):
    """Square crop (side, offsets i, j) of x [n, H, W], bilinear-resized to
    out_size: jax.image.scale_and_translate(method='bilinear') with scale
    out_size / side and translation -offset * scale, as two batched
    products."""
    scale = out_size / side
    inv = 1.0 / scale
    rows = scale_translate_weights(x.shape[1], out_size, inv, -i * scale, triangle_kernel)
    cols = scale_translate_weights(x.shape[2], out_size, inv, -j * scale, triangle_kernel)
    return rows.transpose(1, 2) @ x @ cols


# ---------------------------------------------------------------------------
# Plan and batch entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plan:
    """Everything ``augment_batch`` draws, per image: op ids per slot with
    the slots past k forced to the identity, and the unit uniforms each op
    maps to its magnitude. Fields of a list that is off are None."""
    strong_ids: torch.Tensor | None = None  # [B, 9] int64, identity = 0
    strong_u: torch.Tensor | None = None    # [B, 9] float32
    weak_ids: torch.Tensor | None = None    # [B, 4] int64, identity = 3
    crop_s: torch.Tensor | None = None      # [B, 4, 10] float32
    crop_ij: torch.Tensor | None = None     # [B, 4, 2] float32
    gate: torch.Tensor | None = None        # [B] bool (both lists on)


def _op_sequence(gen, b: int, n: int, identity: int):
    """k ~ U{0..n}, n ids uniform over {0..n-1} with replacement, slots >= k
    forced to ``identity`` (random.choices semantics)."""
    dev = gen.device
    k = torch.randint(0, n + 1, (b, 1), generator=gen, device=dev)
    ids = torch.randint(0, n, (b, n), generator=gen, device=dev)
    return torch.where(torch.arange(n, device=dev) < k, ids, torch.full_like(ids, identity))


def sample_plan(gen: torch.Generator, b: int, *, strong: bool = True, weak: bool = True) -> Plan:
    """Draw a plan for ``b`` images from ``gen``, on the generator's device."""
    dev, plan = gen.device, Plan()
    if strong:
        plan.strong_ids = _op_sequence(gen, b, N_STRONG, 0)
        plan.strong_u = torch.rand(b, N_STRONG, generator=gen, device=dev)
    if weak:
        plan.weak_ids = _op_sequence(gen, b, N_WEAK, WEAK_IDENTITY)
        plan.crop_s = torch.rand(b, N_WEAK, 10, generator=gen, device=dev)
        plan.crop_ij = torch.rand(b, N_WEAK, 2, generator=gen, device=dev)
    if strong and weak:
        plan.gate = torch.rand(b, generator=gen, device=dev) < 0.5
    return plan


def _groups(ids_host, slot: int, op: int, device):
    """The images whose op at ``slot`` is ``op``, on ``device``, or None."""
    sel = torch.nonzero(ids_host[:, slot] == op)[:, 0]
    return sel.to(device) if len(sel) else None


def apply_plan(plan: Plan, images, masks=None, *, out_size: int | None = None, ops=KERNELS):
    """Apply ``plan`` to images [B, H, W, 1] (and masks). The strong list runs
    when the plan has strong ids, the weak one when it has weak ids. Returns
    (images, masks), masks None when none were given."""
    x = images[..., 0].to(F32).clone()
    m = None if masks is None else masks[..., 0].to(F32).clone()
    x0, m0 = x.clone(), (None if m is None else m.clone())
    if plan.strong_ids is not None:
        ids = plan.strong_ids.cpu()  # the one device-to-host read of a batch
        for slot in range(N_STRONG):
            for op in range(1, N_STRONG):
                if op == EQUALIZE:  # in place: no gather, no copy; its output is on the grid
                    sel = _groups(ids, slot, op, "cpu")
                    if sel is not None:
                        ops.equalize(x, sel)
                    continue
                idx = _groups(ids, slot, op, x.device)
                if idx is not None:
                    y = STRONG_OPS[op](x.index_select(0, idx), plan.strong_u[idx, slot], ops)
                    x.index_copy_(0, idx, quantize_u8(y))
    if plan.weak_ids is not None:
        size = out_size if out_size is not None else x.shape[1]
        if x.shape[1] != size or x.shape[2] != size:
            raise ValueError(f"weak augmentation expects images at out_size {size}, not "
                             f"{tuple(x.shape[1:])} (the reference resizes first)")
        ids = plan.weak_ids.cpu()
        pairs = [t for t in (x, m) if t is not None]
        for slot in range(N_WEAK):
            idx = _groups(ids, slot, 0, x.device)
            if idx is not None:
                side, i, j = crop_params(plan.crop_s[idx, slot], plan.crop_ij[idx, slot], size)
                for t in pairs:
                    t.index_copy_(0, idx, resized_crop(t.index_select(0, idx), side, i, j,
                                                       size))
            for op, dim in ((1, 2), (2, 1)):  # hflip: the width; vflip: the height
                idx = _groups(ids, slot, op, x.device)
                if idx is not None:
                    for t in pairs:
                        t.index_copy_(0, idx, t.index_select(0, idx).flip(dim))
        if m is not None:
            m = torch.round(torch.clamp(m, 0.0, 1.0))
    if plan.gate is not None:
        g = plan.gate[:, None, None]
        x = torch.where(g, x, x0)
        if m is not None:
            m = torch.where(g, m, m0)
    return x[..., None], (None if m is None else m[..., None])


def augment_batch(gen: torch.Generator, images, masks=None, *, strong: bool = True,
                  weak: bool = True, out_size: int | None = None, ops=KERNELS):
    """Augment a batch [B, H, W, 1] (+ optional masks) with a plan drawn from
    ``gen`` (a generator on the batch's device). Returns (images, masks),
    masks None when not given."""
    if gen.device.type != images.device.type:
        raise ValueError(f"augment_batch: generator on {gen.device}, images on {images.device}")
    plan = sample_plan(gen, images.shape[0], strong=strong, weak=weak)
    return apply_plan(plan, images, masks, out_size=out_size, ops=ops)
