"""Fused MONA spatial op, forward and backward (counterpart of
nextgen_uia_tpu/ops/dwconv.py::mona_spatial):

    y = dwconv7(s * freq) + bias + s

with per-sample depthwise 7x7 'SAME' kernels. ``mona_spatial`` is
differentiable in all four inputs: on a CUDA tensor its forward and backward
each launch one hand-written kernel of csrc/mona_spatial.cu (counted in
``mona_spatial.launches`` and ``mona_spatial_backward.launches``), on the
geometry ``_grid`` picks; on a CPU tensor they run ``mona_spatial_plain`` and
``mona_spatial_backward_plain``. The backward recomputes from the saved s,
freq and kernels, as the JAX custom VJP does. ``_strip_backward`` is the
backward kernel's order of sums in plain float32, for the tests.

``dwconv7_per_sample`` (counterpart of
nextgen_uia_tpu/ops/dwconv.py::dwconv7_per_sample) is the bare per-sample
7x7 depthwise 'SAME' convolution, ``y = dwconv7(x)``, differentiable in x
and the kernels: the same stencil kernels with no freq, bias or residual
(counted in ``dwconv7_per_sample.launches`` and
``dwconv7_per_sample_backward.launches``), on a CPU tensor
``dwconv7_per_sample_plain`` and ``dwconv7_per_sample_backward_plain``. No
module of the port calls it: as in the JAX package, MONA's adapter takes the
fused ``mona_spatial``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .registry import register

ACCESS_BYTES = (16, 8, 4, 2)  # the kernels' vector copies, widest first
CTA_THREADS = 256             # csrc/mona_spatial.cu::S_THREADS
SECTOR = 32                   # bytes of one memory sector: a CTA's channels at most


def _grouped(t, c, b):
    """[B, h, w, C] -> [1, C*B, h, w]: one conv group per (channel, sample)."""
    return t.permute(3, 0, 1, 2).reshape(1, c * b, *t.shape[1:3])


def mona_spatial_plain(s, freq, kernels, bias):
    """Plain PyTorch version: float32 batch-in-channels grouped conv (one
    group per sample and channel), cast back to s.dtype.

    s: [B, h, w, C]; freq: [C]; kernels: [B, 7, 7, C]; bias: [B, C].
    """
    b, h, w, c = s.shape
    f32 = torch.float32
    s32 = s.to(f32)
    u = _grouped(s32 * freq.to(f32), c, b)
    k = kernels.to(f32).permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    y = F.conv2d(u, k, padding=3, groups=c * b)
    y = y.reshape(c, b, h, w).permute(1, 2, 3, 0)
    return (y + bias.to(f32)[:, None, None, :] + s32).to(s.dtype)


def mona_spatial_backward_plain(s, freq, kernels, g):
    """Plain (ds, dfreq, dkernels, dbias) of the JAX kernel's
    ``_mona_bwd_kernel``, float32 throughout: du is g correlated with the
    flipped kernels, ds = freq * du + g, dk[b, di, dj, c] = sum of g times
    the (di, dj)-shifted u = s * freq, dfreq = sum over (B, h, w) of s * du,
    dbias = sum over (h, w) of g. ds, dfreq and dk take their inputs' dtypes;
    dbias stays float32, as the TPU kernel returns it."""
    b, h, w, c = s.shape
    f32 = torch.float32
    s32, g32, f = s.to(f32), g.to(f32), freq.to(f32)
    k = kernels.to(f32).permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    # d(correlation)/du is the correlation with the 180-degree-rotated kernel
    du = F.conv2d(_grouped(g32, c, b), k.flip(-1, -2), padding=3, groups=c * b)
    du = du.reshape(c, b, h, w).permute(1, 2, 3, 0)
    up = F.pad(s32 * f, (0, 0, 3, 3, 3, 3))
    dk = torch.stack([torch.stack([(g32 * up[:, di:di + h, dj:dj + w]).sum((1, 2))
                                   for dj in range(7)], 1) for di in range(7)], 1)
    ds = (f * du + g32).to(s.dtype)
    dfreq = (s32 * du).sum((0, 1, 2)).to(freq.dtype)
    return ds, dfreq, dk.to(kernels.dtype), g32.sum((1, 2))


class Grid(NamedTuple):
    """The stencil kernels' geometry: bytes a vector copy moves, channels a
    CTA owns, CTAs of rows a sample (strips)."""
    access: int
    cg: int
    strips: int


@functools.lru_cache(maxsize=None)
def _grid(h, w, c, elem, align=16):
    """The kernels' geometry for a [B, h, w, c] tensor of ``elem``-byte
    elements whose operands are ``align``-byte aligned: the widest access
    that divides a pixel's c * elem bytes and the alignment; the widest
    group of whole vectors dividing c within one 32-byte sector whose h
    rows fit in one CTA (one thread a channel and row, CTA_THREADS at most),
    else the narrowest; and only as many strips of rows a sample as that
    cap needs (a strip adds a cross-CTA sum to the backward, which timed
    slower than a fuller CTA at every path shape)."""
    access = next(a for a in ACCESS_BYTES
                  if a >= elem and (c * elem) % a == 0 and align % a == 0)
    ve = access // elem
    groups = [k for k in range(ve, c + 1, ve)
              if c % k == 0 and (k == ve or k * elem <= SECTOR)]
    cg = max([k for k in groups if k * h <= CTA_THREADS] or [ve])
    rows = min(h, CTA_THREADS // cg)
    return Grid(access, cg, -(-h // rows))


def _align(*ts):
    """The largest power of two up to 16 dividing every tensor's address."""
    bits = 16
    for t in ts:
        bits |= t.data_ptr()
    return bits & -bits


def _strip_backward(s, freq, kernels, g, strips):
    """(ds, dfreq, dk, dbias), float32, summed in the backward kernel's
    order (csrc/mona_spatial.cu::spatial_stencil_bwd): du per pixel with
    the flipped taps in (di, dj) order; each (sample, row, channel)
    thread's partials of the 49 taps' g * u, of s * du and of g, each summed
    over its row's columns in order; the strip's rows added in order, the
    strips in order; dfreq's per-sample partials added over the samples in
    order. For the tests: the kernel's arithmetic, on the CPU."""
    b, h, w, c = s.shape
    f32 = torch.float32
    s32, g32, f = s.to(f32), g.to(f32), freq.to(f32)
    k = kernels.to(f32)
    gp = F.pad(g32, (0, 0, 3, 3, 3, 3))
    du = torch.zeros_like(s32)
    for di in range(7):
        for dj in range(7):
            du = du + gp[:, 6 - di:6 - di + h, 6 - dj:6 - dj + w] * k[:, di, dj, None, None]
    ds = f * du + g32
    up = F.pad(s32 * f, (0, 0, 3, 3, 3, 3))
    rows = torch.zeros(b, h, 51, c)  # per thread: the 49 taps, s * du, g
    for x in range(w):
        col = torch.stack([g32[:, :, x] * up[:, di:di + h, x + dj]
                           for di in range(7) for dj in range(7)]
                          + [s32[:, :, x] * du[:, :, x], g32[:, :, x]], 2)
        rows = rows + col
    sr = -(-h // strips)
    total = torch.zeros(b, 51, c)
    for y0 in range(0, h, sr):
        strip = torch.zeros(b, 51, c)
        for y in range(y0, min(h, y0 + sr)):
            strip = strip + rows[:, y]
        total = total + strip
    dfreq = torch.zeros(c)
    for i in range(b):
        dfreq = dfreq + total[i, 49]
    return ds, dfreq, total[:, :49].reshape(b, 7, 7, c), total[:, 50]


_TICKETS = {}


def _tickets(dev, n):
    """A zeroed int32 buffer of at least n tickets for the backward kernel on
    ``dev``'s current stream, kept across calls: the kernel's last CTAs put
    back to 0 what they count, so no call fills it."""
    key = (dev, build.stream(dev))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return t


def _check_cuda(s, op="mona_spatial", **named):
    b, h, w, c = s.shape
    expect = {"freq": (c,), "kernels": (b, 7, 7, c), "bias": (b, c), "g": (b, h, w, c)}
    for name, t in named.items():
        if tuple(t.shape) != expect[name] or t.device != s.device or t.dtype != s.dtype:
            raise ValueError(f"{op}: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; expected {expect[name]} {s.dtype} on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if s.dtype not in build.DTYPE_CODES or not s.is_contiguous():
        raise ValueError(f"{op}: its input must be contiguous float32 or bfloat16, "
                         f"got {s.dtype}")


def _check_device(s, op="mona_spatial"):
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {s.device}")


def _geometry(x, *operands):
    """``_grid`` for x [B, h, w, C] and its operands' alignment."""
    return _grid(*x.shape[1:], x.element_size(), _align(x, *operands))


def _forward_cuda(s, freq, kernels, bias):
    _check_cuda(s, freq=freq, kernels=kernels, bias=bias)
    return MONA_SPATIAL(s, freq, kernels, bias)


def _spatial_launch(s, freq, kernels, bias):
    """The registered op ``nextgen_uia::mona_spatial``: one launch of the
    forward kernel, counted in ``mona_spatial.launches``."""
    b, h, w, c = s.shape
    out = torch.empty_like(s)
    grid = _geometry(s, freq, kernels, out)
    lib = build.library()
    with torch.cuda.device(s.device):
        build.check(lib.nx_mona_spatial(s.data_ptr(), freq.data_ptr(), kernels.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(),
                                        build.DTYPE_CODES[s.dtype], b, h, w, c, *grid,
                                        build.stream(s.device)),
                    "mona_spatial")
    mona_spatial.launches += 1
    return out


MONA_SPATIAL = register("mona_spatial",
                        "(Tensor s, Tensor freq, Tensor kernels, Tensor bias) -> Tensor",
                        _spatial_launch, lambda s, *_: torch.empty_like(s))


def _scratch(x, grid, taps):
    """(float32 partials, tickets) of the backward kernel for x [B, h, w, C]
    with ``taps`` partial sums a (sample, channel): per-sample dfreq
    (taps > 49), then each strip's (strips > 1); tickets per channel group,
    then per (sample, group)."""
    b, _, _, c = x.shape
    groups = c // grid.cg
    strips = grid.strips > 1
    part = torch.empty(max(1, b * c * (taps > 49) + strips * b * c * grid.strips * taps),
                       device=x.device, dtype=torch.float32)
    return part, _tickets(x.device, groups + strips * b * groups)


def _backward_cuda(s, freq, kernels, g, dbias_dtype):
    """The backward kernel: (ds, dfreq, dk, dbias), dbias in ``dbias_dtype``."""
    b, h, w, c = s.shape
    g = g.to(s.dtype).contiguous()
    _check_cuda(s, freq=freq, kernels=kernels, g=g)
    ds, dk = torch.empty_like(s), torch.empty_like(kernels)
    dfreq = torch.empty_like(freq)
    dbias = torch.empty(b, c, device=s.device, dtype=dbias_dtype)
    grid = _geometry(s, freq, kernels, g, ds)
    part, tickets = _scratch(s, grid, 51)
    lib = build.library()
    with torch.cuda.device(s.device):
        build.check(lib.nx_mona_spatial_bwd(
            s.data_ptr(), freq.data_ptr(), kernels.data_ptr(), g.data_ptr(), ds.data_ptr(),
            dk.data_ptr(), dfreq.data_ptr(), dbias.data_ptr(), build.DTYPE_CODES[dbias_dtype],
            part.data_ptr(), tickets.data_ptr(), build.DTYPE_CODES[s.dtype], b, h, w, c, *grid,
            build.stream(s.device)), "mona_spatial backward")
    mona_spatial_backward.launches += 1
    return ds, dfreq, dk, dbias


def mona_spatial_backward(s, freq, kernels, g):
    """(ds, dfreq, dkernels, dbias) for the output gradient g: on a CUDA
    tensor one launch of the backward kernel of csrc/mona_spatial.cu (counted
    in ``mona_spatial_backward.launches``; every sum, dfreq's over the batch
    too, inside it, dbias float32), on a CPU tensor
    ``mona_spatial_backward_plain``."""
    _check_device(s)
    if s.device.type == "cpu":
        return mona_spatial_backward_plain(s, freq, kernels, g)
    return _backward_cuda(s, freq, kernels, g, torch.float32)


class _MonaSpatial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, freq, kernels, bias):
        _check_device(s)
        ctx.save_for_backward(s, freq, kernels)
        if s.device.type == "cpu":
            return mona_spatial_plain(s, freq, kernels, bias)
        return _forward_cuda(s, freq, kernels, bias)

    @staticmethod
    def backward(ctx, g):
        s, freq, kernels = ctx.saved_tensors
        if s.device.type == "cpu":
            ds, dfreq, dk, dbias = mona_spatial_backward_plain(s, freq, kernels, g)
            return ds, dfreq, dk, dbias.to(s.dtype)
        return _backward_cuda(s, freq, kernels, g, s.dtype)  # dbias in bias's dtype


def mona_spatial(s, freq, kernels, bias):
    """MONA spatial chain ``dwconv7(s * freq) + bias + s``, differentiable.

    s: [B, h, w, C]; freq: [C]; kernels: [B, 7, 7, C]; bias: [B, C], all of
    one dtype (float32 or bfloat16). Any device other than CPU and CUDA
    raises.
    """
    return _MonaSpatial.apply(s, freq, kernels, bias)


mona_spatial.launches = 0
mona_spatial_backward.launches = 0


def dwconv7_per_sample_plain(x, kernels):
    """Plain PyTorch version, the JAX package's formulation off the TPU
    (adapters/mona.py::_dwconv7_per_sample): the batch folded into the
    channels, one grouped convolution with a group per (channel, sample),
    float32, cast back to x.dtype.

    x: [B, h, w, C]; kernels: [B, 7, 7, C]."""
    b, h, w, c = x.shape
    k = kernels.to(torch.float32).permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    y = F.conv2d(_grouped(x.to(torch.float32), c, b), k, padding=3, groups=c * b)
    return y.reshape(c, b, h, w).permute(1, 2, 3, 0).to(x.dtype)


def dwconv7_per_sample_backward_plain(x, kernels, g):
    """Plain (dx, dkernels) of the JAX kernel's ``_bwd_kernel``, float32:
    dx is g correlated with the flipped kernels, dk[b, di, dj, c] the sum of
    g times the (di, dj)-shifted x; dx in x.dtype, dk accumulated in float32
    and cast to the kernels' dtype."""
    b, h, w, c = x.shape
    f32 = torch.float32
    g32 = g.to(f32)
    k = kernels.to(f32).permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    dx = F.conv2d(_grouped(g32, c, b), k.flip(-1, -2), padding=3, groups=c * b)
    dx = dx.reshape(c, b, h, w).permute(1, 2, 3, 0)
    xp = F.pad(x.to(f32), (0, 0, 3, 3, 3, 3))
    dk = torch.stack([torch.stack([(g32 * xp[:, di:di + h, dj:dj + w]).sum((1, 2))
                                   for dj in range(7)], 1) for di in range(7)], 1)
    return dx.to(x.dtype), dk.to(kernels.dtype)


def _dwconv7_cuda(x, kernels):
    b, h, w, c = x.shape
    _check_cuda(x, "dwconv7_per_sample", kernels=kernels)
    out = torch.empty_like(x)
    grid = _geometry(x, kernels, out)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_dwconv7(x.data_ptr(), kernels.data_ptr(), out.data_ptr(),
                                   build.DTYPE_CODES[x.dtype], b, h, w, c, *grid,
                                   build.stream(x.device)), "dwconv7_per_sample")
    dwconv7_per_sample.launches += 1
    return out


def dwconv7_per_sample_backward(x, kernels, g):
    """(dx, dkernels) for the output gradient g: on a CUDA tensor one
    launch of the backward kernel of csrc/mona_spatial.cu (counted in
    ``dwconv7_per_sample_backward.launches``; dk summed in float32 and
    written in the kernels' dtype), on a CPU tensor
    ``dwconv7_per_sample_backward_plain``."""
    _check_device(x, "dwconv7_per_sample")
    if x.device.type == "cpu":
        return dwconv7_per_sample_backward_plain(x, kernels, g)
    b, h, w, c = x.shape
    g = g.to(x.dtype).contiguous()
    _check_cuda(x, "dwconv7_per_sample", kernels=kernels, g=g)
    dx, dk = torch.empty_like(x), torch.empty_like(kernels)
    grid = _geometry(x, kernels, g, dx)
    part, tickets = _scratch(x, grid, 49)
    lib = build.library()
    with torch.cuda.device(x.device):
        build.check(lib.nx_dwconv7_bwd(
            x.data_ptr(), kernels.data_ptr(), g.data_ptr(), dx.data_ptr(), dk.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), build.DTYPE_CODES[x.dtype], b, h, w, c, *grid,
            build.stream(x.device)), "dwconv7_per_sample backward")
    dwconv7_per_sample_backward.launches += 1
    return dx, dk


class _Dwconv7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels):
        _check_device(x, "dwconv7_per_sample")
        ctx.save_for_backward(x, kernels)
        if x.device.type == "cpu":
            return dwconv7_per_sample_plain(x, kernels)
        return _dwconv7_cuda(x, kernels)

    @staticmethod
    def backward(ctx, g):
        return dwconv7_per_sample_backward(*ctx.saved_tensors, g)


def dwconv7_per_sample(x, kernels):
    """Per-sample depthwise 7x7 'SAME' convolution, differentiable.

    x: [B, h, w, C]; kernels: [B, 7, 7, C] (one kernel per sample and
    channel), of one dtype (float32 or bfloat16). Returns [B, h, w, C]."""
    return _Dwconv7.apply(x, kernels)


dwconv7_per_sample.launches = 0
dwconv7_per_sample_backward.launches = 0
