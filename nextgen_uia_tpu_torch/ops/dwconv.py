"""Fused MONA spatial op, forward (counterpart of
nextgen_uia_tpu/ops/dwconv.py::mona_spatial):

    y = dwconv7(s * freq) + bias + s

with per-sample depthwise 7x7 'SAME' kernels. ``mona_spatial`` launches the
hand-written kernel of csrc/mona_spatial.cu for a CUDA tensor and runs
``mona_spatial_plain`` for a CPU tensor only. The backward comes with
training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mona_spatial_plain(s, freq, kernels, bias):
    """Plain PyTorch version: float32 batch-in-channels grouped conv (one
    group per sample and channel), cast back to s.dtype.

    s: [B, h, w, C]; freq: [C]; kernels: [B, 7, 7, C]; bias: [B, C].
    """
    b, h, w, c = s.shape
    f32 = torch.float32
    s32 = s.to(f32)
    u = (s32 * freq.to(f32)).permute(3, 0, 1, 2).reshape(1, c * b, h, w)  # channel-major
    k = kernels.to(f32).permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    y = F.conv2d(u, k, padding=3, groups=c * b)
    y = y.reshape(c, b, h, w).permute(1, 2, 3, 0)
    return (y + bias.to(f32)[:, None, None, :] + s32).to(s.dtype)


def mona_spatial(s, freq, kernels, bias):
    """MONA spatial chain ``dwconv7(s * freq) + bias + s``.

    s: [B, h, w, C]; freq: [C]; kernels: [B, 7, 7, C]; bias: [B, C], all of
    one dtype (float32 or bfloat16). On a CUDA tensor this launches the
    kernel of csrc/mona_spatial.cu (and counts one launch in
    ``mona_spatial.launches``); on a CPU tensor it runs
    ``mona_spatial_plain``. Any other device raises.
    """
    if s.device.type == "cpu":
        return mona_spatial_plain(s, freq, kernels, bias)
    if s.device.type != "cuda":
        raise ValueError(f"mona_spatial: unsupported device {s.device}")
    b, h, w, c = s.shape
    expect = {"freq": (c,), "kernels": (b, 7, 7, c), "bias": (b, c)}
    for name, t in (("freq", freq), ("kernels", kernels), ("bias", bias)):
        if tuple(t.shape) != expect[name] or t.device != s.device or t.dtype != s.dtype:
            raise ValueError(f"mona_spatial: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; expected {expect[name]} {s.dtype} on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"mona_spatial: {name} is not contiguous")
    if s.dtype not in DTYPE_CODES or not s.is_contiguous():
        raise ValueError(f"mona_spatial: s must be contiguous float32 or bfloat16, "
                         f"got {s.dtype}")
    out = torch.empty_like(s)
    lib = build.library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        build.check(lib.nx_mona_spatial(s.data_ptr(), freq.data_ptr(), kernels.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(),
                                        DTYPE_CODES[s.dtype], b, h, w, c, stream),
                    "mona_spatial")
    mona_spatial.launches += 1
    return out


mona_spatial.launches = 0
