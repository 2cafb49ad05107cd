"""ResNet classification baselines (18/34/50/101/152), NHWC (counterpart of
nextgen_uia_tpu/models/resnet.py).

torchvision's resnet family as the reference baselines use it, written by
hand (torchvision is not a dependency): a 7x7/2 stem, a 3x3/2 max pool,
four stages of basic or bottleneck blocks, the global mean and ``fc``. The
parameter tree carries the JAX package's names (``stem/conv/w``,
``layer{i}/{b}/{c1,c2,c3,down}/{conv,bn}/...``, ``fc/{w,b}``), so the
converter's ``resnet*`` output and the JAX package's checkpoints load by
name; the BatchNorm running statistics live in a second tree that mirrors
it (``stem/bn/{mean,var}``, ...), updated in place in train mode.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import (BatchNorm, BatchNormState, Conv, Linear, batchnorm, conv2d, linear,
                         max_pool)

# arch -> (block kind, blocks per stage); the converter reads this table too
SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def conv_bn_init(gen, kh: int, kw: int, cin: int, cout: int):
    """(params ``conv`` (no bias) + ``bn``, state ``bn``)."""
    p, s = nn.Module(), nn.Module()
    p.conv = Conv(gen, kh, kw, cin, cout, bias=False)
    p.bn = BatchNorm(cout)
    s.bn = BatchNormState(cout)
    return p, s


def conv_bn(p, s, x: torch.Tensor, *, stride: int = 1, train: bool = False) -> torch.Tensor:
    """The convolution padded by k // 2 on each side (torch's padding, which
    stride 2 needs spelled out), then BatchNorm."""
    pad = p.conv.w.shape[0] // 2
    return batchnorm(p.bn, s.bn, conv2d(p.conv, x, stride=stride, padding=pad), train=train)


def _block_init(gen, kind: str, cin: int, cout: int, stride: int):
    p, s = nn.Module(), nn.Module()
    if kind == "basic":
        p.c1, s.c1 = conv_bn_init(gen, 3, 3, cin, cout)
        p.c2, s.c2 = conv_bn_init(gen, 3, 3, cout, cout)
        out_ch = cout
    else:
        p.c1, s.c1 = conv_bn_init(gen, 1, 1, cin, cout)
        p.c2, s.c2 = conv_bn_init(gen, 3, 3, cout, cout)
        p.c3, s.c3 = conv_bn_init(gen, 1, 1, cout, cout * 4)
        out_ch = cout * 4
    if stride != 1 or cin != out_ch:
        p.down, s.down = conv_bn_init(gen, 1, 1, cin, out_ch)
    return p, s, out_ch


def _block_apply(p, s, x, kind: str, stride: int, *, train: bool):
    if kind == "basic":
        y = torch.relu(conv_bn(p.c1, s.c1, x, stride=stride, train=train))
        y = conv_bn(p.c2, s.c2, y, train=train)
    else:
        y = torch.relu(conv_bn(p.c1, s.c1, x, train=train))
        y = torch.relu(conv_bn(p.c2, s.c2, y, stride=stride, train=train))
        y = conv_bn(p.c3, s.c3, y, train=train)
    identity = conv_bn(p.down, s.down, x, stride=stride, train=train) if hasattr(p, "down") else x
    return torch.relu(y + identity)


def resnet_init(gen: torch.Generator, arch: str, *, in_channels: int = 3,
                num_classes: int = 2):
    """(params, BatchNorm state) of ``arch``, drawn from ``gen`` on the CPU."""
    kind, layout = SPECS[arch]
    params, state = nn.Module(), nn.Module()
    params.stem, state.stem = conv_bn_init(gen, 7, 7, in_channels, 64)
    cin = 64
    for stage, nblocks in enumerate(layout):
        cout = 64 * 2 ** stage
        blocks_p, blocks_s = nn.ModuleList(), nn.ModuleList()
        for b in range(nblocks):
            bp, bs, cin = _block_init(gen, kind, cin, cout, 2 if stage > 0 and b == 0 else 1)
            blocks_p.append(bp)
            blocks_s.append(bs)
        params.add_module(f"layer{stage + 1}", blocks_p)
        state.add_module(f"layer{stage + 1}", blocks_s)
    params.fc = Linear(gen, cin, num_classes)
    return params, state


def resnet_apply(params, state, x: torch.Tensor, arch: str, *, train: bool = False):
    """x [B, H, W, C] -> logits [B, num_classes]. Train mode normalizes by
    the batch statistics and updates ``state`` in place."""
    kind, layout = SPECS[arch]
    y = torch.relu(conv_bn(params.stem, state.stem, x, stride=2, train=train))
    y = max_pool(y, 3, 2, 1)
    for stage, nblocks in enumerate(layout):
        stage_p, stage_s = getattr(params, f"layer{stage + 1}"), getattr(state, f"layer{stage + 1}")
        for b in range(nblocks):
            y = _block_apply(stage_p[b], stage_s[b], y, kind, 2 if stage > 0 and b == 0 else 1,
                             train=train)
    return linear(params.fc, y.mean(dim=(1, 2)))
