"""UNet segmentation baseline, NHWC (counterpart of
nextgen_uia_tpu/models/unet.py).

Five levels of double 3x3 conv + BatchNorm + LeakyReLU(0.01) with per-level
dropout (0.05, 0.1, 0.2, 0.3, 0.5) after the first conv, 2x2 max pool
downsampling; four decoder levels of a 1x1 conv, bilinear x2 upsampling
with align_corners=True and the double conv over the skip read concat-free
(``conv2d_cat``); a 3x3 conv to the class logits, returned NCHW. The
BatchNorm running statistics live in a second tree (``enc{i}/bn{1,2}``,
``dec{i}/bn{1,2}``) updated in place in train mode. Dropout draws from the
caller's generator (torch's stream, not jax.random's: tests hand both
packages the same masks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (BatchNorm, BatchNormState, Conv, batchnorm, conv2d, conv2d_cat,
                         dropout, dropout_mask, max_pool, resize_bilinear_align_corners)

DROPOUTS = (0.05, 0.1, 0.2, 0.3, 0.5)


def _convblock_init(gen, cin: int, cout: int):
    p, s = nn.Module(), nn.Module()
    p.conv1 = Conv(gen, 3, 3, cin, cout)
    p.bn1 = BatchNorm(cout)
    p.conv2 = Conv(gen, 3, 3, cout, cout)
    p.bn2 = BatchNorm(cout)
    s.bn1, s.bn2 = BatchNormState(cout), BatchNormState(cout)
    return p, s


def _convblock_apply(p, s, x, *, train: bool, gen, drop_p: float, cat=None):
    # cat: the decoder's second input; conv1 reads cat([x, cat], -1) concat-free
    x = conv2d(p.conv1, x) if cat is None else conv2d_cat(p.conv1, x, cat)
    x = F.leaky_relu(batchnorm(p.bn1, s.bn1, x, train=train), 0.01)
    if train and gen is not None and drop_p > 0.0:
        x = dropout(x, drop_p, mask=dropout_mask(gen, drop_p, x.shape, device=x.device))
    x = conv2d(p.conv2, x)
    return F.leaky_relu(batchnorm(p.bn2, s.bn2, x, train=train), 0.01)


def unet_init(gen: torch.Generator, in_channels: int, num_classes: int,
              init_channels: int = 16):
    """(params, BatchNorm state), drawn from ``gen`` on the CPU."""
    ch = [init_channels * m for m in (1, 2, 4, 8, 16)]
    params, state = nn.Module(), nn.Module()
    for i in range(5):
        p, s = _convblock_init(gen, in_channels if i == 0 else ch[i - 1], ch[i])
        params.add_module(f"enc{i}", p)
        state.add_module(f"enc{i}", s)
    for i in range(4):
        params.add_module(f"upconv{i}", Conv(gen, 1, 1, ch[4 - i], ch[3 - i]))
        p, s = _convblock_init(gen, ch[3 - i] * 2, ch[3 - i])
        params.add_module(f"dec{i}", p)
        state.add_module(f"dec{i}", s)
    params.out = Conv(gen, 3, 3, ch[0], num_classes)
    return params, state


def unet_apply(params, state, x: torch.Tensor, *, train: bool = False,
               gen: torch.Generator | None = None) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, num_classes, H, W]. Train mode uses the
    batch statistics (``state`` updated in place) and, given ``gen``, the
    encoder's dropout."""
    feats, h = [], x
    for i in range(5):
        if i > 0:
            h = max_pool(h, 2, 2)
        h = _convblock_apply(getattr(params, f"enc{i}"), getattr(state, f"enc{i}"), h,
                             train=train, gen=gen, drop_p=DROPOUTS[i])
        feats.append(h)
    h = feats[4]
    for i in range(4):
        h = conv2d(getattr(params, f"upconv{i}"), h)
        h = resize_bilinear_align_corners(h, (h.shape[1] * 2, h.shape[2] * 2))
        # conv1 reads cat([skip, up], -1)
        h = _convblock_apply(getattr(params, f"dec{i}"), getattr(state, f"dec{i}"), feats[3 - i],
                             cat=h, train=train, gen=gen, drop_p=0.0)
    return conv2d(params.out, h).permute(0, 3, 1, 2)
