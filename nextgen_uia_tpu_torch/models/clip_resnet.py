"""OpenAI CLIP's ModifiedResNet vision tower, NHWC (counterpart of
nextgen_uia_tpu/models/clip_resnet.py).

- A three-conv stem (the first of stride 2), then a 2x2 average pool.
- Anti-aliased strides: every conv has stride 1; an average pool of size
  ``stride`` runs after the second conv, and before the 1x1 downsample.
- AttentionPool2d: one query (the mean token) over the 1 + HW tokens, a
  learned positional embedding, float32 scores, projected to the CLIP
  embedding width.

Encode-only with eval-mode BatchNorm from the converted running statistics
(``python -m nextgen_uia_tpu_torch.convert modified_resnet`` writes the
parameters at the root and the statistics under ``__state__/``). The JAX
package computes it without a Pallas kernel, so plain torch is its
counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.layers import Linear, batchnorm, conv2d, linear, normal, param, avg_pool
from .resnet import conv_bn_init

EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: tuple = (3, 4, 6, 3)          # RN50
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224
    width: int = 64

    @property
    def embed_dim(self):
        return self.width * 32

    @property
    def grid(self):
        return self.input_resolution // 32


RN50 = ModifiedResNetConfig()
RN101 = ModifiedResNetConfig(layers=(3, 4, 23, 3), output_dim=512)


def _conv_bn(p, s, x, *, stride: int = 1):
    pad = p.conv.w.shape[0] // 2
    return batchnorm(p.bn, s.bn, conv2d(p.conv, x, stride=stride, padding=pad), train=False)


def _bottleneck_init(gen, cin: int, planes: int, stride: int):
    p, s = nn.Module(), nn.Module()
    p.c1, s.c1 = conv_bn_init(gen, 1, 1, cin, planes)
    p.c2, s.c2 = conv_bn_init(gen, 3, 3, planes, planes)
    p.c3, s.c3 = conv_bn_init(gen, 1, 1, planes, planes * EXPANSION)
    if stride > 1 or cin != planes * EXPANSION:
        p.down, s.down = conv_bn_init(gen, 1, 1, cin, planes * EXPANSION)
    return p, s


def _bottleneck(p, s, x, stride: int):
    y = torch.relu(_conv_bn(p.c1, s.c1, x))
    y = torch.relu(_conv_bn(p.c2, s.c2, y))
    y = _conv_bn(p.c3, s.c3, avg_pool(y, stride))
    identity = _conv_bn(p.down, s.down, avg_pool(x, stride)) if hasattr(p, "down") else x
    return torch.relu(y + identity)


class AttentionPool(nn.Module):
    """``pos`` [grid^2 + 1, D] and the q, k, v, c projections."""

    def __init__(self, gen, cfg: ModifiedResNetConfig):
        super().__init__()
        d = cfg.embed_dim
        self.pos = param(normal(gen, (cfg.grid * cfg.grid + 1, d), d ** -0.5))
        self.q, self.k, self.v = (Linear(gen, d, d) for _ in range(3))
        self.c = Linear(gen, d, cfg.output_dim)


def _attnpool(p: AttentionPool, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Single-query multi-head pool: the query is the mean token."""
    b, n, d = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + p.pos[None].to(x.dtype)
    hd = d // heads
    q = linear(p.q, x[:, :1]).reshape(b, 1, heads, hd)
    k = linear(p.k, x).reshape(b, n + 1, heads, hd)
    v = linear(p.v, x).reshape(b, n + 1, heads, hd)
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    att = torch.softmax(att, dim=-1).to(x.dtype)
    pooled = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, 1, d)
    return linear(p.c, pooled)[:, 0]


def modified_resnet_init(gen: torch.Generator, cfg: ModifiedResNetConfig = RN50):
    """(params, BatchNorm state), drawn from ``gen`` on the CPU."""
    w = cfg.width
    params, state = nn.Module(), nn.Module()
    params.stem1, state.stem1 = conv_bn_init(gen, 3, 3, 3, w // 2)
    params.stem2, state.stem2 = conv_bn_init(gen, 3, 3, w // 2, w // 2)
    params.stem3, state.stem3 = conv_bn_init(gen, 3, 3, w // 2, w)
    cin = w
    for stage, nblocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        blocks_p, blocks_s = nn.ModuleList(), nn.ModuleList()
        for b in range(nblocks):
            p, s = _bottleneck_init(gen, cin, planes, 2 if stage > 0 and b == 0 else 1)
            blocks_p.append(p)
            blocks_s.append(s)
            cin = planes * EXPANSION
        params.add_module(f"layer{stage + 1}", blocks_p)
        state.add_module(f"layer{stage + 1}", blocks_s)
    params.attnpool = AttentionPool(gen, cfg)
    return params, state


def modified_resnet_apply(params, state, x: torch.Tensor,
                          cfg: ModifiedResNetConfig = RN50) -> torch.Tensor:
    """x [B, H, W, 3] -> CLIP image features [B, output_dim] (eval BN)."""
    y = torch.relu(_conv_bn(params.stem1, state.stem1, x, stride=2))
    y = torch.relu(_conv_bn(params.stem2, state.stem2, y))
    y = torch.relu(_conv_bn(params.stem3, state.stem3, y))
    y = avg_pool(y, 2)
    for stage, nblocks in enumerate(cfg.layers):
        stage_p, stage_s = getattr(params, f"layer{stage + 1}"), getattr(state, f"layer{stage + 1}")
        for b in range(nblocks):
            y = _bottleneck(stage_p[b], stage_s[b], y, 2 if stage > 0 and b == 0 else 1)
    return _attnpool(params.attnpool, y.reshape(y.shape[0], -1, y.shape[-1]), cfg.heads)
