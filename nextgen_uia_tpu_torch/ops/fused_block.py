"""Whole pre-norm transformer block forward (counterpart of
nextgen_uia_tpu/ops/fused_block.py::fused_block_infer).

    y   = x + Wo @ attn(LN1(x)) + bo
    out = y + fc2(act(fc1(LN2(y))))

``fused_block_infer`` launches the hand-written kernels of
csrc/fused_block.cu for a CUDA tensor and runs ``fused_block_infer_plain``
for a CPU tensor only. The plain version follows the JAX package's
``_xla_reference`` and keeps the kernel's rounding points.

Forward only, pre-norm, with or without the causal mask (``causal=True``:
the CLIP text tower, -1e30 where key > row, applied after ``key_bias``).
The post-norm BERT layout comes with the BERT text tower.
"""

from __future__ import annotations

import math

import torch

from ..nn.layers import ACTIVATIONS
from . import build
from .build import ACT_CODES, DTYPE_CODES


def _check_layout(layout: str, act: str):
    if layout != "prenorm":
        raise NotImplementedError(
            "fused_block_infer: only the pre-norm block is ported "
            "(post-norm BERT blocks: ROADMAP.md, section B, K1)")
    if act not in ACT_CODES:
        raise ValueError(f"fused_block_infer: unsupported activation {act!r}")


def fused_block_infer_plain(x, p, *, heads: int, act: str = "gelu", eps: float = 1e-5,
                            key_bias=None, n_real: int | None = None,
                            causal: bool = False, layout: str = "prenorm"):
    """Plain PyTorch version of the block: float32 products with the
    kernel's rounding points (z, q/k/v, probabilities, head concat, z2 and h
    rounded to x.dtype; y32 and the fc2 sum in float32)."""
    _check_layout(layout, act)
    b, n, d = x.shape
    hd = d // heads
    dt = x.dtype
    f32 = torch.float32
    n_real = n if n_real is None else n_real

    def ln(t32, lnp):
        mu = t32.mean(-1, keepdim=True)
        var = ((t32 - mu) ** 2).mean(-1, keepdim=True)
        return (t32 - mu) * torch.rsqrt(var + eps) * lnp.scale + lnp.bias

    def proj(z, lin):
        return z.to(f32) @ lin.w.to(dt).to(f32) + lin.b.to(f32)

    x32 = x.to(f32)
    z = ln(x32, p.ln1).to(dt)
    q, k, v = (proj(z, lin).to(dt).reshape(b, n, heads, hd).transpose(1, 2)
               for lin in (p.attn.q, p.attn.k, p.attn.v))
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) / math.sqrt(hd)
    col = torch.arange(n, device=x.device)
    s = torch.where(col >= n_real, torch.full_like(s, -1e30), s)
    if key_bias is not None:
        s = s + key_bias.to(f32)[:, None, None, :]
    if causal:
        s = torch.where(col[None, :] > col[:, None], torch.full_like(s, -1e30), s)
    prob = torch.softmax(s, dim=-1).to(dt)
    oh = prob.to(f32) @ v.to(f32)
    cat = oh.transpose(1, 2).reshape(b, n, d).to(dt)
    y32 = proj(cat, p.attn.o) + x32
    z2 = ln(y32, p.ln2).to(dt)
    h = ACTIVATIONS[act](proj(z2, p.mlp.fc1)).to(dt)
    return (y32 + proj(h, p.mlp.fc2)).to(dt)


def _check_cuda_shapes(x, p, heads, key_bias, n_real):
    b, n, d = x.shape
    hidden = p.mlp.fc1.w.shape[1]
    dh = d // heads if d % heads == 0 else 0
    problems = []
    if x.dtype not in DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % 64 or dh not in (32, 64):
        problems.append(f"width {d} with {heads} heads (width % 64 == 0, head dim 32 or 64)")
    if hidden % 64:
        problems.append(f"hidden {hidden} (multiple of 64)")
    if not 1 <= n <= 256:
        problems.append(f"{n} tokens (1..256)")
    if not 0 < n_real <= n:
        problems.append(f"n_real {n_real}")
    if not x.is_contiguous():
        problems.append("non-contiguous x")
    if key_bias is not None and (key_bias.shape != (b, n) or key_bias.device != x.device):
        problems.append(f"key_bias {tuple(key_bias.shape)} on {key_bias.device}")
    if problems:
        raise ValueError("fused_block_infer CUDA kernel does not take: " + "; ".join(problems))


def fused_block_infer(x, p, *, heads: int, act: str = "gelu", eps: float = 1e-5,
                      key_bias=None, n_real: int | None = None, causal: bool = False,
                      layout: str = "prenorm"):
    """One whole pre-norm block, forward only.

    x: [B, N, D] float32 or bfloat16; p: a models.vit.Block (ln1, attn,
    ln2, mlp). key_bias [B, N] float32 is added to the scores; keys at or
    beyond ``n_real`` are masked, and with ``causal`` the keys after each
    query row. On a CUDA tensor this launches the kernels
    of csrc/fused_block.cu (and counts one launch in
    ``fused_block_infer.launches``); on a CPU tensor it runs
    ``fused_block_infer_plain``. Any other device raises.
    """
    _check_layout(layout, act)
    if x.device.type == "cpu":
        return fused_block_infer_plain(x, p, heads=heads, act=act, eps=eps,
                                       key_bias=key_bias, n_real=n_real, causal=causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_infer: unsupported device {x.device}")
    b, n, d = x.shape
    n_real = n if n_real is None else n_real
    _check_cuda_shapes(x, p, heads, key_bias, n_real)
    dt, code = x.dtype, DTYPE_CODES[x.dtype]
    f32 = torch.float32
    m, hidden, dh = b * n, p.mlp.fc1.w.shape[1], d // heads
    att = p.attn

    def vec(t):
        return t.detach().to(device=x.device, dtype=f32).contiguous()

    def mat(t):
        return t.detach().to(device=x.device, dtype=dt).contiguous()

    w_qkv = mat(torch.cat([att.q.w, att.k.w, att.v.w], dim=1))
    b_qkv = vec(torch.cat([att.q.b, att.k.b, att.v.b]))
    wo, w1, w2 = mat(att.o.w), mat(p.mlp.fc1.w), mat(p.mlp.fc2.w)
    bo, b1, b2 = vec(att.o.b), vec(p.mlp.fc1.b), vec(p.mlp.fc2.b)
    g1, be1, g2, be2 = vec(p.ln1.scale), vec(p.ln1.bias), vec(p.ln2.scale), vec(p.ln2.bias)
    kb = None if key_bias is None else vec(key_bias)

    z = torch.empty(m, d, device=x.device, dtype=dt)
    qkv = torch.empty(m, 3 * d, device=x.device, dtype=dt)
    cat = torch.empty(m, d, device=x.device, dtype=dt)
    y32 = torch.empty(m, d, device=x.device, dtype=f32)
    z2 = torch.empty(m, d, device=x.device, dtype=dt)
    h = torch.empty(m, hidden, device=x.device, dtype=dt)
    out = torch.empty(b, n, d, device=x.device, dtype=dt)

    lib = build.library()
    with torch.cuda.device(x.device):
        stream = build.stream(x.device)
        build.check(lib.nx_layernorm(x.data_ptr(), code, g1.data_ptr(), be1.data_ptr(),
                                     z.data_ptr(), code, m, d, eps, stream), "LN1")
        build.check(lib.nx_gemm(build.ptr(z), build.ptr(w_qkv), code, b_qkv.data_ptr(), None,
                                0, qkv.data_ptr(), code, 0, m, 3 * d, d, stream), "qkv")
        build.check(lib.nx_attention(qkv.data_ptr(), None if kb is None else kb.data_ptr(),
                                     cat.data_ptr(), code, b, n, heads, dh, n_real,
                                     int(causal), 1.0 / math.sqrt(dh), stream), "attention")
        build.check(lib.nx_gemm(build.ptr(cat), build.ptr(wo), code, bo.data_ptr(),
                                x.data_ptr(), code, y32.data_ptr(), 0, 0, m, d, d, stream),
                    "o-proj")
        build.check(lib.nx_layernorm(y32.data_ptr(), 0, g2.data_ptr(), be2.data_ptr(),
                                     z2.data_ptr(), code, m, d, eps, stream), "LN2")
        build.check(lib.nx_gemm(build.ptr(z2), build.ptr(w1), code, b1.data_ptr(), None, 0,
                                h.data_ptr(), code, ACT_CODES[act], m, hidden, d, stream),
                    "fc1")
        build.check(lib.nx_gemm(build.ptr(h), build.ptr(w2), code, b2.data_ptr(),
                                y32.data_ptr(), 0, out.data_ptr(), code, 0, m, d, hidden,
                                stream), "fc2")
    fused_block_infer.launches += 1
    return out


fused_block_infer.launches = 0
