"""Whole transformer block forward (counterpart of
nextgen_uia_tpu/ops/fused_block.py::fused_block_infer), in either layout:

    pre-norm  (ViT, CLIP text):  y   = x + Wo @ attn(LN1(x)) + bo
                                 out = y + fc2(act(fc1(LN2(y))))
    post-norm (BERT):            y   = LN_attn(x + Wo @ attn(x) + bo)
                                 out = LN_ffn(y + fc2(act(fc1(y))))

``fused_block_infer`` launches the hand-written kernels of
csrc/fused_block.cu for a CUDA tensor and runs ``fused_block_infer_plain``
for a CPU tensor only. The plain version follows the JAX package's
``_xla_reference`` and keeps the kernel's rounding points.

Forward only, with or without the causal mask (``causal=True``: the CLIP
text tower, -1e30 where key > row, applied after ``key_bias``). The
post-norm layout counts its launches in ``fused_block_infer_postnorm``;
autograd reaching it on the card raises. BERT runs it only when
``bert_block_opted_in()`` (the JAX package's gate on its chip, where the
whole-layer kernel measured slower than the three-kernel chain).
"""

from __future__ import annotations

import math
import os

import torch

from ..nn.layers import ACTIVATIONS
from . import build
from ._frozen import forward_only
from .build import ACT_CODES, DTYPE_CODES


def bert_block_opted_in() -> bool:
    """Whether BERT's frozen forward runs each layer through the post-norm
    whole-block kernel (``NEXTGEN_UIA_FUSED_BLOCK_BERT=1``) rather than the
    three-kernel chain, the default; the one place that reads it."""
    return os.environ.get("NEXTGEN_UIA_FUSED_BLOCK_BERT") == "1"


def _check_layout(layout: str, act: str):
    if layout not in ("prenorm", "postnorm"):
        raise ValueError(f"fused_block_infer: unknown layout {layout!r}")
    if act not in ACT_CODES:
        raise ValueError(f"fused_block_infer: unsupported activation {act!r}")


def _parts(p, layout):
    """(LN of the attention sublayer, attention, LN of the MLP sublayer,
    MLP): models.vit.Block's ln1/attn/ln2/mlp or models.bert.BertLayer's
    attn/attn_ln/ffn/ffn_ln."""
    if layout == "prenorm":
        return p.ln1, p.attn, p.ln2, p.mlp
    return p.attn_ln, p.attn, p.ffn_ln, p.ffn


def fused_block_infer_plain(x, p, *, heads: int, act: str = "gelu", eps: float = 1e-5,
                            key_bias=None, n_real: int | None = None,
                            causal: bool = False, layout: str = "prenorm"):
    """Plain PyTorch version of the block: float32 products with the
    kernel's rounding points (z, q/k/v, probabilities, head concat, z2 and h
    rounded to x.dtype; y32 and the fc2 sum in float32; post-norm: y32 =
    LN_a(...) in float32, z2 its rounded copy, the output LN_b of the
    float32 sum)."""
    _check_layout(layout, act)
    ln_a, att, ln_b, mlp = _parts(p, layout)
    prenorm = layout == "prenorm"
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
    z = ln(x32, ln_a).to(dt) if prenorm else x
    q, k, v = (proj(z, lin).to(dt).reshape(b, n, heads, hd).transpose(1, 2)
               for lin in (att.q, att.k, att.v))
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
    y32 = proj(cat, att.o) + x32
    if not prenorm:
        y32 = ln(y32, ln_a)
    z2 = (ln(y32, ln_b) if prenorm else y32).to(dt)
    h = ACTIVATIONS[act](proj(z2, mlp.fc1)).to(dt)
    out = y32 + proj(h, mlp.fc2)
    return (out if prenorm else ln(out, ln_b)).to(dt)


def _check_cuda_shapes(x, mlp, heads, key_bias, n_real):
    b, n, d = x.shape
    hidden = mlp.fc1.w.shape[1]
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
    """One whole block, forward only.

    x: [B, N, D] float32 or bfloat16; p: a models.vit.Block (ln1, attn,
    ln2, mlp) or, ``layout="postnorm"``, a models.bert.BertLayer (attn,
    attn_ln, ffn, ffn_ln). key_bias [B, N] float32 is added to the scores;
    keys at or beyond ``n_real`` are masked, and with ``causal`` the keys
    after each query row. On a CUDA tensor this launches the kernels of
    csrc/fused_block.cu (and counts one launch in
    ``fused_block_infer.launches``, or ``fused_block_infer_postnorm``'s);
    on a CPU tensor it runs ``fused_block_infer_plain``. Any other device
    raises.
    """
    _check_layout(layout, act)
    if x.device.type == "cpu":
        return fused_block_infer_plain(x, p, heads=heads, act=act, eps=eps,
                                       key_bias=key_bias, n_real=n_real, causal=causal,
                                       layout=layout)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_infer: unsupported device {x.device}")
    if layout == "postnorm":
        return fused_block_infer_postnorm(x, p, heads=heads, act=act, eps=eps,
                                          key_bias=key_bias, n_real=n_real, causal=causal)
    b, n, d = x.shape
    n_real = n if n_real is None else n_real
    _check_cuda_shapes(x, p.mlp, heads, key_bias, n_real)
    w = _weights(x, p, "prenorm", key_bias)
    dt, code = x.dtype, DTYPE_CODES[x.dtype]
    m, hidden, dh = b * n, w["w1"].shape[1], d // heads

    z = torch.empty(m, d, device=x.device, dtype=dt)
    qkv = torch.empty(m, 3 * d, device=x.device, dtype=dt)
    cat = torch.empty(m, d, device=x.device, dtype=dt)
    y32 = torch.empty(m, d, device=x.device, dtype=torch.float32)
    z2 = torch.empty(m, d, device=x.device, dtype=dt)
    out = torch.empty(b, n, d, device=x.device, dtype=dt)

    lib = build.library()
    with torch.cuda.device(x.device):
        stream = build.stream(x.device)
        build.check(lib.nx_layernorm(x.data_ptr(), code, w["ga"].data_ptr(),
                                     w["ba"].data_ptr(), z.data_ptr(), code, m, d, eps, stream),
                    "LN1")
        _attention(lib, z, w, qkv, cat, code, b, n, heads, dh, n_real, causal, stream)
        build.check(lib.nx_gemm(build.ptr(cat), build.ptr(w["wo"]), code, w["bo"].data_ptr(),
                                x.data_ptr(), code, y32.data_ptr(), 0, 0, m, d, d, stream),
                    "o-proj")
        build.check(lib.nx_layernorm(y32.data_ptr(), 0, w["gb"].data_ptr(), w["bb"].data_ptr(),
                                     z2.data_ptr(), code, m, d, eps, stream), "LN2")
        _mlp(lib, z2, y32, out, w, code, act, m, d, hidden, stream)
    fused_block_infer.launches += 1
    return out


def _weights(x, p, layout, key_bias):
    """The block's weights as the kernels take them: matrices in x.dtype,
    vectors float32, all on x's device."""
    f32, dt = torch.float32, x.dtype
    ln_a, att, ln_b, mlp = _parts(p, layout)

    def vec(t):
        return t.detach().to(device=x.device, dtype=f32).contiguous()

    def mat(t):
        return t.detach().to(device=x.device, dtype=dt).contiguous()

    return dict(w_qkv=mat(torch.cat([att.q.w, att.k.w, att.v.w], dim=1)),
                b_qkv=vec(torch.cat([att.q.b, att.k.b, att.v.b])),
                wo=mat(att.o.w), bo=vec(att.o.b), w1=mat(mlp.fc1.w), b1=vec(mlp.fc1.b),
                w2=mat(mlp.fc2.w), b2=vec(mlp.fc2.b), ga=vec(ln_a.scale), ba=vec(ln_a.bias),
                gb=vec(ln_b.scale), bb=vec(ln_b.bias),
                kb=None if key_bias is None else vec(key_bias))


def _attention(lib, z, w, qkv, cat, code, b, n, heads, dh, n_real, causal, stream):
    """qkv = z @ [Wq|Wk|Wv] + b, then cat = the heads' attention over it."""
    m, d = b * n, heads * dh
    build.check(lib.nx_gemm(build.ptr(z), build.ptr(w["w_qkv"]), code, w["b_qkv"].data_ptr(),
                            None, 0, qkv.data_ptr(), code, 0, m, 3 * d, d, stream), "qkv")
    kb = w["kb"]
    build.check(lib.nx_attention(qkv.data_ptr(), None if kb is None else kb.data_ptr(),
                                 cat.data_ptr(), code, b, n, heads, dh, n_real, int(causal),
                                 1.0 / math.sqrt(dh), stream), "attention")


def _mlp(lib, z2, res, out, w, code, act, m, d, hidden, stream):
    """out = act(z2 @ W1 + b1) @ W2 + b2 + res (res float32; out in the
    dtype of ``code`` or float32)."""
    h = torch.empty(m, hidden, device=z2.device, dtype=z2.dtype)
    out_code = 0 if out.dtype == torch.float32 else code
    build.check(lib.nx_gemm(build.ptr(z2), build.ptr(w["w1"]), code, w["b1"].data_ptr(), None,
                            0, h.data_ptr(), code, ACT_CODES[act], m, hidden, d, stream), "fc1")
    build.check(lib.nx_gemm(build.ptr(h), build.ptr(w["w2"]), code, w["b2"].data_ptr(),
                            res.data_ptr(), 0, out.data_ptr(), out_code, 0, m, d, hidden,
                            stream), "fc2")


def _postnorm_cuda(x, p, heads, act, eps, key_bias, n_real, causal):
    b, n, d = x.shape
    _check_cuda_shapes(x, p.ffn, heads, key_bias, n_real)
    w = _weights(x, p, "postnorm", key_bias)
    dt, code = x.dtype, DTYPE_CODES[x.dtype]
    f32 = torch.float32
    m, hidden, dh = b * n, w["w1"].shape[1], d // heads

    qkv = torch.empty(m, 3 * d, device=x.device, dtype=dt)
    cat = torch.empty(m, d, device=x.device, dtype=dt)
    s32 = torch.empty(m, d, device=x.device, dtype=f32)
    y32 = torch.empty(m, d, device=x.device, dtype=f32)
    # float32 blocks feed fc1 the float32 y32 itself: its rounded copy is it
    z2 = y32 if dt == f32 else torch.empty(m, d, device=x.device, dtype=dt)
    out = torch.empty(b, n, d, device=x.device, dtype=dt)

    lib = build.library()
    with torch.cuda.device(x.device):
        stream = build.stream(x.device)
        _attention(lib, x, w, qkv, cat, code, b, n, heads, dh, n_real, causal, stream)
        build.check(lib.nx_gemm(build.ptr(cat), build.ptr(w["wo"]), code, w["bo"].data_ptr(),
                                x.data_ptr(), code, s32.data_ptr(), 0, 0, m, d, d, stream),
                    "o-proj")
        build.check(lib.nx_layernorm_dual(s32.data_ptr(), w["ga"].data_ptr(),
                                          w["ba"].data_ptr(), y32.data_ptr(),
                                          None if z2 is y32 else z2.data_ptr(), code, m, d,
                                          eps, stream), "LN_attn")
        _mlp(lib, z2, y32, s32, w, code, act, m, d, hidden, stream)
        build.check(lib.nx_layernorm(s32.data_ptr(), 0, w["gb"].data_ptr(), w["bb"].data_ptr(),
                                     out.data_ptr(), code, m, d, eps, stream), "LN_ffn")
    fused_block_infer_postnorm.launches += 1
    return out


def fused_block_infer_postnorm(x, p, *, heads: int, act: str = "gelu", eps: float = 1e-12,
                               key_bias=None, n_real: int | None = None,
                               causal: bool = False):
    """One post-norm (BERT) layer on the card, forward only: the kernels of
    csrc/fused_block.cu in the post-norm order (counted in
    ``fused_block_infer_postnorm.launches``); autograd reaching it raises."""
    n_real = x.shape[1] if n_real is None else n_real
    return forward_only("fused_block_infer_postnorm",
                        lambda x_: _postnorm_cuda(x_, p, heads, act, eps, key_bias, n_real,
                                                  causal), x.contiguous())


fused_block_infer.launches = 0
fused_block_infer_postnorm.launches = 0
