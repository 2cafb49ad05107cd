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

The kernels are the flash-attention forward (K7, ops/flash_attention.py)
and, in bf16, the Hopper GEMM core: one flat q|k|v product into a row-major
[B*N, 3D] buffer that K7 reads through strides
(``fused_attention._packed_layout``), the head concat row-major [B*N, D]
(``fused_attn_o._layout``), keys >= n_real folded into the float32 key bias
(``fused_attn_o._key_bias``), each weight read as W^T, built once per call
(``_kernel_weights``), and the residual stream float32; the CPU tests
compose the plain versions through the same helpers. A bf16 call needs head
dim 64; float32 takes 1..64; the width and hidden are multiples of 64; any
token count (``fused_block_eligible`` says which blocks it takes).

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
from ._frozen import _cat, forward_only
from .build import ACT_CODES, DTYPE_CODES
from .fused_attention import _packed_layout
from .fused_attn_o import _key_bias
from .registry import register


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


def _problems(x, mlp, heads, key_bias, n_real):
    """What the kernels of csrc/fused_block.cu do not take of this call
    (empty: they take it). The tokens are not bounded: K7 computes the
    attention over any N (1370 at DINOv2's 518 px) and every other step is a
    product or a LayerNorm over the B*N rows."""
    b, n, d = x.shape
    hidden = mlp.fc1.w.shape[1]
    dh = d // heads if d % heads == 0 else 0
    problems = []
    if x.dtype not in DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if d % 64 or (x.dtype == torch.bfloat16 and dh != 64) or not 1 <= dh <= 64:
        problems.append(f"width {d} with {heads} heads, head dim {dh} (width % 64 == 0; "
                        "head dim 64 in bfloat16, 1..64 in float32)")
    if hidden % 64:
        problems.append(f"hidden {hidden} (multiple of 64)")
    if n < 1:
        problems.append(f"{n} tokens")
    if not 0 < n_real <= n:
        problems.append(f"n_real {n_real}")
    if key_bias is not None and (key_bias.shape != (b, n) or key_bias.device != x.device):
        problems.append(f"key_bias {tuple(key_bias.shape)} on {key_bias.device}")
    return problems


def fused_block_eligible(x, p, *, heads: int, act: str) -> bool:
    """Whether ``fused_block_infer`` takes this pre-norm block (a
    models.vit.Block) and input: no LoRA in its attention, and the shapes,
    dtypes and activations its kernels take, on any device (the JAX
    package's ``fused_block_infer`` returns None where this is False, and
    its callers run the composed route)."""
    return ("lora" not in p.attn._modules and act in ACT_CODES
            and not _problems(x, p.mlp, heads, None, x.shape[1]))


def _check_cuda_shapes(x, mlp, heads, key_bias, n_real):
    problems = _problems(x, mlp, heads, key_bias, n_real)
    if not x.is_contiguous():
        problems.append("non-contiguous x")
    if problems:
        raise ValueError(f"fused_block_infer CUDA kernel does not take x {tuple(x.shape)}: "
                         + "; ".join(problems))


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
    return _block_cuda(x, p, "prenorm", heads, act, eps, key_bias,
                       x.shape[1] if n_real is None else n_real, causal)


def _kernel_weights(p, layout, dt):
    """The block's weights as csrc/fused_block.cu takes them, one copy and
    cast each: the products' matrices in dt as W^T [cols, K] (the Hopper
    GEMM core's operand; q|k|v as one [3D, D]), vectors float32."""
    ln_a, att, ln_b, mlp = _parts(p, layout)

    def vec(t):
        return t.detach().to(torch.float32).contiguous()

    return dict(ga=vec(ln_a.scale), ba=vec(ln_a.bias),
                wqkv_t=_cat([att.q.w.T, att.k.w.T, att.v.w.T], dt),
                bqkv=_cat([att.q.b, att.k.b, att.v.b], torch.float32),
                wo_t=_cat([att.o.w.T], dt),
                bo=vec(att.o.b), gb=vec(ln_b.scale), bb=vec(ln_b.bias),
                w1_t=_cat([mlp.fc1.w.T], dt), b1=vec(mlp.fc1.b),
                w2_t=_cat([mlp.fc2.w.T], dt), b2=vec(mlp.fc2.b))


def _block_cuda(x, p, layout, heads, act, eps, key_bias, n_real, causal):
    """The registered op ``nextgen_uia::block_fwd`` on the block's weights
    as the kernels read them (``_kernel_weights``), keys >= n_real folded
    into the float32 key bias (``fused_attn_o._key_bias``)."""
    b, n, _ = x.shape
    _check_cuda_shapes(x, _parts(p, layout)[3], heads, key_bias, n_real)
    w = _kernel_weights(p, layout, x.dtype)
    return BLOCK_FWD(x, *(w[k] for k in _WEIGHT_ORDER), _key_bias(key_bias, b, n, n_real, x.device),
                     heads, act, causal, layout == "postnorm", eps)


_WEIGHT_ORDER = ("ga", "ba", "wqkv_t", "bqkv", "wo_t", "bo", "gb", "bb", "w1_t", "b1", "w2_t",
                 "b2")


def _block_launch(x, ga, ba, wqkv_t, bqkv, wo_t, bo, gb, bb, w1_t, b1, w2_t, b2, kb, heads,
                  act, causal, postnorm, eps):
    """nx_block_fwd: q|k|v in one row-major [B*N, 3D] buffer
    (``fused_attention._packed_layout``), which the attention reads through
    strides, the head concat row-major [B*N, D] (``fused_attn_o._layout``),
    the residual stream float32 (y32, and s32 post-norm); one launch counted
    in ``fused_block_infer.launches`` or, post-norm,
    ``fused_block_infer_postnorm.launches``."""
    b, n, d = x.shape
    dt, dev, f32 = x.dtype, x.device, torch.float32
    m, dh, hidden = b * n, d // heads, w1_t.shape[0]
    qkv = torch.empty(_packed_layout(b, n, heads, dh)[0], device=dev, dtype=dt)
    cat = torch.empty(m, d, device=dev, dtype=dt)
    y32 = torch.empty(m, d, device=dev, dtype=f32)
    s32 = torch.empty(m, d, device=dev, dtype=f32) if postnorm else None
    # float32 post-norm feeds fc1 the float32 y32 itself: its rounded copy is it
    z2 = None if postnorm and dt == f32 else torch.empty(m, d, device=dev, dtype=dt)
    h = torch.empty(m, hidden, device=dev, dtype=dt)
    out = torch.empty(b, n, d, device=dev, dtype=dt)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_block_fwd(
            build.ptr(x, "x"), *(build.ptr(t) for t in (
                ga, ba, wqkv_t, bqkv, wo_t, bo, gb, bb, w1_t, b1, w2_t, b2)),
            build.ptr(kb), build.ptr(qkv), build.ptr(cat), build.ptr(y32), build.ptr(s32),
            build.ptr(z2), build.ptr(h), build.ptr(out), DTYPE_CODES[dt], b, n, heads, dh,
            hidden, ACT_CODES[act], int(causal), int(postnorm), 1.0 / math.sqrt(dh), eps,
            build.stream(dev)), f"fused_block_infer ({'postnorm' if postnorm else 'prenorm'})")
    (fused_block_infer_postnorm if postnorm else fused_block_infer).launches += 1
    return out


BLOCK_FWD = register(
    "block_fwd", "(Tensor x, Tensor ga, Tensor ba, Tensor wqkv_t, Tensor bqkv, Tensor wo_t, "
    "Tensor bo, Tensor gb, Tensor bb, Tensor w1_t, Tensor b1, Tensor w2_t, Tensor b2, "
    "Tensor? key_bias, int heads, str act, bool causal, bool postnorm, float eps) -> Tensor",
    _block_launch, lambda x, *_: torch.empty_like(x))


def fused_block_infer_postnorm(x, p, *, heads: int, act: str = "gelu", eps: float = 1e-12,
                               key_bias=None, n_real: int | None = None,
                               causal: bool = False):
    """One post-norm (BERT) layer on the card, forward only: the kernels of
    csrc/fused_block.cu in the post-norm order (counted in
    ``fused_block_infer_postnorm.launches``); autograd reaching it raises."""
    n_real = x.shape[1] if n_real is None else n_real
    return forward_only("fused_block_infer_postnorm",
                        lambda x_: _block_cuda(x_, p, "postnorm", heads, act, eps, key_bias,
                                               n_real, causal), x.contiguous())


fused_block_infer.launches = 0
fused_block_infer_postnorm.launches = 0
