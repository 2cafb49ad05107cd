"""Operations and bytes of one step or batch of ``biomedclip_mona``, from the
shapes alone, whatever implements them: (name, flops, bytes, precision).

The unit is a layer: a product counts 2*M*K*N operations, and each layer
reads its input and weights and writes its output once, in the dtype the
configuration computes it in (bf16: 2 bytes); what stays inside a layer
(q|k|v, the attention scores, the MLP's hidden) is not counted as traffic.
A pre-norm block is two layers (attention with its LayerNorm, projections
and residual; the MLP with its LayerNorm and residual), MONA two (its
products with their LayerNorm, activation and residual; its depthwise
stencils on the CUDA cores, precision 'fp32').

The train step differentiates every block's frozen layers for their input
gradient (the products once more; attention's backward is four products
against the forward's two) except the first block's, which no trainable
tensor precedes; MONA's layers for their weight gradients and, but for the
first block's down-projection, their input gradients; the head, InfoNCE and
AdamW over the MONA tensors (7 float32 passes).
"""

from __future__ import annotations

E = 2  # bytes of a bf16 element


def _mm(name, m, k, n, e=E, prec="bf16"):
    return (name, 2 * m * k * n, e * (m * k + k * n + m * n), prec)


def _block_fwd(b, n, d, h, f):
    m = b * n
    attn = 2 * m * d * 3 * d + 4 * b * n * n * d + 2 * m * d * d
    return [("attn_block", attn, E * (2 * m * d + 4 * d * d), "bf16"),
            ("mlp_block", 4 * m * d * f, E * (2 * m * d + 2 * d * f), "bf16")]


def _block_bwd(b, n, d, h, f):
    m = b * n
    attn = 2 * m * d * 3 * d + 8 * b * n * n * d + 2 * m * d * d
    return [("attn_block_bwd", attn, E * (3 * m * d + 4 * d * d), "bf16"),
            ("mlp_block_bwd", 4 * m * d * f, E * (3 * m * d + 2 * d * f), "bf16")]


def _mona(b, n, d, c, g, train, first):
    m = b * n
    w = E * (2 * d * c + c * c)
    prods = 2 * m * d * c + 2 * b * g * g * c * c + 2 * m * c * d
    stencil = 2 * b * g * g * c * 49
    ops = [("mona_proj", prods, E * 2 * m * d + w + (4 * m * c if train else 0), "bf16"),
           ("mona_dwconv", stencil, E * 2 * b * g * g * c, "fp32")]
    if train:
        dgrad = prods - (2 * m * d * c if first else 0)
        ops += [("mona_proj_bwd", dgrad + prods, E * 3 * m * d + 2 * w, "bf16"),
                ("mona_dwconv_bwd", 2 * stencil, E * 3 * b * g * g * c, "fp32")]
    return ops


def n_trainable(s) -> int:
    d, c = s["width"], s["mona_bottleneck"]
    per = 5 * d + c + d * c + c + c * d + d + (9 + 25 + 49) * c + 3 * c + c * c + c
    per += c * (c // 4) + c // 4 + (c // 4) * 3 + 3
    return per * s["depth"]


def work(s: dict, traffic: dict, kind: str) -> list:
    b, p, d = traffic["batch"], s["patch_size"], s["width"]
    g = s["image_size"] // p
    n, h, f, c, e = g * g + 1, s["heads"], s["mlp_dim"], s["mona_bottleneck"], s["embed_dim"]
    train = kind == "train"
    ops = [] if train else [("preprocess", 0, b * g * g * p * p * 3 * (1 + 4), "bf16")]
    ops.append(_mm("patch_embed", b * g * g, p * p * 3, d))
    for i in range(s["depth"]):
        ops += _block_fwd(b, n, d, h, f) + _mona(b, n, d, c, g, train, i == 0)
        if train and i > 0:
            ops += _block_bwd(b, n, d, h, f)
    ops += [("final_ln", 0, E * 2 * b * n * d, "bf16"), _mm("proj", b, d, e)]
    if train:
        ops += [_mm("proj_bwd", b, e, d), ("final_ln_bwd", 0, E * 3 * b * n * d, "bf16"),
                _mm("info_nce", b, e, b, e=4, prec="fp32"),
                _mm("info_nce_bwd", b, e, b, e=4, prec="fp32"),
                ("adamw", 0, 7 * 4 * n_trainable(s), "fp32")]
    else:
        ops.append(_mm("zero_shot", b, e, 2 * traffic["prompts_per_class"], e=4, prec="fp32"))
    return ops
