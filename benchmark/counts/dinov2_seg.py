"""Operations and bytes of one step or batch of ``dinov2_seg``, from the
shapes alone: (name, flops, bytes, precision).

The frozen encoder runs forward only, in bf16 (2-byte elements), counted
by layer as ``counts/biomedclip_mona.py`` counts its blocks; the
decoder's convolutions in TF32 (the configuration leaves cuDNN's TF32 on),
its BatchNorm, ReLU, resizes and the loss in float32 (4-byte elements; the
bicubic resize is two float32 products, TF32 off for products). A
convolution counts 2 * outputs * kernel taps * input channels operations,
its input, weight and output once. The train step's backward counts each
decoder convolution twice (input and weight gradients) except where its
input is the encoder's (weight gradient only), and the elementwise work
read twice and written once.
"""

from __future__ import annotations

from benchmark.reference.dinov2_seg import channels


def _mm(name, m, k, n, e=2, prec="bf16"):
    return (name, 2 * m * k * n, e * (m * k + k * n + m * n), prec)


def _ew(name, nbytes, prec="fp32"):
    return (name, 0, nbytes, prec)


def _conv(name, b, hw_out, taps, cin, cout, hw_in, w_in_grad=True):
    flops = 2 * b * hw_out * taps * cin * cout
    nbytes = 4 * (b * hw_in * cin + taps * cin * cout + b * hw_out * cout)
    return (name, flops, nbytes, "tf32"), w_in_grad


def _encoder(s, b):
    """The frozen encoder forward, each block as its two layers (attention
    and the MLP, each with its LayerNorm, LayerScale and residual: input,
    weights and output once), the five tapped outputs' final LayerNorm."""
    p, d, f = s["patch_size"], s["width"], s["mlp_dim"]
    g = s["image_size"] // p
    n, m = g * g + 1, b * (g * g + 1)
    ops = [_ew("preprocess", b * g * g * p * p * (1 + 2 * 3), "bf16"),
           _mm("patch_embed", b * g * g, p * p * 3, d)]
    for i in range(s["depth"]):
        attn = 2 * m * d * 3 * d + 4 * b * n * n * d + 2 * m * d * d
        ops += [("attn_block", attn, 2 * (2 * m * d + 4 * d * d), "bf16"),
                ("mlp_block", 4 * m * d * f, 2 * (2 * m * d + 2 * d * f), "bf16")]
        if i >= s["depth"] - s["decoder_layers"]:
            ops.append(_ew("final_norm", 2 * m * d + 4 * m * d, "bf16"))
    return ops


def _decoder(s, b, train):
    g, d, ch, size = s["image_size"] // s["patch_size"], s["width"], channels(s), s["image_size"]
    fwd, bwd = [], []
    h = g
    for i in range(4):
        cin, cout = ch[i], ch[i + 1]
        # a 2x2 stride-2 transposed convolution: each input pixel feeds 4 outputs
        up = ((f"up{i}.upconv", 2 * b * h * h * cin * cout * 4,
               4 * (b * h * h * cin + 4 * cin * cout + b * 4 * h * h * cout), "tf32"), i > 0)
        h *= 2
        skip = _conv(f"up{i}.skip_conv", b, g * g, 9, d, cout, g * g, w_in_grad=False)
        conv = _conv(f"up{i}.conv", b, h * h, 9, 2 * cout, cout, h * h)
        act_skip, act = 4 * b * g * g * cout, 4 * b * h * h * cout
        ew = [_ew(f"up{i}.skip_bn_relu", 3 * act_skip), _ew(f"up{i}.skip_resize", 4 * b * (
            g * g + h * h) * cout), _ew(f"up{i}.bn_relu", 3 * act)]
        for op, in_grad in (up, skip, conv):
            fwd.append(op)
            if train:
                name, flops, nbytes, prec = op
                bwd.append((f"{name}_wgrad", flops, nbytes, prec))
                if in_grad:
                    bwd.append((f"{name}_dgrad", flops, nbytes, prec))
        fwd += ew
        bwd += [(f"{n}_bwd", 0, nb * 3 // 2, p) for n, _, nb, p in ew] if train else []
    c, src = ch[4], 2 ** 4 * g
    fwd += [_mm("resize_rows", b * c * src, src, size, e=4, prec="fp32"),
            _mm("resize_cols", b * c * size, src, size, e=4, prec="fp32")]
    if train:
        bwd += [_mm("resize_rows_bwd", b * c * src, size, src, e=4, prec="fp32"),
                _mm("resize_cols_bwd", b * c * size, size, src, e=4, prec="fp32"),
                _ew("dice_ce", 4 * b * size * size * (3 * c + 1))]
    return fwd + bwd


def n_decoder_params(s) -> int:
    d, ch = s["width"], channels(s)
    n = 0
    for i in range(4):
        cin, cout = ch[i], ch[i + 1]
        n += 4 * cin * cout + cout + 9 * 2 * cout * cout + cout + 9 * d * cout + cout + 4 * cout
    return n


def work(s: dict, traffic: dict, kind: str) -> list:
    b, train = traffic["batch"], kind == "train"
    ops = _encoder(s, b) + _decoder(s, b, train)
    if train:
        ops.append(_ew("adamw", 7 * 4 * n_decoder_params(s)))
    else:
        size = s["image_size"]
        ops.append(_ew("argmax", b * size * size * (4 * s["num_classes"] + 1)))
    return ops
