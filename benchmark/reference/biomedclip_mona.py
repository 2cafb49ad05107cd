"""Plain PyTorch reference of BiomedCLIP with hybrid MONA adapters, written
from the models' descriptions: the timm ViT-B/16 image tower (pre-norm
blocks, exact GELU, final LayerNorm over every token, CLS pooled, a
bias-free projection), MONA (Yin et al., arXiv:2408.08345) after each
block, PubMedBERT (post-norm, CLS pooled, a two-layer bias-free projection
with GELU) for the cached text features, InfoNCE, clipping to a global norm
and AdamW with a cosine rate. It imports nothing of the port.

It runs in float32 with TF32 off. ``q`` rounds every product's operands and
every activation the configuration keeps in bf16 (the residual stream, each
layer's output): the identity for the reference, ``lower_precision`` (fp8
e4m3 with a per-tensor scale) for the control, the bf16 path computed one
step lower. Two witnesses, not controls, for ``benchmark.control``:
``KERNELS_BF16``, the reference exact but for MONA's per-sample mixed
kernels and biases, held in bf16 both ways (the values forward, their
gradients backward), as the configuration's bf16 spatial operator holds
them; ``BF16``, those and every point ``q`` marks held in bf16 both ways:
the configuration's own precision, computed by the reference.

Hybrid MONA on tokens x [B, 1 + g*g, D]:

    z = LN(x) * gamma + x * gammax;  z = z @ down + b
    s = z's patch rows as [B, C, g, g] scaled per channel by freq_filter
    a = softmax(fc2(relu(fc1(mean_hw(s)))))                 [B, 3]
    y = sum_k a_k (dwconv_k(s) + b_k) + z's patch rows       k = 3, 5, 7
    y = y + pw(y);  z = cat(z's CLS row, y)
    out = x + dropout(gelu(z), 0.1) @ up + b
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference._common import adamw_steps, bf16_both, exact, lower_precision

# the control: this reference one precision step below the configuration's bf16
CONTROL = lower_precision


def KERNELS_BF16(t):  # noqa: N802 - a precision, named as the others
    return t


# the rounding of MONA's per-sample kernels and biases (``_mona``); exact
# where a precision does not name one
KERNELS_BF16.kernels = bf16_both


def BF16(t):  # noqa: N802
    return bf16_both(t)


BF16.kernels = bf16_both
WITNESSES = {"kernels_bf16": KERNELS_BF16, "bf16": BF16}

FROZEN = lambda name: "mona" not in name  # noqa: E731


def _u(fan_in: int):
    b = 1.0 / math.sqrt(fan_in)
    return ("uniform", -b, b)


def _ln(name, d):
    return [(f"{name}.scale", (d,), ("ones",)), (f"{name}.bias", (d,), ("zeros",))]


def _lin(name, i, o, bias=True):
    out = [(f"{name}.w", (i, o), _u(i))]
    return out + [(f"{name}.b", (o,), _u(i))] if bias else out


def _attn(name, d):
    return sum((_lin(f"{name}.{t}", d, d) for t in "qkvo"), [])


def param_spec(s: dict, *, text: bool = True):
    """(name, shape, init) of every tensor, named as the port's state dict."""
    d, c, p = s["width"], s["mona_bottleneck"], s["patch_size"]
    n_tok = (s["image_size"] // p) ** 2 + 1
    spec = [("logit_scale", (), ("const", math.log(1.0 / 0.07))),
            ("visual.cls", (d,), ("normal", d ** -0.5)),
            ("visual.pos", (n_tok, d), ("normal", d ** -0.5)),
            ("visual.patch.w", (p, p, 3, d), _u(p * p * 3)),
            ("visual.patch.b", (d,), _u(p * p * 3))]
    for i in range(s["depth"]):
        b = f"visual.blocks.{i}"
        spec += _ln(f"{b}.ln1", d) + _attn(f"{b}.attn", d) + _ln(f"{b}.ln2", d)
        spec += _lin(f"{b}.mlp.fc1", d, s["mlp_dim"]) + _lin(f"{b}.mlp.fc2", s["mlp_dim"], d)
        m = f"{b}.mona"
        spec += [(f"{m}.gamma", (d,), ("const", 1e-6)), (f"{m}.gammax", (d,), ("ones",)),
                 (f"{m}.freq_filter", (c,), ("ones",))]
        spec += _ln(f"{m}.norm", d) + _lin(f"{m}.down", d, c) + _lin(f"{m}.up", c, d)
        for k in (3, 5, 7):
            spec += [(f"{m}.conv{k}.w", (k, k, 1, c), _u(k * k)),
                     (f"{m}.conv{k}.b", (c,), _u(k * k))]
        spec += [(f"{m}.pw.w", (1, 1, c, c), _u(c)), (f"{m}.pw.b", (c,), _u(c))]
        spec += _lin(f"{m}.noise_est.fc1", c, c // 4) + _lin(f"{m}.noise_est.fc2", c // 4, 3)
    spec += _ln("visual.norm", d) + [("visual.proj.w", (d, s["embed_dim"]),
                                      ("normal", d ** -0.5))]
    if text:
        t, hid = s["text_width"], (s["text_width"] + s["embed_dim"]) // 2
        e = "text.embeddings"
        spec += [(f"{e}.word.w", (s["vocab_size"], t), ("normal", 0.02)),
                 (f"{e}.position.w", (s["max_positions"], t), ("normal", 0.02)),
                 (f"{e}.token_type.w", (s["type_vocab"], t), ("normal", 0.02))]
        spec += _ln(f"{e}.ln", t)
        for i in range(s["text_depth"]):
            b = f"text.layers.{i}"
            spec += _attn(f"{b}.attn", t) + _ln(f"{b}.attn_ln", t)
            spec += (_lin(f"{b}.ffn.fc1", t, s["text_intermediate"])
                     + _lin(f"{b}.ffn.fc2", s["text_intermediate"], t) + _ln(f"{b}.ffn_ln", t))
        spec += _lin("text.proj.fc1", t, hid, bias=False)
        spec += _lin("text.proj.fc2", hid, s["embed_dim"], bias=False)
    return spec


def prepare(weights: dict) -> dict:
    """The weights as the configuration serves them: the frozen ones rounded
    to bf16 values, the trainable MONA tensors as drawn."""
    return {k: (v.to(torch.bfloat16).float() if FROZEN(k) else v) for k, v in weights.items()}


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def _layernorm(x, w, name, eps):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.scale"], w[f"{name}.bias"], eps)


def _linear(x, w, name, q):
    y = q(x) @ q(w[f"{name}.w"])
    b = w.get(f"{name}.b")
    return y if b is None else y + b


def _attention(x, w, name, heads, q, key_bias=None):
    b, n, d = x.shape
    dh = d // heads
    qh, kh, vh = (_linear(x, w, f"{name}.{t}", q).view(b, n, heads, dh).transpose(1, 2)
                  for t in "qkv")
    scores = (q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(dh)
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = (q(probs) @ q(vh)).transpose(1, 2).reshape(b, n, d)
    return _linear(out, w, f"{name}.o", q)


def _mona(x, w, name, s, q, draw):
    d, c = x.shape[-1], s["mona_bottleneck"]
    z = _layernorm(x, w, f"{name}.norm", s["mona_ln_eps"]) * w[f"{name}.gamma"]
    z = _linear(z + x * w[f"{name}.gammax"], w, f"{name}.down", q)
    b, n, _ = z.shape
    g = s["image_size"] // s["patch_size"]
    patches = z[:, 1:1 + g * g].reshape(b, g, g, c).permute(0, 3, 1, 2)
    u = patches * w[f"{name}.freq_filter"].view(1, c, 1, 1)
    h = torch.relu(_linear(u.mean(dim=(2, 3)), w, f"{name}.noise_est.fc1", exact))
    a = torch.softmax(_linear(h, w, f"{name}.noise_est.fc2", exact), dim=-1)
    y = patches
    kq = getattr(q, "kernels", None)
    if kq is None:
        for i, k in enumerate((3, 5, 7)):
            kern = w[f"{name}.conv{k}.w"].permute(3, 2, 0, 1)           # [C, 1, k, k]
            y = y + a[:, i, None, None, None] * F.conv2d(u, kern, w[f"{name}.conv{k}.b"],
                                                          padding=k // 2, groups=c)
    else:
        # one 7x7 kernel and bias a sample: the three branches mixed by a
        kerns = torch.stack([F.pad(w[f"{name}.conv{k}.w"][:, :, 0, :],
                                   (0, 0, (7 - k) // 2, (7 - k) // 2, (7 - k) // 2, (7 - k) // 2))
                             for k in (3, 5, 7)])                     # [3, 7, 7, C]
        kern = kq(torch.einsum("bs,shwc->bhwc", a, kerns))
        bias = kq(a @ torch.stack([w[f"{name}.conv{k}.b"] for k in (3, 5, 7)]))
        per = F.conv2d(u.reshape(1, b * c, g, g), kern.permute(0, 3, 1, 2).reshape(b * c, 1, 7, 7),
                       padding=3, groups=b * c).reshape(b, c, g, g)
        y = y + per + bias[:, :, None, None]
    y = q(y.permute(0, 2, 3, 1).reshape(b, g * g, c))
    y = q(y + q(y) @ q(w[f"{name}.pw.w"][0, 0]) + w[f"{name}.pw.b"])
    z = torch.cat([z[:, :1], y, z[:, 1 + g * g:]], dim=1)
    z = F.gelu(z)
    if draw is not None:
        keep = 1.0 - s["mona_dropout"]
        z = z * ((draw < keep).to(z.dtype) / keep)
    return q(x + _linear(z, w, f"{name}.up", q))


def _block(x, w, i, s, q, draw):
    b, eps = f"visual.blocks.{i}", s["ln_eps"]
    x = q(x + _attention(_layernorm(x, w, f"{b}.ln1", eps), w, f"{b}.attn", s["heads"], q))
    h = F.gelu(_linear(_layernorm(x, w, f"{b}.ln2", eps), w, f"{b}.mlp.fc1", q))
    x = q(x + _linear(h, w, f"{b}.mlp.fc2", q))
    return _mona(x, w, f"{b}.mona", s, q, draw)


def image_features(w, s, images, q=exact, draws=None, recompute=False):
    """images [B, H, W, 3] float in [0, 1] -> [B, embed]. ``draws``: the
    uniform draws [B, N, C] of each block's MONA dropout (None: eval).
    ``recompute``: keep only block boundaries for the backward."""
    p = s["patch_size"]
    x = F.conv2d(q(images.permute(0, 3, 1, 2)), q(w["visual.patch.w"].permute(3, 2, 0, 1)),
                 w["visual.patch.b"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = q(torch.cat([w["visual.cls"].expand(x.shape[0], 1, -1), x], dim=1) + w["visual.pos"])
    for i in range(s["depth"]):
        draw = None if draws is None else draws[i]
        if recompute:
            x = checkpoint(_block, x, w, i, s, q, draw, use_reentrant=False)
        else:
            x = _block(x, w, i, s, q, draw)
    x = _layernorm(x, w, "visual.norm", s["ln_eps"])[:, 0]
    return q(x) @ q(w["visual.proj.w"])


@torch.no_grad()
def text_features(w, s, tokens, q=exact, chunk: int = 128):
    """token ids [B, L] (0 is padding) -> [B, embed]."""
    outs = []
    for t in tokens.split(chunk):
        e = "text.embeddings"
        x = (w[f"{e}.word.w"][t] + w[f"{e}.position.w"][:t.shape[1]]
             + w[f"{e}.token_type.w"][0])
        x = q(_layernorm(x, w, f"{e}.ln", s["text_ln_eps"]))
        bias = (t == 0).to(torch.float32) * -1e9
        for i in range(s["text_depth"]):
            b = f"text.layers.{i}"
            a = _attention(x, w, f"{b}.attn", s["text_heads"], q, bias)
            x = q(_layernorm(x + a, w, f"{b}.attn_ln", s["text_ln_eps"]))
            h = _linear(F.gelu(_linear(x, w, f"{b}.ffn.fc1", q)), w, f"{b}.ffn.fc2", q)
            x = q(_layernorm(x + h, w, f"{b}.ffn_ln", s["text_ln_eps"]))
        h = F.gelu(_linear(x[:, 0], w, "text.proj.fc1", q))
        outs.append(_linear(h, w, "text.proj.fc2", q))
    return torch.cat(outs)


def info_nce(img, txt, temperature):
    img = img / img.norm(dim=1, keepdim=True).clamp(min=1e-12)
    txt = txt / txt.norm(dim=1, keepdim=True).clamp(min=1e-12)
    logits = img @ txt.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


# ---------------------------------------------------------------------------
# the step and the zero-shot logits
# ---------------------------------------------------------------------------


def train_reference(weights, s, batches, steps: int, q=exact, start=None):
    """The fine-tune step ``steps`` times from ``weights`` (as drawn), or
    from ``start`` (``adamw_steps``'s, with 'leaves': the trainable tensors
    part-way through training). ``batches[t]``: {'images' [B, H, W, 3],
    'tokens' [B, L], 'draws': [depth x [B, N, C]]}."""
    w = prepare(weights)
    theta = {k: v.clone() for k, v in w.items() if not FROZEN(k)}
    if start is not None:
        theta = {k: start["leaves"][k].clone() for k in theta}
    frozen = {k: v for k, v in w.items() if FROZEN(k)}
    txt = [text_features(frozen, s, b["tokens"], q) for b in batches[:steps]]

    def loss_of(t, params):
        img = image_features({**frozen, **params}, s, batches[t]["images"], q,
                             batches[t]["draws"], recompute=True)
        return info_nce(img, txt[t], s["temperature"])

    return adamw_steps(loss_of, theta, s["optimizer"], steps, start)


@torch.no_grad()
def zero_shot_logits(weights, s, images_u8, prompts: dict, q=exact, chunk: int = 64):
    """uint8 images [B, H, W, 3] -> [B, n_classes]: per class the mean over
    its prompt features of 100 * cos."""
    w = prepare(weights)
    out = []
    for x in images_u8.split(chunk):
        f = image_features(w, s, x.to(torch.float32) / 255.0, q)
        f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        out.append(torch.stack([(100.0 * f @ p.T).mean(dim=1) for p in prompts.values()], 1))
    return torch.cat(out)
