"""Plain PyTorch reference of DINOv2 ViT-B/14 (arXiv:2304.07193) under the
UNet segmentation decoder of the reference repository's dino/segmentation.py,
written from their descriptions; it imports nothing of the port.

- Encoder: patch embedding (14 x 14, stride 14), CLS, positional embedding
  at the trained grid (37 x 37 at 518 px), pre-norm blocks with LayerScale
  (x += ls1 * attn(LN(x)); x += ls2 * mlp(LN(x)), exact GELU), the last five
  blocks' outputs through the final LayerNorm, patch tokens kept, frozen
  (no gradient).
- Decoder, four stages from the deepest map (skips from the four shallower,
  deepest first): x = convT2x2/2(x); s = relu(BN(conv3x3(skip))) resized to
  x's size (bilinear, corners aligned); x = relu(BN(conv3x3(cat(x, s))));
  then x resized to the image size by an antialiased bicubic (Keys, a =
  -0.5, kernel widened by the scale when shrinking, weights renormalised at
  the borders: ``jax.image.resize``'s). Train mode normalises by the batch's
  statistics and moves the running ones (momentum 0.1, unbiased variance).
- Loss: DiceCE (softmax, squared prediction, smooth 1e-8, background kept)
  plus the cross-entropy, on one-hot masks. AdamW, no clipping.

Float32 with TF32 off. ``q`` is (encoder precision, decoder precision),
applied to every product's operands and every activation the part keeps:
the exact pair for the reference; the control lowers each part one step
below what the configuration states (fp8 for the bf16 encoder, bf16 for the
float32 decoder).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference._common import adamw_steps, bf16_precision, lower_precision

exact = (lambda t: t, lambda t: t)
CONTROL = (lower_precision, bf16_precision)


def _u(fan_in: int):
    b = 1.0 / math.sqrt(fan_in)
    return ("uniform", -b, b)


def _ln(name, d):
    return [(f"{name}.scale", (d,), ("ones",)), (f"{name}.bias", (d,), ("zeros",))]


def _lin(name, i, o):
    return [(f"{name}.w", (i, o), _u(i)), (f"{name}.b", (o,), _u(i))]


def _conv(name, k, i, o):
    return [(f"{name}.w", (k, k, i, o), _u(k * k * i)), (f"{name}.b", (o,), _u(k * k * i))]


def channels(s):
    d = s["width"]
    return [d, d // 2, d // 4, d // 8, s["num_classes"]]


def param_spec(s: dict):
    """(name, shape, init): the bundle's parameters ('encoder.', 'head.') and
    the decoder's BatchNorm running statistics ('bn.')."""
    d, p = s["width"], s["patch_size"]
    n_tok = (s["image_size"] // p) ** 2 + 1
    e = "encoder"
    spec = [(f"{e}.cls", (d,), ("normal", d ** -0.5)),
            (f"{e}.pos", (n_tok, d), ("normal", d ** -0.5))]
    spec += _conv(f"{e}.patch", p, 3, d)
    for i in range(s["depth"]):
        b = f"{e}.blocks.{i}"
        spec += [(f"{b}.ls{j}", (d,), ("uniform", 0.5, 1.5)) for j in (1, 2)]
        spec += _ln(f"{b}.ln1", d) + sum((_lin(f"{b}.attn.{t}", d, d) for t in "qkvo"), [])
        spec += _ln(f"{b}.ln2", d) + _lin(f"{b}.mlp.fc1", d, s["mlp_dim"])
        spec += _lin(f"{b}.mlp.fc2", s["mlp_dim"], d)
    spec += _ln(f"{e}.norm", d)
    ch = channels(s)
    for i in range(4):
        h = f"head.up{i}"
        spec += _conv(f"{h}.upconv", 2, ch[i], ch[i + 1]) + _conv(f"{h}.conv", 3, 2 * ch[i + 1],
                                                                   ch[i + 1])
        spec += _ln(f"{h}.conv_bn", ch[i + 1]) + _conv(f"{h}.skip_conv", 3, d, ch[i + 1])
        spec += _ln(f"{h}.skip_bn", ch[i + 1])
    for i in range(4):
        for bn in ("conv_bn", "skip_bn"):
            spec += [(f"bn.up{i}.{bn}.mean", (ch[i + 1],), ("normal", 0.1)),
                     (f"bn.up{i}.{bn}.var", (ch[i + 1],), ("uniform", 0.5, 1.5))]
    return spec


def prepare(weights: dict) -> dict:
    """The frozen encoder's tensors rounded to bf16 values; the decoder and
    its statistics as drawn."""
    return {k: (v.to(torch.bfloat16).float() if k.startswith("encoder.") else v)
            for k, v in weights.items()}


def _layernorm(x, w, name, eps):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.scale"], w[f"{name}.bias"], eps)


def _linear(x, w, name, q):
    return q(x) @ q(w[f"{name}.w"]) + w[f"{name}.b"]


@torch.no_grad()
def encoder_maps(w, s, images, q, n_last: int = 5):
    """images [B, H, W, 3] in [0, 1] -> the last ``n_last`` blocks' patch
    tokens, normed, as maps [B, D, g, g], shallow to deep."""
    p, d, heads = s["patch_size"], s["width"], s["heads"]
    e = "encoder"
    x = F.conv2d(q(images.permute(0, 3, 1, 2)), q(w[f"{e}.patch.w"].permute(3, 2, 0, 1)),
                 w[f"{e}.patch.b"], stride=p)
    b, _, g, _ = x.shape
    x = x.flatten(2).transpose(1, 2)
    x = q(torch.cat([w[f"{e}.cls"].expand(b, 1, d), x], dim=1) + w[f"{e}.pos"])
    n, dh, outs = x.shape[1], d // heads, []
    for i in range(s["depth"]):
        blk = f"{e}.blocks.{i}"
        h = _layernorm(x, w, f"{blk}.ln1", s["ln_eps"])
        qh, kh, vh = (_linear(h, w, f"{blk}.attn.{t}", q).view(b, n, heads, dh).transpose(1, 2)
                      for t in "qkv")
        probs = torch.softmax((q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        a = (q(probs) @ q(vh)).transpose(1, 2).reshape(b, n, d)
        x = q(x + _linear(a, w, f"{blk}.attn.o", q) * w[f"{blk}.ls1"])
        h = F.gelu(_linear(_layernorm(x, w, f"{blk}.ln2", s["ln_eps"]), w, f"{blk}.mlp.fc1", q))
        x = q(x + _linear(h, w, f"{blk}.mlp.fc2", q) * w[f"{blk}.ls2"])
        if i >= s["depth"] - n_last:
            o = q(_layernorm(x, w, f"{e}.norm", s["ln_eps"]))[:, 1:]
            outs.append(o.transpose(1, 2).reshape(b, d, g, g))
    return outs


def _batchnorm(x, w, st, name, train, s, momentum=None):
    key = name[len("head."):]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        m = s["bn_momentum"] if momentum is None else momentum
        with torch.no_grad():
            st[f"{key}.mean"].copy_((1 - m) * st[f"{key}.mean"] + m * mean)
            st[f"{key}.var"].copy_((1 - m) * st[f"{key}.var"] + m * var * n / max(n - 1, 1))
    else:
        mean, var = st[f"{key}.mean"], st[f"{key}.var"]
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var[None, :, None, None] + s["bn_eps"])
    return y * w[f"{name}.scale"][None, :, None, None] + w[f"{name}.bias"][None, :, None, None]


def _keys_cubic(x):
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def _bicubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of an antialiased bicubic resize."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32).item()
    widen = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    wts = _keys_cubic((sample[:, None] - src[None, :]) / widen)
    total = wts.sum(1, keepdim=True)
    wts = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps, wts / total,
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (wts * inside[:, None]).to(torch.float32)


def decoder(w, st, maps, s, train: bool, q, momentum=None):
    """maps (encoder_maps) -> logits [B, classes, S, S]; updates ``st`` in
    train mode (by ``momentum``, default the configuration's)."""
    x, skips = maps[4], [maps[3], maps[2], maps[1], maps[0]]
    for i in range(4):
        h = f"head.up{i}"
        x = q(F.conv_transpose2d(q(x), q(w[f"{h}.upconv.w"].permute(2, 3, 0, 1)),
                                 w[f"{h}.upconv.b"], stride=2))
        sk = F.conv2d(q(skips[i]), q(w[f"{h}.skip_conv.w"].permute(3, 2, 0, 1)),
                      w[f"{h}.skip_conv.b"], padding=1)
        sk = q(torch.relu(_batchnorm(q(sk), w, st, f"{h}.skip_bn", train, s, momentum)))
        sk = F.interpolate(sk, size=x.shape[2:], mode="bilinear", align_corners=True)
        x = F.conv2d(q(torch.cat([x, sk], dim=1)), q(w[f"{h}.conv.w"].permute(3, 2, 0, 1)),
                     w[f"{h}.conv.b"], padding=1)
        x = q(torch.relu(_batchnorm(q(x), w, st, f"{h}.conv_bn", train, s, momentum)))
    n = s["image_size"]
    mh = _bicubic_matrix(x.shape[2], n, x.device)
    mw = _bicubic_matrix(x.shape[3], n, x.device)
    return torch.einsum("oh,bchw->bcow", mh, torch.einsum("pw,bchw->bchp", mw, x))


@torch.no_grad()
def calibrate_bn(weights: dict, s: dict, images_u8) -> dict:
    """``weights`` with the BatchNorm running statistics replaced by those of
    a train-mode pass over ``images_u8`` [n, S, S] (batch means, unbiased
    variances), in float32."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        w, st = _split(prepare(weights))
        x = (images_u8.to(torch.float32) / 255.0)[..., None].expand(-1, -1, -1, 3)
        decoder(w, st, encoder_maps(w, s, x, exact[0]), s, True, exact[1], momentum=1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {**weights, **{f"bn.{k}": v for k, v in st.items()}}


def dice_ce(logits, masks):
    """logits [B, C, H, W], integer masks [B, H, W]."""
    onehot = F.one_hot(masks.long(), logits.shape[1]).permute(0, 3, 1, 2).to(logits.dtype)
    probs = torch.softmax(logits, dim=1)
    inter = (onehot * probs).sum((2, 3))
    dice = 1 - (2 * inter + 1e-8) / ((onehot ** 2).sum((2, 3)) + (probs ** 2).sum((2, 3)) + 1e-8)
    ce = -(onehot * torch.log_softmax(logits, dim=1)).sum(1).mean()
    return dice.mean() + ce


def _split(w):
    return ({k: v for k, v in w.items() if not k.startswith("bn.")},
            {k[3:]: v.clone() for k, v in w.items() if k.startswith("bn.")})


def train_reference(weights, s, batches, steps: int, q=exact, start=None):
    """``steps`` seg steps from ``weights`` (as drawn), or from ``start``
    (``adamw_steps``'s, with 'leaves': the decoder's tensors and statistics
    part-way through training, the statistics under 'bn.'); ``batches[t]``:
    {'images' uint8 [B, S, S], 'masks' uint8 [B, S, S]}. Returns (losses,
    first gradient, change of every decoder tensor and statistic)."""
    w, st = _split(prepare(weights))
    theta = {k: v.clone() for k, v in w.items() if k.startswith("head.")}
    if start is not None:
        theta = {k: start["leaves"][k].clone() for k in theta}
        st = {k: start["leaves"][f"bn.{k}"].clone() for k in st}
    st0 = {k: v.clone() for k, v in st.items()}
    maps = []
    for b in batches[:steps]:
        x = (b["images"].to(torch.float32) / 255.0)[..., None].expand(-1, -1, -1, 3)
        maps.append(encoder_maps(w, s, x, q[0]))

    def loss_of(t, params):
        logits = decoder({**w, **params}, st, maps[t], s, True, q[1])
        return dice_ce(logits, batches[t]["masks"])

    losses, first, delta = adamw_steps(loss_of, theta, s["optimizer"], steps, start)
    delta.update({f"bn.{k}": st[k] - st0[k] for k in st})
    return losses, first, delta


@torch.no_grad()
def predict_logits(weights, s, images_u8, q=exact, chunk: int = 8):
    """uint8 images [B, S, S] -> eval-mode logits [B, classes, S, S]."""
    w, st = _split(prepare(weights))
    out = []
    for imgs in images_u8.split(chunk):
        x = (imgs.to(torch.float32) / 255.0)[..., None].expand(-1, -1, -1, 3)
        out.append(decoder(w, st, encoder_maps(w, s, x, q[0]), s, False, q[1]))
    return torch.cat(out)
