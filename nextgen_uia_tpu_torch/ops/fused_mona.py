"""The whole MONA adapter as one op, forward and full-gradient backward
(counterpart of nextgen_uia_tpu/ops/fused_mona.py::mona_block_fused):

    z1  = LN(x) * gamma + x * gammax          (LN eps 1e-5)
    zd  = z1 @ W_down + b_down                (D -> c = 64)
    s   = spatial rows of zd; f = s * freq
    wts = softmax(MLP(GAP(f))) (noise-aware variants) or 1/3 each
    y   = dwconv7[sum_t wts_t K_t](f) + sum_t wts_t b_t + s
    o   = y + pw(y)
    out = x + (gelu([cls | o | tail]) * mask) @ W_up + b_up

The rounding points are the JAX kernel's: the wide [rows, D] chain (z0 =
LN(x) * scale + bias, z1) in the compute dtype (x's), zd, the stencil, pw
and the GELU in float32 (pw's and the projections' operands rounded to the
compute dtype first), the up projection's bias-add and the residual in the
compute dtype. GELU is the exact erf form. The backward returns dx and a
gradient for every MONA parameter.

``mona_block_fused`` is differentiable in x and every parameter: on a CUDA
tensor its forward and backward launch the hand-written kernels of
csrc/fused_mona.cu (counted in ``mona_block_fused.launches`` and
``mona_block_fused_backward.launches``); on a CPU tensor they run
``mona_block_fused_plain``'s arithmetic and
``mona_block_fused_backward_plain``. The backward kernel reuses the narrow
tensors the forward kernel saved (zd, the pre-GELU rows, the spatial
output, the per-image mixing weights) and recomputes the wide chain from x.
It returns None where the JAX function declines for a reason of the model
(no CLS row, or parameters that do not match the variant); the caller then
takes the composed route.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-5
C_KERNEL, C4_KERNEL = 64, 16          # the bottleneck the CUDA kernels take
IMG_LEN = 4 + C_KERNEL + C4_KERNEL    # per-image saved state: wts | pooled | fc1 pre-act
P2_LEN = (C_KERNEL * C_KERNEL + C_KERNEL + 3 * 49 * C_KERNEL + 3 * C_KERNEL + C_KERNEL
          + C_KERNEL * C4_KERNEL + C4_KERNEL + C4_KERNEL * 3 + 3)
SPLITS = 32                           # row splits of the two deep weight products

BASE = ("norm.scale", "norm.bias", "gamma", "gammax", "down.w", "down.b", "up.w", "up.b",
        "conv3.w", "conv3.b", "conv5.w", "conv5.b", "conv7.w", "conv7.b", "pw.w", "pw.b")
FREQ = ("freq_filter",)
NOISE = ("noise_est.fc1.w", "noise_est.fc1.b", "noise_est.fc2.w", "noise_est.fc2.b")


def _static(p, x, hw, variant):
    """(h, w, has_freq, has_noise), or None where the JAX function declines:
    no CLS row, or parameters that do not match the variant."""
    h, w = hw
    if x.shape[1] < h * w + 1:
        return None
    has_freq = variant in ("freq_enhanced", "hybrid")
    has_noise = variant in ("noise_aware", "hybrid")
    if hasattr(p, "freq_filter") != has_freq or hasattr(p, "noise_est") != has_noise:
        return None
    return h, w, has_freq, has_noise


def _names(has_freq, has_noise):
    return BASE + (FREQ if has_freq else ()) + (NOISE if has_noise else ())


def _params(p, names):
    named = dict(p.named_parameters())
    return [named[k] for k in names]


def _embed(w):
    """[k, k, 1, c] depthwise kernel zero-embedded into [7, 7, c]."""
    pad = (7 - w.shape[0]) // 2
    return F.pad(w[:, :, 0, :], (0, 0, pad, pad, pad, pad))


def _taps(q):
    taps = torch.stack([_embed(q["conv3.w"]), _embed(q["conv5.w"]), q["conv7.w"][:, :, 0, :]])
    tapb = torch.stack([q["conv3.b"], q["conv5.b"], q["conv7.b"]])
    return taps.to(torch.float32), tapb.to(torch.float32)


def _set_tap_grads(grads, dtaps, dtapb):
    """The conv3/5/7 weight and bias gradients from those of the
    zero-embedded taps [3, 7, 7, c] and their biases [3, c]."""
    for t, (name, lo, hi) in enumerate((("conv3", 2, 5), ("conv5", 1, 6), ("conv7", 0, 7))):
        grads[f"{name}.w"] = dtaps[t, lo:hi, lo:hi, None, :]
        grads[f"{name}.b"] = dtapb[t]


def _grouped(t):
    """[B, h, w, c] -> [1, c*B, h, w]: one conv group per (channel, sample)."""
    b, h, w, c = t.shape
    return t.permute(3, 0, 1, 2).reshape(1, c * b, h, w)


def _per_sample_conv(t, kern, flip=False):
    """'SAME' 7x7 cross-correlation of t [B, h, w, c] with per-sample
    depthwise kernels [B, 7, 7, c] (flipped: the correlation's transpose)."""
    b, h, w, c = t.shape
    k = kern.permute(3, 0, 1, 2).reshape(c * b, 1, 7, 7)
    y = F.conv2d(_grouped(t), k.flip(-1, -2) if flip else k, padding=3, groups=c * b)
    return y.reshape(c, b, h, w).permute(1, 2, 3, 0)


def _gelu_grad(a):
    cdf = 0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))
    return cdf + a * torch.exp(-0.5 * a * a) * (1.0 / math.sqrt(2.0 * math.pi))


def _forward_core(x, mask, q, static):
    """The forward in the JAX kernel's arithmetic; returns (out, the
    intermediates its backward reads). Differentiable by autograd."""
    h, w, has_freq, has_noise = static
    b, n, d = x.shape
    cdt, f32 = x.dtype, torch.float32
    c, hw = q["down.w"].shape[1], h * w

    def r(t):  # an operand rounded to the compute dtype, as float32
        return t.to(cdt).to(f32)

    xf = x.reshape(b * n, d).to(f32)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + EPS)
    xhat = (xf - mean) * rstd
    z0 = (xhat * q["norm.scale"] + q["norm.bias"]).to(cdt)
    z1 = z0 * q["gamma"].to(cdt) + x.reshape(b * n, d) * q["gammax"].to(cdt)
    zd = (z1.to(f32) @ r(q["down.w"]) + q["down.b"]).reshape(b, n, c)

    s = zd[:, 1:1 + hw].reshape(b, h, w, c)
    f = s * q["freq_filter"] if has_freq else s
    taps, tapb = _taps(q)
    if has_noise:
        ne = ("noise_est.fc1.w", "noise_est.fc1.b", "noise_est.fc2.w", "noise_est.fc2.b")
        f1w, f1b, f2w, f2b = (q[k] for k in ne)
        pooled = f.mean((1, 2))
        a1_pre = pooled @ f1w + f1b
        a1 = torch.relu(a1_pre)
        wts = torch.softmax(a1 @ f2w + f2b, dim=-1)
    else:
        pooled = a1_pre = a1 = None
        wts = torch.full((b, 3), 1.0 / 3.0, dtype=f32, device=x.device)
    kern = (wts[:, 0, None, None, None] * taps[0] + wts[:, 1, None, None, None] * taps[1]
            + wts[:, 2, None, None, None] * taps[2])                         # [B, 7, 7, c]
    biasw = wts[:, 0:1] * tapb[0] + wts[:, 1:2] * tapb[1] + wts[:, 2:3] * tapb[2]
    y2 = (s + biasw[:, None, None, :] + _per_sample_conv(f, kern)).reshape(b, hw, c)
    pwm = q["pw.w"][0, 0]
    out_sp = y2 + r(y2) @ r(pwm) + q["pw.b"]
    zcat = torch.cat([zd[:, :1], out_sp, zd[:, 1 + hw:]], dim=1)
    gd = F.gelu(zcat) * mask
    u = (r(gd) @ r(q["up.w"]) + q["up.b"]).to(cdt)
    out = x + u
    iv = dict(xhat=xhat, rstd=rstd, z0=z0, z1=z1, zd=zd, s=s, f=f, pooled=pooled,
              a1_pre=a1_pre, a1=a1, wts=wts, taps=taps, tapb=tapb, kern=kern, y2=y2,
              zcat=zcat)
    return out, iv


def _ones_mask(x, c):
    return torch.ones(x.shape[0], x.shape[1], c, dtype=torch.float32, device=x.device)


def _prepare(p, x, hw, variant, mask):
    """(static, {name: parameter}, mask; ones for None) of inputs the JAX
    function takes; raises where it declines."""
    static = _static(p, x, hw, variant)
    if static is None:
        raise ValueError("mona_block_fused: the JAX function declines these inputs")
    q = dict(p.named_parameters())
    return static, q, _ones_mask(x, q["down.w"].shape[1]) if mask is None else mask


def mona_block_fused_plain(p, x, hw, *, variant: str, mask=None):
    """Plain PyTorch version, differentiable by autograd: the JAX kernel's
    forward arithmetic and rounding points on any device. Returns None where
    the JAX function declines."""
    if _static(p, x, hw, variant) is None:
        return None
    static, q, mask = _prepare(p, x, hw, variant, mask)
    return _forward_core(x, mask, q, static)[0]


def _backward_plain(x, mask, q, static, g):
    """(dx, {name: gradient}) by the formulas of the JAX ``_bwd_kernel``."""
    h, w, has_freq, has_noise = static
    b, n, d = x.shape
    cdt, f32 = x.dtype, torch.float32
    c, hw = q["down.w"].shape[1], h * w
    q = {k: v.detach() for k, v in q.items()}
    with torch.no_grad():
        _, iv = _forward_core(x, mask, q, static)

        def r(t):
            return t.to(cdt).to(f32)

        gf = g.reshape(b * n, d).to(f32)
        maskf = mask.reshape(b * n, c).to(f32)
        zc = iv["zcat"].reshape(b * n, c)
        grads = {"up.w": r(F.gelu(zc) * maskf).T @ r(gf), "up.b": gf.sum(0)}
        dgd = r(gf) @ r(q["up.w"]).T
        dzcat = (dgd * maskf * _gelu_grad(zc)).reshape(b, n, c)

        dos = dzcat[:, 1:1 + hw].reshape(b * hw, c)
        pwm = q["pw.w"][0, 0]
        grads["pw.w"] = (r(iv["y2"].reshape(b * hw, c)).T @ r(dos))[None, None]
        grads["pw.b"] = dos.sum(0)
        dy = (dos + r(dos) @ r(pwm).T).reshape(b, h, w, c)

        wts, taps, tapb = iv["wts"], iv["taps"], iv["tapb"]
        df = _per_sample_conv(dy, iv["kern"], flip=True)
        fp = F.pad(iv["f"], (0, 0, 3, 3, 3, 3))
        dk = torch.stack([torch.stack([(dy * fp[:, di:di + h, dj:dj + w]).sum((1, 2))
                                       for dj in range(7)], 1) for di in range(7)], 1)
        dbiasw = dy.sum((1, 2))
        _set_tap_grads(grads, torch.einsum("bt,bijc->tijc", wts, dk),
                       torch.einsum("bt,bc->tc", wts, dbiasw))
        if has_noise:
            dwts = (torch.einsum("bijc,tijc->btc", dk, taps)
                    + dbiasw[:, None, :] * tapb[None]).sum(-1)
            dlogits = wts * (dwts - (dwts * wts).sum(-1, keepdim=True))
            grads["noise_est.fc2.w"] = iv["a1"].T @ dlogits
            grads["noise_est.fc2.b"] = dlogits.sum(0)
            da1 = (dlogits @ q["noise_est.fc2.w"].T) * (iv["a1_pre"] > 0)
            grads["noise_est.fc1.w"] = iv["pooled"].T @ da1
            grads["noise_est.fc1.b"] = da1.sum(0)
            df = df + (da1 @ q["noise_est.fc1.w"].T)[:, None, None, :] / hw
        if has_freq:
            ds = dy + df * q["freq_filter"]
            grads["freq_filter"] = (iv["s"] * df).sum((0, 1, 2))
        else:
            ds = dy + df

        dzd = torch.cat([dzcat[:, :1], ds.reshape(b, hw, c), dzcat[:, 1 + hw:]],
                        dim=1).reshape(b * n, c)
        grads["down.w"] = r(iv["z1"]).T @ r(dzd)
        grads["down.b"] = dzd.sum(0)
        dz1 = r(dzd) @ r(q["down.w"]).T
        xf, xhat = x.reshape(b * n, d).to(f32), iv["xhat"]
        grads["gamma"] = (dz1 * iv["z0"].to(f32)).sum(0)
        grads["gammax"] = (dz1 * xf).sum(0)
        dz0 = dz1 * q["gamma"]
        grads["norm.scale"] = (dz0 * xhat).sum(0)
        grads["norm.bias"] = dz0.sum(0)
        dxhat = dz0 * q["norm.scale"]
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (gf + (dxhat - m1 - xhat * m2) * iv["rstd"] + dz1 * q["gammax"]).to(cdt)
    return dx.reshape(b, n, d), grads


def mona_block_fused_backward_plain(p, x, hw, g, *, variant: str, mask=None):
    """Plain (dx, {parameter name: gradient}) for the output gradient g, by
    the formulas of the JAX kernel's ``_bwd_kernel`` in float32 (operands of
    the products rounded to the compute dtype where it rounds them).
    Gradients are float32; dx has x's dtype."""
    static, q, mask = _prepare(p, x, hw, variant, mask)
    return _backward_plain(x, mask, q, static, g)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _pack(q, static, dt):
    """The float32 parameter buffer the kernels read, in csrc/fused_mona.cu's
    order (``Off``): LN scale, LN bias, gamma, gammax, b_up, W_down rounded
    to dt, b_down, freq, the zero-embedded taps [3, 49, c], their biases,
    pw rounded to dt, pw's bias, the noise MLP (zeros without one)."""
    _, _, has_freq, has_noise = static
    f32 = torch.float32
    c, dev = q["down.w"].shape[1], q["down.w"].device
    taps, tapb = _taps(q)
    ones, zeros = torch.ones(c, device=dev), torch.zeros
    noise = ([q[k] for k in NOISE] if has_noise else
             [zeros(c, c // 4, device=dev), zeros(c // 4, device=dev),
              zeros(c // 4, 3, device=dev), zeros(3, device=dev)])
    parts = [q["norm.scale"], q["norm.bias"], q["gamma"], q["gammax"], q["up.b"],
             q["down.w"].to(dt), q["down.b"], q["freq_filter"] if has_freq else ones, taps,
             tapb, q["pw.w"][0, 0].to(dt), q["pw.b"], *noise]
    return torch.cat([t.detach().to(f32).reshape(-1) for t in parts])


def _check_cuda(x, mask, q, static):
    h, w, _, _ = static
    b, n, d = x.shape
    problems = []
    if x.dtype not in build.DTYPE_CODES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if q["down.w"].shape[1] != C_KERNEL:
        problems.append(f"bottleneck {q['down.w'].shape[1]} (the kernels take {C_KERNEL})")
    if d % 64:
        problems.append(f"width {d} (a multiple of 64)")
    if (h + 6) * (w + 6) > 400:
        problems.append(f"grid {h}x{w} (the spatial kernels hold (h+6)(w+6) <= 400 pixels)")
    if tuple(mask.shape) != (b, n, C_KERNEL) or mask.device != x.device:
        problems.append(f"mask {tuple(mask.shape)} on {mask.device}")
    if problems:
        raise ValueError("mona_block_fused CUDA kernel does not take: " + "; ".join(problems))


def _forward_cuda(x, mask, q, static):
    """(out, the saved state the backward kernel reads) from the forward kernel."""
    h, w, _, has_noise = static
    _check_cuda(x, mask, q, static)
    b, n, d = x.shape
    dt, f32, dev, c, m = x.dtype, torch.float32, x.device, C_KERNEL, b * n
    x = x.contiguous()
    mask = mask.to(f32).contiguous()
    prm = _pack(q, static, dt)
    uw = q["up.w"].detach().to(dt).contiguous()
    out = torch.empty_like(x)
    stats = torch.empty(m, 2, device=dev, dtype=f32)
    zd, zcat = (torch.empty(m, c, device=dev, dtype=f32) for _ in range(2))
    gd = torch.empty(m, c, device=dev, dtype=dt)
    y2 = torch.empty(b * h * w, c, device=dev, dtype=f32)
    img = torch.empty(b, IMG_LEN, device=dev, dtype=f32)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_mona_fused_fwd(
            build.ptr(x, "x"), build.ptr(mask, "mask"), build.ptr(prm), build.ptr(uw),
            build.ptr(out), build.ptr(stats), build.ptr(zd), build.ptr(zcat), build.ptr(gd),
            build.ptr(y2), build.ptr(img), build.DTYPE_CODES[dt], b, n, d, h, w,
            int(has_noise), build.stream(dev)), "mona_block_fused")
    mona_block_fused.launches += 1
    return out, (prm, uw, stats, zd, zcat, gd, y2, img)


def _backward_cuda(x, mask, q, static, g, saved, need_dx):
    h, w, has_freq, has_noise = static
    b, n, d = x.shape
    dt, f32, dev, c, m = x.dtype, torch.float32, x.device, C_KERNEL, b * n
    prm, uw, stats, zd, zcat, gd, y2, img = saved
    x, mask = x.contiguous(), mask.to(f32).contiguous()
    g = g.to(dt).contiguous()
    tiles = -(-m // 32)
    dx = torch.empty_like(x) if need_dx else None
    dgd, dzd = (torch.empty(m, c, device=dev, dtype=f32) for _ in range(2))
    part_img = torch.empty(b, P2_LEN, device=dev, dtype=f32)
    part_row = torch.empty(tiles, 5 * d + c, device=dev, dtype=f32)
    part_up, part_down = (torch.empty(SPLITS, c * d, device=dev, dtype=f32) for _ in range(2))
    flat = torch.empty(2 * c * d + 5 * d + c + P2_LEN, device=dev, dtype=f32)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.nx_mona_fused_bwd(
            build.ptr(x, "x"), build.ptr(mask, "mask"), build.ptr(prm), build.ptr(uw),
            build.ptr(g, "g"), build.ptr(stats), build.ptr(zd), build.ptr(zcat), build.ptr(gd),
            build.ptr(y2), build.ptr(img), build.ptr(dx), build.ptr(dgd), build.ptr(dzd),
            build.ptr(part_img), build.ptr(part_row), build.ptr(part_up), build.ptr(part_down),
            build.ptr(flat), build.DTYPE_CODES[dt], b, n, d, h, w, int(has_freq),
            int(has_noise), SPLITS, build.stream(dev)), "mona_block_fused backward")
    mona_block_fused_backward.launches += 1
    return dx, _unpack(flat, d, static)


def _unpack(flat, d, static):
    """The backward kernel's flat float32 gradients -> {parameter name: gradient}."""
    _, _, has_freq, has_noise = static
    c, c4 = C_KERNEL, C4_KERNEL
    sizes = [("up.w", (c, d)), ("down.w", (d, c)), ("norm.scale", (d,)), ("norm.bias", (d,)),
             ("gamma", (d,)), ("gammax", (d,)), ("up.b", (d,)), ("down.b", (c,)),
             ("pw", (c, c)), ("pw.b", (c,)), ("taps", (3, 7, 7, c)), ("tapb", (3, c)),
             ("freq_filter", (c,)), ("noise_est.fc1.w", (c, c4)), ("noise_est.fc1.b", (c4,)),
             ("noise_est.fc2.w", (c4, 3)), ("noise_est.fc2.b", (3,))]
    out, at = {}, 0
    for name, shape in sizes:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape)
        at += k
    out["pw.w"] = out.pop("pw")[None, None]
    _set_tap_grads(out, out.pop("taps"), out.pop("tapb"))
    if not has_freq:
        del out["freq_filter"]
    if not has_noise:
        for k in NOISE:
            del out[k]
    return out


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mona_block_fused: unsupported device {x.device}")


def mona_block_fused_forward(p, x, hw, *, variant: str, mask=None):
    """(out, saved): the forward kernel's output and the state
    ``mona_block_fused_backward`` takes. CUDA tensors only; the inputs must
    be ones the JAX function takes."""
    if x.device.type != "cuda":
        raise ValueError(f"mona_block_fused_forward: CUDA tensors only, got {x.device}")
    static, q, mask = _prepare(p, x, hw, variant, mask)
    return _forward_cuda(x, mask, q, static)


def mona_block_fused_backward(p, x, hw, g, saved=None, *, variant: str, mask=None,
                              need_dx: bool = True):
    """(dx, {parameter name: float32 gradient}) for the output gradient g: on
    a CUDA tensor the backward kernel of csrc/fused_mona.cu (``saved`` from
    ``mona_block_fused_forward``; counted in
    ``mona_block_fused_backward.launches``; dx None unless ``need_dx``), on a
    CPU tensor ``mona_block_fused_backward_plain``."""
    _check_device(x)
    static, q, mask = _prepare(p, x, hw, variant, mask)
    if x.device.type == "cpu":
        return _backward_plain(x, mask, q, static, g)
    return _backward_cuda(x, mask, q, static, g, saved, need_dx)


class _MonaBlockFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, static, names, *params):
        q = dict(zip(names, params))
        if x.device.type == "cpu":
            out, saved = _forward_core(x, mask, q, static)[0], ()
        else:
            out, saved = _forward_cuda(x, mask, q, static)
        ctx.static, ctx.names = static, names
        ctx.save_for_backward(x, mask, *params, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, *rest = ctx.saved_tensors
        k = len(ctx.names)
        q, saved = dict(zip(ctx.names, rest[:k])), rest[k:]
        if x.device.type == "cpu":
            dx, grads = _backward_plain(x, mask, q, ctx.static, g)
        else:
            dx, grads = _backward_cuda(x, mask, q, ctx.static, g, saved,
                                       ctx.needs_input_grad[0])
        pgrads = [grads[name].to(q[name].dtype) if ctx.needs_input_grad[4 + i] else None
                  for i, name in enumerate(ctx.names)]
        return (dx if ctx.needs_input_grad[0] else None, None, None, None, *pgrads)


def mona_block_fused(p, x, hw, *, variant: str, mask=None):
    """Fused MONA adapter: x [B, N, D] -> x + adapter(x), differentiable in x
    and every parameter of ``p`` (a ``Mona``).

    mask: the pre-scaled float32 dropout mask [B, N, c] (0 or 1/keep); None
    (eval) substitutes ones. N >= h*w + 1: the first row is CLS, rows past
    h*w + 1 take the CLS path. Returns None where the JAX function declines
    (no CLS row, or parameters that do not match ``variant``).
    """
    _check_device(x)
    static = _static(p, x, hw, variant)
    if static is None:
        return None
    names = _names(static[2], static[3])
    params = _params(p, names)
    mask = _ones_mask(x, params[4].shape[1]) if mask is None else mask
    return _MonaBlockFused.apply(x, mask, static, names, *params)


mona_block_fused.launches = 0
mona_block_fused_backward.launches = 0
