"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a): a CUDA kernel has no CPU mode,
so here they skip. Run them there with
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest``.
Tolerances: float32 inputs, block max|d| <= 1e-4 * max|ref| and spatial op
<= 1e-5 (the same float32 math summed in another order); bfloat16 inputs
against the float32 plain version, block max|d| <= 3e-2 at unit scale and
spatial op <= one bf16 ulp at the output's scale; K7's float32 kernels
also at the CLIPSeg decoder's [32, 197, 4, 16] (packed, with and without a
bias), head dims 13, 24, 32 and 64, N = 1, 5, 20 and the chunk edges, their
lse within 1e-4 * max|ref|, their backward bitwise equal over two calls and
finite beside a wholly padded sequence; the spatial op (K2) and
its backward (K3) also at the bench step's [64, 14, 14, 64] and a bf16
width of 12 (8-byte copies) and 70 rows (strips of rows a sample), K3
bitwise equal over two calls, and one
kernel on the card per K2, K3 or autograd backward call (profiler). The
train path's kernels
(forward and backward), the flash-attention (K7, forward and backward) and
fused-MLP (K10) forwards, K1 and K6 with the causal mask: float32 max|d| <= 1e-4 *
max|ref|, bfloat16 <= 3e-2 * max(1, max|ref|), for every output; K7's
bfloat16 output (~0.04 for unit-variance inputs) and gradients <= 3e-2 *
max|ref|, also at the wgmma kernels' tile edges (N = 1, 63, 64, 65, 127,
128, 129) and at [16, 256, 12, 64] with a bias, its lse within 1e-3 of the
plain log-sum-exp, its bf16 backward bitwise equal over two calls, and bf16
input TMA cannot read (head dim not 64, unaligned base or stride) refused. The lookup and histogram kernels (K13) and an
augmentation plan through them: equal to their plain versions. BERT's
post-norm kernels (K5 raw-x, K6 post-LN, K9, K1 post-norm) with a
key-padding bias that leaves one row wholly padded: float32 1e-4 *
max|ref|, bfloat16 3e-2 * max(1, max|ref|); ``bert_apply`` by the chain
and by the whole-layer route against its plain path, and autograd reaching
K1 post-norm on the card raises. K10's and K5 raw-x's backward kernels and
K4 (forward, dx, dk) against their plain versions, float32 1e-4 * max|ref|,
bfloat16 3e-2 * max(1, max|ref|); K5 raw-x (on the Hopper GEMM core in
bf16) also at a token count its M tile does not divide and below one tile,
its backward bitwise equal over two calls, and bf16 with a head dim not a
multiple of 64 refused; the BERT tower with LoRA in one of two
layers, float32, every LoRA and bias gradient against the plain path. The whole MONA adapter (K12),
forward and backward, against its plain versions on the same inputs:
output and dx 1e-4 * max|ref| (float32) or 3e-2 * max|ref| (bfloat16), each
parameter gradient within 1e-4 * the largest max|ref| and 3e-2 * its own
(float32) or 3e-2 * the largest (bfloat16), two backward calls bitwise
equal; the attention block (K11) forward and dx backward and the hybrid
forward, 1e-4 / 3e-2 * max|ref|, also where the flat GEMM tiles cross
sequences and the last one is ragged, and its bf16 backward bitwise equal
over two calls; on the card neither route reaches a plain version. K6 and
K8 (on K7 and the Hopper GEMM core in bf16) also at the bench step's [64,
197, 768], their bf16 backwards bitwise equal over two calls, a bf16 K6
with head dim 32 refused, and no bf16 K6 or K8 call reaching a WMMA GEMM
or a SIMT attention kernel (profiler kernel names). K1 (on K7 and the
Hopper GEMM core in bf16) also at the serving shape [32, 197, 768], a bf16
K1 with head dim 32 refused, and no bf16 K1 (pre-norm, causal, post-norm)
or K6 post-LN call reaching a WMMA GEMM or a SIMT attention kernel. K9 and
K10 (forward and backward, on the Hopper GEMM core in bf16): K10's forward
also at DINOv2's [24 * 1370, 768], [16 * 256, 768] and an odd [1001, 768],
its bf16 backward bitwise equal over two calls, and no bf16 K9 or K10 call
reaching a WMMA GEMM. K5 pre-norm (on the Hopper GEMM core in bf16) at
[64, 197, 768], [32, 197, 768] and ragged token counts, its bf16 backward
bitwise equal over two calls and a bf16 head dim of 32 refused; K12 in
bf16 (its products on wgmma) at [64, 197, 768], [32, 197, 768] and row
counts no tile divides, its backward bitwise equal over two calls, a bf16
width above 1536 refused; no bf16 K5 or K12 call reaching a WMMA GEMM,
colgemm_kernel or mona_down_kernel.
"""

import pytest
import torch

from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import dwconv
from nextgen_uia_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block(device, width, heads):
    gen = torch.Generator().manual_seed(width + heads)
    blk = Block(gen, ViTConfig(width=width, heads=heads))
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2):
            ln.scale.add_(0.1 * torch.randn(width, generator=gen))
            ln.bias.add_(0.1 * torch.randn(width, generator=gen))
    return blk.to(device)


@pytest.mark.parametrize("b,n,width,heads,act", [
    (2, 17, 128, 2, "gelu"), (3, 197, 128, 4, "quick_gelu"), (2, 256, 768, 12, "gelu"),
    (32, 197, 768, 12, "gelu")])
def test_fused_block_kernel_matches_plain(cuda, b, n, width, heads, act):
    """float32 at every shape; bf16 where the head dim is 64 (K7's wgmma
    kernels), refused with a ValueError naming it elsewhere."""
    blk = _block(cuda, width, heads)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(b, n, width, generator=gen).to(cuda)
    with torch.no_grad():
        ref = fb.fused_block_infer_plain(x, blk, heads=heads, act=act)
        before = fb.fused_block_infer.launches
        got = fb.fused_block_infer(x, blk, heads=heads, act=act)
        torch.cuda.synchronize()
        assert fb.fused_block_infer.launches == before + 1
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()

        xb = x.to(torch.bfloat16)
        if width // heads != 64:
            with pytest.raises(ValueError, match=f"head dim {width // heads}"):
                fb.fused_block_infer(xb, blk, heads=heads, act=act)
            assert fb.fused_block_infer.launches == before + 1
            return
        ref_b = fb.fused_block_infer_plain(xb.float(), blk, heads=heads, act=act)
        got_b = fb.fused_block_infer(xb, blk, heads=heads, act=act)
        assert got_b.dtype == torch.bfloat16
        assert (got_b.float() - ref_b).abs().max() <= 3e-2


@pytest.mark.parametrize("b,n", [(4, 577), (2, 1370)])
def test_fused_block_kernel_above_256_tokens(cuda, b, n):
    """K1 (ViT-B, 12 heads of 64) and K6 post-LN at ViT-B/16's 384 px and
    DINOv2's 518 px token counts, which K7 takes: float32 within 1e-4 *
    max|ref|, bf16 within 3e-2 * max(1, max|ref|) of the plain versions."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o

    blk = _block(cuda, 768, 12)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(b, n, 768, generator=gen).to(cuda)
    q, k, v = (torch.randn(b, 12, n, 64, generator=gen).to(cuda) for _ in range(3))
    with torch.no_grad():
        for dt, lim in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            xd = x.to(dt)
            got = fb.fused_block_infer(xd, blk, heads=12, eps=1e-6)
            ref = fb.fused_block_infer_plain(xd.float(), blk, heads=12, eps=1e-6)
            scale = ref.abs().max().item()
            assert (got.float() - ref).abs().max().item() <= lim * max(
                scale, 1.0 if dt == torch.bfloat16 else 0.0), dt
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            got = fused_attn_o.fused_attn_o_residual(qd, kd, vd, xd, blk.attn.o, heads=12,
                                                     post_ln=blk.ln2)
            ref = fused_attn_o.fused_attn_o_residual_plain(
                qd.float(), kd.float(), vd.float(), xd.float(), blk.attn.o, heads=12,
                post_ln=blk.ln2)
            assert (got.float() - ref).abs().max().item() <= lim * max(
                ref.abs().max().item(), 1.0 if dt == torch.bfloat16 else 0.0), dt


def test_fused_block_key_bias_and_n_real(cuda):
    blk = _block(cuda, 128, 2)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 40, 128, generator=gen).to(cuda)
    bias = torch.randn(2, 40, generator=gen).to(cuda)
    with torch.no_grad():
        ref = fb.fused_block_infer_plain(x, blk, heads=2, key_bias=bias, n_real=33)
        got = fb.fused_block_infer(x, blk, heads=2, key_bias=bias, n_real=33)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_fused_block_rejects_shapes_it_does_not_take(cuda):
    with torch.no_grad():
        with pytest.raises(ValueError, match="head dim"):
            fb.fused_block_infer(torch.zeros(1, 5, 96, device=cuda), _block(cuda, 96, 4),
                                 heads=4)
        with pytest.raises(ValueError, match="n_real 0"):
            fb.fused_block_infer(torch.zeros(1, 300, 128, device=cuda), _block(cuda, 128, 2),
                                 heads=2, n_real=0)
        with pytest.raises(ValueError, match=r"x \(1, 5, 128\).*head dim 32"):
            fb.fused_block_infer(torch.zeros(1, 5, 128, device=cuda, dtype=torch.bfloat16),
                                 _block(cuda, 128, 4), heads=4)


@pytest.mark.parametrize("shape", [(32, 14, 14, 64), (64, 14, 14, 64), (2, 9, 11, 32),
                                   (2, 9, 11, 12), (1, 3, 5, 8), (2, 70, 5, 16)])
def test_mona_spatial_kernel_matches_plain(cuda, shape):
    b, _, _, c = shape
    gen = torch.Generator().manual_seed(sum(shape))
    s = torch.randn(shape, generator=gen).to(cuda)
    freq = (1 + 0.3 * torch.randn(c, generator=gen)).to(cuda)
    kernels = (0.2 * torch.randn(b, 7, 7, c, generator=gen)).to(cuda)
    bias = torch.randn(b, c, generator=gen).to(cuda)
    ref = dwconv.mona_spatial_plain(s, freq, kernels, bias)
    before = dwconv.mona_spatial.launches
    got = dwconv.mona_spatial(s, freq, kernels, bias)
    torch.cuda.synchronize()
    assert dwconv.mona_spatial.launches == before + 1
    assert (got - ref).abs().max() <= 1e-5

    args_b = [t.to(torch.bfloat16) for t in (s, freq, kernels, bias)]
    ref_b = dwconv.mona_spatial_plain(*[t.float() for t in args_b])
    got_b = dwconv.mona_spatial(*args_b)
    ulp = 2.0 ** (torch.floor(torch.log2(ref_b.abs().max())) - 7)
    assert (got_b.float() - ref_b).abs().max() <= ulp


def _check(kern, plain, args, args_plain=None, scaled=False, zero_floor=False):
    """Every output of kern(*args) against plain(*args_plain): float32
    max|d| <= 1e-4 max|ref|, bfloat16 <= 3e-2 max(1, max|ref|), or with
    ``scaled`` 3e-2 max|ref|. With ``zero_floor`` an output whose exact
    value is zero (max|ref| = 0) takes the largest max|ref| of the call."""
    got, ref = kern(*args), plain(*(args_plain or args))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    top = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        scale = r.abs().max().item() or (top if zero_floor else 0.0)
        if g.dtype != torch.bfloat16:
            bound = 1e-4 * scale
        else:
            bound = 3e-2 * (scale if scaled else max(1.0, scale))
        err = (g.float() - r.float()).abs().max().item()
        assert err <= bound, f"max|d| {err:.3e} > {bound:.3e} (max|ref| {scale:.3e})"


@pytest.mark.parametrize("b,n,width,heads,act", [
    (2, 17, 128, 2, "gelu"), (3, 50, 128, 2, "quick_gelu"), (2, 197, 768, 12, "gelu"),
    (64, 197, 768, 12, "gelu")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_path_kernels_match_plain(cuda, b, n, width, heads, act, dtype):
    """K5, K6 and K8 forward and backward, and K3, against their plain
    versions; bfloat16 inputs against the float32 plain version on the
    bf16-rounded inputs. [64, 197, 768] is the bench step's shape."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_ln_mlp, fused_ln_qkv

    blk = _block(cuda, width, heads)
    gen = torch.Generator().manual_seed(n + width)
    dh = width // heads

    def rnd(*shape):
        t = torch.randn(*shape, generator=gen).to(cuda)
        return t.to(dtype).float() if dtype == torch.bfloat16 else t

    def low(ts):
        return [t.to(dtype) for t in ts]

    x, g = rnd(b, n, width), rnd(b, n, width)
    q, k, v = (rnd(b, heads, n, dh) for _ in range(3))
    with torch.no_grad():
        before = (fused_ln_qkv.fused_ln_qkv.launches, fused_ln_qkv.fused_ln_qkv_backward.launches)
        _check(lambda t: fused_ln_qkv.fused_ln_qkv(t, blk.ln1, blk.attn, heads=heads),
               lambda t: fused_ln_qkv.fused_ln_qkv_plain(t, blk.ln1, blk.attn, heads=heads),
               low([x]), [x])
        gamma, _, w_qkv, _ = fused_ln_qkv._weights(blk.ln1, blk.attn, torch.float32)
        w_qkv = w_qkv.to(dtype).float()
        _check(lambda *t: fused_ln_qkv.fused_ln_qkv_backward(t[0], gamma, w_qkv, *t[1:]),
               lambda *t: fused_ln_qkv.fused_ln_qkv_backward_plain(t[0], gamma, w_qkv, *t[1:]),
               low([x, q, k, v]), [x, q, k, v])
        assert (fused_ln_qkv.fused_ln_qkv.launches, fused_ln_qkv.fused_ln_qkv_backward.launches) \
            == (before[0] + 1, before[1] + 1)

        o = blk.attn.o
        _check(lambda *t: fused_attn_o.fused_attn_o_residual(*t, o, heads=heads),
               lambda *t: fused_attn_o.fused_attn_o_residual_plain(*t, o, heads=heads),
               low([q, k, v, x]), [q, k, v, x])
        wo = o.w.to(dtype).float()
        _check(lambda *t: fused_attn_o.fused_attn_o_residual_backward(*t[:3], wo, t[3]),
               lambda *t: fused_attn_o.fused_attn_o_residual_backward_plain(*t[:3], wo, t[3]),
               low([q, k, v, g]), [q, k, v, g])

        _check(lambda t: fused_ln_mlp.fused_ln_mlp_residual(t, blk.ln2, blk.mlp, act=act),
               lambda t: fused_ln_mlp.fused_ln_mlp_residual_plain(t, blk.ln2, blk.mlp, act=act),
               low([x]), [x])
        ws = list(fused_ln_mlp._weights(blk.ln2, blk.mlp, torch.float32)[:5])
        ws[2], ws[4] = ws[2].to(dtype).float(), ws[4].to(dtype).float()
        _check(lambda t, gg: fused_ln_mlp.fused_ln_mlp_residual_backward(t, *ws, gg, act=act),
               lambda t, gg: fused_ln_mlp.fused_ln_mlp_residual_backward_plain(t, *ws, gg,
                                                                               act=act),
               low([x, g]), [x, g])


@pytest.mark.parametrize("n,bias", [(1, False), (64, False), (77, False), (77, True),
                                    (129, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_causal_matches_plain(cuda, n, bias, dtype):
    """K6's causal mode (the frozen CLIP text tower's: width 512, 8 heads)
    forward and backward against its plain versions, with and without a
    key bias; the kernels launch, the mask matters. At N = 1 a row's one
    key takes all its weight, so the exact dq and dk are zero: they take
    the largest max|ref| of the call, and the mask changes nothing."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o

    b, width, heads = 4, 512, 8
    o = _block(cuda, width, heads).attn.o
    gen = torch.Generator().manual_seed(n)

    def rnd(*shape):
        t = torch.randn(*shape, generator=gen).to(cuda)
        return t.to(dtype).float() if dtype == torch.bfloat16 else t

    q, k, v = (rnd(b, heads, n, width // heads) for _ in range(3))
    x, g = rnd(b, n, width), rnd(b, n, width)
    kw = dict(causal=True, bias=rnd(b, n) if bias else None)
    wo = o.w.to(dtype).float()
    with torch.no_grad():
        before = (fused_attn_o.fused_attn_o_residual.launches,
                  fused_attn_o.fused_attn_o_residual_backward.launches)
        _check(lambda *t: fused_attn_o.fused_attn_o_residual(*t, o, heads=heads, **kw),
               lambda *t: fused_attn_o.fused_attn_o_residual_plain(*t, o, heads=heads, **kw),
               [t.to(dtype) for t in (q, k, v, x)], [q, k, v, x])
        _check(lambda *t: fused_attn_o.fused_attn_o_residual_backward(*t[:3], wo.to(dtype),
                                                                      t[3], **kw),
               lambda *t: fused_attn_o.fused_attn_o_residual_backward_plain(*t[:3], wo, t[3],
                                                                            **kw),
               [t.to(dtype) for t in (q, k, v, g)], [q, k, v, g], zero_floor=n == 1)
        assert (fused_attn_o.fused_attn_o_residual.launches,
                fused_attn_o.fused_attn_o_residual_backward.launches) == (before[0] + 1,
                                                                          before[1] + 1)
        full = fused_attn_o.fused_attn_o_residual(q, k, v, x, o, heads=heads, bias=kw["bias"])
        causal = fused_attn_o.fused_attn_o_residual(q, k, v, x, o, heads=heads, **kw)
        assert n == 1 or (full - causal).abs().max().item() > 1e-3


@pytest.mark.parametrize("shape", [(32, 14, 14, 64), (64, 14, 14, 64), (2, 9, 11, 32),
                                   (2, 9, 11, 12), (1, 3, 5, 8), (2, 70, 5, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mona_spatial_backward_kernel_matches_plain(cuda, shape, dtype):
    ins = _spatial_backward_args(cuda, shape, dtype)
    before = dwconv.mona_spatial_backward.launches
    _check(dwconv.mona_spatial_backward, dwconv.mona_spatial_backward_plain, ins,
           [t.float() for t in ins])
    assert dwconv.mona_spatial_backward.launches == before + 1


def _spatial_backward_args(device, shape, dtype):
    b, _, _, c = shape
    gen = torch.Generator().manual_seed(sum(shape))
    ins = [torch.randn(shape, generator=gen), 1 + 0.3 * torch.randn(c, generator=gen),
           0.2 * torch.randn(b, 7, 7, c, generator=gen), torch.randn(shape, generator=gen)]
    return [t.to(device).to(dtype) for t in ins]


@pytest.mark.parametrize("shape", [(64, 14, 14, 64), (32, 14, 14, 64), (3, 9, 11, 24),
                                   (2, 70, 5, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mona_spatial_backward_is_bitwise_deterministic(cuda, shape, dtype):
    """K3's cross-CTA sums (the strips of a sample where its rows span CTAs,
    as at 70 rows, then dfreq over the batch) run in a fixed order inside
    the one launch: two calls give the same bits."""
    ins = _spatial_backward_args(cuda, shape, dtype)
    first, second = (dwconv.mona_spatial_backward(*ins) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _device_kernel_count(fn):
    """The device records (kernels, copies, fills) torch.profiler sees in one
    call of fn, after a warm-up call; a window with none is profiled again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(e.count for e in events), sorted(e.key for e in events)
    pytest.fail("the profiler recorded no device activity in any window")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mona_spatial_calls_launch_one_kernel(cuda, dtype):
    """One mona_spatial call and one mona_spatial_backward call each run
    exactly one kernel on the card: no sum, cast, copy or fill beside it;
    the autograd backward neither (its bias gradient is written in bias's
    dtype by the kernel)."""
    s, freq, kernels, g = _spatial_backward_args(cuda, (32, 14, 14, 64), dtype)
    bias = g[:, 0, 0].contiguous()
    with torch.no_grad():
        assert _device_kernel_count(lambda: dwconv.mona_spatial(s, freq, kernels, bias))[0] == 1
        assert _device_kernel_count(
            lambda: dwconv.mona_spatial_backward(s, freq, kernels, g))[0] == 1
    leaves = [t.clone().requires_grad_() for t in (s, freq, kernels, bias)]
    y = dwconv.mona_spatial(*leaves)
    count, names = _device_kernel_count(
        lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
    assert count == 1, names


def test_train_path_refuses_trainable_weights_on_the_card(cuda):
    from nextgen_uia_tpu_torch.ops import fused_ln_mlp, fused_ln_qkv

    blk = _block(cuda, 128, 2)
    x = torch.randn(2, 17, 128, device=cuda)
    blk.ln1.scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="frozen"):
        fused_ln_qkv.fused_ln_qkv(x, blk.ln1, blk.attn, heads=2)
    blk.mlp.fc1.w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="frozen"):
        fused_ln_mlp.fused_ln_mlp_residual(x, blk.ln2, blk.mlp)


def _rounded(t, dtype):
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


# float32 cases of K7 beyond the bf16 ones: the CLIPSeg decoder's [32, 197,
# 4, 16] with and without a bias, head dims 32 and 24 (the --debug_tiny
# towers', run zero-filled at 32), 13 (rows not 16-byte aligned: 4-byte
# copies), N = 1, N below the forward's key split over its warps (4 groups
# of 8 keys), the float32 kernels' chunk edges (4096 / DH streamed rows: 256
# at 16, 128 at 32, 64 at 64), causal
F32_FLASH_CASES = [
    ("bnhd", 32, 4, 197, False, False, torch.float32, 16),
    ("bnhd", 32, 4, 197, True, False, torch.float32, 16),
    ("bnhd", 2, 4, 197, True, True, torch.float32, 16),
    ("bhnd", 2, 3, 77, True, True, torch.float32, 32),
    ("bnhd", 2, 4, 50, True, False, torch.float32, 24),
    ("bnhd", 2, 3, 70, True, True, torch.float32, 13),
    ("bnhd", 2, 3, 1, True, True, torch.float32, 16),
    ("bnhd", 2, 3, 5, False, False, torch.float32, 16),
    ("bnhd", 2, 3, 20, True, True, torch.float32, 16),
    ("bnhd", 2, 2, 255, True, False, torch.float32, 16),
    ("bnhd", 2, 2, 256, False, True, torch.float32, 16),
    ("bnhd", 2, 2, 257, True, True, torch.float32, 16),
    ("bnhd", 2, 2, 530, True, False, torch.float32, 16),
    ("bnhd", 2, 2, 127, True, True, torch.float32, 32),
    ("bnhd", 2, 2, 128, True, False, torch.float32, 32),
    ("bnhd", 2, 2, 129, False, True, torch.float32, 32),
    ("bnhd", 2, 2, 63, True, True, torch.float32, 64),
    ("bnhd", 2, 2, 64, False, False, torch.float32, 64),
    ("bnhd", 2, 2, 65, True, True, torch.float32, 64),
    ("bhnd", 2, 3, 200, True, False, torch.float32, 64)]


def _flash_inputs(layout, b, h, n, dh, dtype, gen, device):
    """q, k, v (rounded to dtype, kept in float32): the bnhd cases as
    strided views of one packed [B, N, 3, H, dh] projection, as mha hands
    them over, the bhnd ones as three tensors."""
    if layout == "bnhd":
        qkv = _rounded(torch.randn(b, n, 3, h, dh, generator=gen).to(device), dtype)
        return qkv.unbind(2)
    return [_rounded(torch.randn(b, h, n, dh, generator=gen).to(device), dtype)
            for _ in range(3)]


@pytest.mark.parametrize("layout,b,h,n,bias,causal,dtype,dh", [
    ("bhnd", 2, 12, 1370, False, False, torch.bfloat16, 64),
    ("bnhd", 2, 4, 300, True, False, torch.bfloat16, 64),
    ("bhnd", 2, 3, 77, True, True, torch.float32, 64),
    ("bnhd", 1, 2, 530, False, True, torch.float32, 64),
    ("bhnd", 2, 2, 130, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 12, 1370, True, True, torch.bfloat16, 64),
    # the wgmma kernels' tile edges (64-row boxes, 128-row tiles) and the
    # --tune_text_encoder shape
    ("bnhd", 2, 3, 1, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 63, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 64, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 65, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 127, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 128, True, True, torch.bfloat16, 64),
    ("bnhd", 2, 3, 129, True, True, torch.bfloat16, 64),
    ("bnhd", 16, 12, 256, True, False, torch.bfloat16, 64),
    *F32_FLASH_CASES])
def test_flash_attention_kernel_matches_plain(cuda, layout, b, h, n, bias, causal, dtype, dh):
    """K7 against its plain version (the float32 cases' lse against the
    plain log-sum-exp too, 1e-4 * max|ref|); the bnhd cases read q, k, v as
    strided views of one packed [B, N, 3, H, dh] projection, as mha does."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(n)
    q, k, v = _flash_inputs(layout, b, h, n, dh, dtype, gen, cuda)
    kb = torch.randn(b, n, generator=gen).to(cuda) if bias else None
    before = fa.flash_attention.launches
    _check(lambda *t: fa.flash_attention(*t, bias=kb, causal=causal, layout=layout),
           lambda *t: fa.flash_attention_plain(*t, bias=kb, causal=causal, layout=layout),
           [t.to(dtype) for t in (q, k, v)], [q, k, v], scaled=True)
    assert fa.flash_attention.launches == before + 1
    if dtype == torch.float32:
        _, lse = fa.flash_attention_forward(q, k, v, bias=kb, causal=causal, layout=layout)
        want = fa.flash_attention_lse_plain(q, k, bias=kb, causal=causal, layout=layout)
        assert (lse - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("m,d,hidden,act,dtype", [
    (2000, 768, 3072, "gelu", torch.bfloat16), (77, 128, 512, "quick_gelu", torch.float32),
    (77, 128, 512, "gelu", torch.bfloat16), (24 * 1370, 768, 3072, "gelu", torch.bfloat16),
    (4096, 768, 3072, "gelu", torch.bfloat16), (1001, 768, 3072, "quick_gelu", torch.bfloat16),
    (1001, 768, 3072, "gelu", torch.float32)])
def test_fused_mlp_kernel_matches_plain(cuda, m, d, hidden, act, dtype):
    """K10's forward: DINOv2's [24 * 1370, 768] (its last 128-row tile
    ragged), the BERT LoRA layers' [16 * 256, 768], an odd row count."""
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(m)
    x = _rounded(torch.randn(m, d, generator=gen).to(cuda), dtype)
    w1 = _rounded((d ** -0.5 * torch.randn(d, hidden, generator=gen)).to(cuda), dtype)
    w2 = _rounded((hidden ** -0.5 * torch.randn(hidden, d, generator=gen)).to(cuda), dtype)
    b1, b2 = torch.randn(hidden, generator=gen).to(cuda), torch.randn(d, generator=gen).to(cuda)
    before = fm.fused_mlp.launches
    _check(lambda t: fm.fused_mlp(t, w1, b1, w2, b2, act=act),
           lambda t: fm.fused_mlp_plain(t, w1, b1, w2, b2, act=act), [x.to(dtype)], [x])
    assert fm.fused_mlp.launches == before + 1


@pytest.mark.parametrize("shape", [(3, 518, 518), (3, 37, 41), (32, 224, 224)])
def test_lut_kernels_equal_plain(cuda, shape):
    from nextgen_uia_tpu_torch.data.augment import equalize_lut
    from nextgen_uia_tpu_torch.ops import lut

    gen = torch.Generator().manual_seed(sum(shape))
    img = (torch.rand(shape, generator=gen) * 1.1 - 0.05).to(cuda)
    img[0] = torch.round(img[0] * 7) / 7  # few distinct values
    hist = lut.hist256(img)
    assert torch.equal(hist, lut.hist256_plain(img))
    table = equalize_lut(hist)
    assert torch.equal(lut.lut_apply(img, table), lut.lut_apply_plain(img, table))


def test_augmentation_plan_kernel_path_equals_plain_path(cuda):
    from nextgen_uia_tpu_torch.data import augment as aug
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randint(0, 256, (16, 96, 96, 1), generator=gen, device=cuda) / 255.0)
    m = (torch.rand(16, 96, 96, 1, generator=gen, device=cuda) > 0.7).float()
    plan = aug.sample_plan(gen, 16)
    got = aug.apply_plan(plan, x, m, ops=KERNELS)
    want = aug.apply_plan(plan, x, m, ops=PLAIN)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _equalize_images(cuda, n, h, w, seed):
    """n images on the byte grid: noise, one constant image (step 0), one
    70% one dark value, in turn."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.round(torch.rand(n, h, w, generator=gen) * 255) / 255
    x[1::3] = 37 / 255
    dark = torch.rand(n, h, w, generator=gen) < 0.7
    x[2::3] = torch.where(dark[2::3], torch.full_like(x[2::3], 5 / 255), x[2::3])
    return x.to(cuda)


@pytest.mark.parametrize("n,h,w,idx", [
    (24, 518, 518, list(range(24))), (24, 518, 518, [20, 2, 11]), (3, 37, 41, [0, 1, 2]),
    (3, 301, 303, [2, 0, 1]), (32, 224, 224, list(range(0, 32, 3))), (2, 1024, 1024, [1])])
def test_equalize_kernel_equals_plain(cuda, n, h, w, idx):
    """K13's equalize (one cluster an image, in place) bitwise equal to
    ``equalize_plain`` at the chip-smoke shapes: DINOv2's [24, 518, 518]
    with every image (clusters of 8) and with 3 of them (16), the odd [3,
    37, 41] (one CTA an image) and [3, 301, 303] (slices off 16-byte
    boundaries), the trainer's [32, 224, 224], and one [1024, 1024] image
    (64K floats a CTA); the images left out untouched; two calls bitwise
    equal; a device index list as a host one; one launch a call."""
    from nextgen_uia_tpu_torch.ops import lut

    x = _equalize_images(cuda, n, h, w, h * w)
    want = lut.equalize_plain(x.clone(), idx)
    before = lut.equalize_.launches
    got = lut.equalize_(x.clone(), idx)
    again = lut.equalize_(x.clone(), torch.tensor(idx, device=cuda))
    torch.cuda.synchronize()
    assert lut.equalize_.launches == before + 2
    assert torch.equal(got, want) and torch.equal(again, got)


def test_equalize_kernel_unit_grid(cuda):
    """The card's unit grid (the plain path's quantize_u8(v / 255) there) is
    on the byte grid, and equalize of an image holding every byte once is
    PIL's table on it, bitwise as the plain path."""
    from nextgen_uia_tpu_torch.ops import lut

    grid = lut.unit_grid(cuda)
    assert torch.equal(lut.to_bytes(grid).cpu(), torch.arange(256))
    x = grid.repeat(2, 3)[:, None, :]
    want = lut.equalize_plain(x.clone(), [0, 1])
    assert torch.equal(lut.equalize_(x, [0, 1]), want)


def test_k7_k10_backward_refuses_on_the_card(cuda):
    """K7's and K10's backward kernels refuse what they do not take (an lse
    of the wrong shape; float16, a width not a multiple of 64) instead of
    falling back to a plain version."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    q = torch.randn(1, 2, 20, 64, device=cuda)
    out, lse = fa.flash_attention_forward(q, q, q, layout="bhnd")
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, q, q, out, out, lse[:, :1], layout="bhnd")
    w1, w2, b1 = (torch.randn(64, 128, device=cuda), torch.randn(128, 64, device=cuda),
                  torch.zeros(128, device=cuda))
    x = torch.randn(8, 64, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        fm.fused_mlp_backward(x.half(), w1, b1, w2, x.half())
    with pytest.raises(ValueError, match="does not take"):
        fm.fused_mlp_backward(x[:, :48], w1[:48], b1, w2[:, :48], x[:, :48])


@pytest.mark.parametrize("layout,b,h,n,bias,causal,dtype,bias_grad,dh", [
    ("bnhd", 16, 12, 197, True, False, torch.bfloat16, False, 64),
    ("bhnd", 2, 12, 1370, False, False, torch.bfloat16, False, 64),
    ("bnhd", 2, 4, 300, True, True, torch.bfloat16, True, 64),
    ("bhnd", 2, 2, 77, True, True, torch.bfloat16, False, 64),
    ("bhnd", 2, 3, 77, True, True, torch.float32, True, 64),
    ("bnhd", 1, 2, 530, False, True, torch.float32, False, 64),
    ("bnhd", 2, 3, 197, True, False, torch.float32, True, 64),
    ("bnhd", 2, 3, 1, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 63, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 64, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 65, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 127, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 128, True, True, torch.bfloat16, True, 64),
    ("bnhd", 2, 3, 129, True, True, torch.bfloat16, True, 64),
    ("bnhd", 16, 12, 256, True, False, torch.bfloat16, False, 64),
    *[(*case[:7], case[4], case[7]) for case in F32_FLASH_CASES]])
def test_flash_attention_backward_kernel_matches_plain(cuda, layout, b, h, n, bias, causal,
                                                       dtype, bias_grad, dh):
    """Autograd through K7 on the card reaches the backward kernel (its
    launch counter moves once; nothing runs the plain version) and the
    gradients of q, k, v (the bnhd cases: of one packed [B, N, 3, H, dh]
    leaf, read as strided views) and of the key bias match
    flash_attention_backward_plain on the same (rounded) inputs: float32
    1e-4 * max|ref|, bfloat16 3e-2 * max|ref| (the kernel also rounds P and
    dS to bfloat16, as the JAX kernel does; the plain reference in float32
    does not)."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(n + h)
    if layout == "bnhd":
        qkv = _rounded(torch.randn(b, n, 3, h, dh, generator=gen).to(cuda), dtype)
        leaf = qkv.to(dtype).requires_grad_()
        q, k, v = leaf.unbind(2)
        refs = qkv.unbind(2)
    else:
        refs = [_rounded(torch.randn(b, h, n, dh, generator=gen).to(cuda), dtype)
                for _ in range(3)]
        leaves = [t.to(dtype).requires_grad_() for t in refs]
        q, k, v = leaves
    kb = torch.randn(b, n, generator=gen).to(cuda) if bias else None
    kb_leaf = kb.clone().requires_grad_() if bias and bias_grad else kb
    cot = _rounded(torch.randn(q.shape, generator=gen).to(cuda), dtype)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out = fa.flash_attention(q, k, v, bias=kb_leaf, causal=causal, layout=layout,
                             bias_grad=bias_grad)
    out.backward(cot.to(dtype))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == fwd + 1
    assert fa.flash_attention_backward.launches == bwd + 1
    want = fa.flash_attention_backward_plain(*refs, kb, cot, causal=causal, layout=layout)
    got = (leaf.grad.unbind(2) if layout == "bnhd" else [t.grad for t in leaves])
    if bias and bias_grad:
        got = [*got, kb_leaf.grad]
    # a gradient whose reference is exactly zero (dq, dk and dbias at N = 1,
    # where P = 1) is held to the largest gradient's scale: the kernel's D
    # comes from the rounded output, so it keeps a rounding residue
    largest = max(w.abs().max().item() for w in want if w is not None)
    for g, w in zip(got, want):
        scale = w.abs().max().item() or largest
        bound = (1e-4 if dtype == torch.float32 else 3e-2) * scale
        err = (g.float() - w.float()).abs().max().item()
        assert err <= bound, f"max|d| {err:.3e} > {bound:.3e} (max|ref| {scale:.3e})"


@pytest.mark.parametrize("layout,b,h,n,bias,causal,dtype,dh", [
    ("bnhd", 16, 12, 197, True, False, torch.bfloat16, 64),
    ("bhnd", 2, 12, 1370, False, False, torch.bfloat16, 64),
    ("bnhd", 2, 3, 129, True, True, torch.bfloat16, 64),
    ("bnhd", 32, 4, 197, True, False, torch.float32, 16),
    ("bnhd", 2, 2, 257, True, True, torch.float32, 16),
    ("bhnd", 2, 3, 77, False, True, torch.float32, 32),
    ("bnhd", 2, 2, 65, True, False, torch.float32, 64)])
def test_flash_attention_backward_is_bitwise_deterministic(cuda, layout, b, h, n, bias, causal,
                                                           dtype, dh):
    """Two calls of the backward give bitwise-equal dq, dk and dv (no
    atomics on them; dbias keeps its float32 atomics and is not held to
    this), and each saved lse matches the plain log-sum-exp within 1e-3."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(n)
    q, k, v = (t.to(dtype) for t in _flash_inputs(layout, b, h, n, dh, dtype, gen, cuda))
    kb = torch.randn(b, n, generator=gen).to(cuda) if bias else None
    g = torch.randn(q.shape, generator=gen).to(cuda).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, bias=kb, causal=causal, layout=layout)
    want = fa.flash_attention_lse_plain(q.float(), k.float(), bias=kb, causal=causal,
                                        layout=layout)
    assert (lse - want).abs().max().item() <= 1e-3
    first = fa.flash_attention_backward(q, k, v, out, g, lse, bias=kb, causal=causal,
                                        layout=layout)
    second = fa.flash_attention_backward(q, k, v, out, g, lse, bias=kb, causal=causal,
                                         layout=layout)
    for a, c in zip(first[:3], second[:3]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("n,dtype,dh", [
    (96, torch.bfloat16, 64), (160, torch.bfloat16, 64), (600, torch.bfloat16, 64),
    (197, torch.float32, 16), (300, torch.float32, 16), (70, torch.float32, 64)])
def test_flash_attention_wholly_padded_row_stays_finite(cuda, n, dtype, dh):
    """A sequence whose every key carries BERT's -1e9 padding bias (the
    second of two; the first has its last third padded), at N not a multiple
    of 64, so that the backward's last key tile holds keys past N. The
    forward's output and lse match the plain version for both sequences
    (output 3e-2 * max|ref| in bf16, 1e-4 in float32; lse 1e-3, the padded
    one's, ~-1e9, to one float32 step there); dq, dk, dv and dbias are
    finite everywhere and, for the first sequence, match the plain backward
    within the same bound as the output. The padded sequence's gradients
    are not held to the plain version: its lse rounds to -1e9, losing log
    N, so the kernel's P there is 1, not 1 / N, as in the JAX kernel."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(2, n, 3, 3, dh, generator=gen).to(dtype).to(cuda)
    q, k, v = qkv.unbind(2)
    refs = [t.float() for t in (q, k, v)]
    kb = torch.zeros(2, n)
    kb[0, 2 * n // 3:] = -1e9
    kb[1] = -1e9
    kb = kb.to(cuda)
    g = torch.randn(q.shape, generator=gen).to(dtype).to(cuda)
    rel = 3e-2 if dtype == torch.bfloat16 else 1e-4
    out, lse = fa.flash_attention_forward(q, k, v, bias=kb)
    want = fa.flash_attention_plain(*refs, bias=kb)
    want_lse = fa.flash_attention_lse_plain(*refs[:2], bias=kb)
    assert (out.float() - want).abs().max() <= rel * want.abs().max()
    assert (lse[0] - want_lse[0]).abs().max() <= 1e-3
    assert (lse[1] - want_lse[1]).abs().max() <= 64.0
    got = fa.flash_attention_backward(q, k, v, out, g, lse, bias=kb)
    for t in got:
        assert torch.isfinite(t).all()
    wants = fa.flash_attention_backward_plain(*refs, kb, g.float())
    for t, w in zip(got, wants):
        err = (t[0].float() - w[0]).abs().max().item()
        assert err <= rel * w[0].abs().max().item()


def test_flash_attention_bf16_refuses_what_tma_cannot_take(cuda):
    """The bf16 kernels read through TMA: a head dim other than 64, a base
    that is not 16-byte aligned or a stride that is not a multiple of 8
    elements is refused, with no fallback to a plain version."""
    from nextgen_uia_tpu_torch.ops import flash_attention as fa

    launches = fa.flash_attention.launches
    x = torch.randn(1, 2, 20, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x[..., :32], x[..., :32], x[..., :32], layout="bhnd")
    flat = torch.randn(1 + 2 * 20 * 64, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 20, 64)  # base 2 bytes past an aligned one
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(shifted, shifted, shifted, layout="bhnd")
    wide = torch.randn(1, 2, 20, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(wide, wide, wide, layout="bhnd")
    assert fa.flash_attention.launches == launches


@pytest.mark.parametrize("b,n,width,heads,dtype,bias", [
    (4, 77, 512, 8, torch.float32, False), (4, 77, 512, 8, torch.bfloat16, False),
    (2, 50, 128, 2, torch.float32, True), (3, 200, 128, 2, torch.bfloat16, True)])
def test_fused_block_causal_matches_plain(cuda, b, n, width, heads, dtype, bias):
    """K1 with the causal mask (the CLIP text block: 77 tokens, width 512,
    8 heads, quick_gelu) against its plain version: float32 1e-4 *
    max|ref|, bfloat16 3e-2 * max(1, max|ref|)."""
    blk = _block(cuda, width, heads)
    gen = torch.Generator().manual_seed(n)
    x = _rounded(torch.randn(b, n, width, generator=gen).to(cuda), dtype)
    kw = dict(heads=heads, act="quick_gelu", causal=True,
              key_bias=torch.randn(b, n, generator=gen).to(cuda) if bias else None)
    before = fb.fused_block_infer.launches
    with torch.no_grad():
        _check(lambda t: fb.fused_block_infer(t, blk, **kw),
               lambda t: fb.fused_block_infer_plain(t, blk, **kw), [x.to(dtype)], [x])
        # the causal mask is in force: the first row does not see the others
        y = fb.fused_block_infer(x.to(dtype), blk, **kw)
        x2 = x.clone()
        x2[:, 1:] += 1.0
        y2 = fb.fused_block_infer(x2.to(dtype), blk, **kw)
    assert fb.fused_block_infer.launches == before + 3
    assert torch.equal(y[:, 0], y2[:, 0]) and not torch.equal(y[:, 1], y2[:, 1])


def test_mha_lora_route_runs_the_flash_kernels_forward_and_backward(cuda):
    """The LoRA route of mha on the card (bf16, width 768, 12 heads, r=16,
    nonzero b, a key bias, dropout masks given): the flash-attention kernel
    forward and backward launch once each and no K5/K6 kernel; the output
    and the gradients of x, the LoRA pairs and the projection biases match
    the plain ops on the card within 3e-2 * max(1, max|ref|)."""
    from nextgen_uia_tpu_torch.adapters.lora import inject_lora
    from nextgen_uia_tpu_torch.nn.attention import mha
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN
    from nextgen_uia_tpu_torch.ops import flash_attention as fa
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_ln_qkv

    width, heads, n = 768, 12, 197
    blk = _block(cuda, width, heads).cpu()
    holder = torch.nn.Module()
    holder.blocks = torch.nn.ModuleList([blk])
    gen = torch.Generator().manual_seed(3)
    inject_lora(gen, holder, dim=width, r=16)
    with torch.no_grad():
        for pair in blk.attn.lora.children():
            pair.b.normal_(0.0, 0.05, generator=gen)
    blk.to(cuda)
    train = [t for name, t in blk.attn.named_parameters() if "lora" in name or name.endswith(".b")]
    for t in train:
        t.requires_grad_(True)
    x = torch.randn(4, n, width, generator=gen).to(cuda)
    kb = torch.randn(4, n, generator=gen).to(cuda)
    masks = {t: (torch.rand(4, n, width, generator=gen) > 0.1).float().div(0.9).to(cuda)
             for t in "qkvo"}

    def run(ops):
        xx = x.to(torch.bfloat16).requires_grad_()
        for t in train:
            t.grad = None
        out = mha(blk.attn, xx, num_heads=heads, ln=blk.ln1, residual=xx,
                  key_padding_bias=kb, lora_alpha=32.0, lora_masks=masks, ops=ops)
        out.float().square().mean().backward()
        return [out, xx.grad] + [t.grad.clone() for t in train]

    counts = (fa.flash_attention.launches, fa.flash_attention_backward.launches,
              fused_ln_qkv.fused_ln_qkv.launches, fused_attn_o.fused_attn_o_residual.launches)
    got = run(KERNELS)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches, fa.flash_attention_backward.launches,
             fused_ln_qkv.fused_ln_qkv.launches, fused_attn_o.fused_attn_o_residual.launches)
    assert [a - c for a, c in zip(after, counts)] == [1, 1, 0, 0]
    want = run(PLAIN)
    for g, w in zip(got, want):
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        assert err <= 3e-2 * max(1.0, scale), (err, scale)


def _bert_layer(device, width, heads, hidden):
    from nextgen_uia_tpu_torch.models import bert

    gen = torch.Generator().manual_seed(width + hidden)
    layer = bert.BertLayer(gen, bert.BertConfig(width=width, heads=heads, intermediate=hidden))
    with torch.no_grad():
        for ln in (layer.attn_ln, layer.ffn_ln):
            ln.scale.add_(0.2 * torch.randn(width, generator=gen))
            ln.bias.add_(0.2 * torch.randn(width, generator=gen))
    return layer.to(device)


@pytest.mark.parametrize("b,n,width,heads,hidden", [
    (4, 256, 768, 12, 3072), (7, 96, 768, 12, 3072), (3, 40, 128, 2, 512),
    (7, 197, 768, 12, 3072), (1, 16, 768, 12, 3072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_postnorm_kernels_match_plain(cuda, b, n, width, heads, hidden, dtype):
    """K5 raw-x, K6 post-LN, K9 and K1 post-norm against their plain
    versions, each counting one launch; the last batch row's keys are all
    padding and its outputs finite. 197 tokens: a count K5 raw-x's
    128-token M tile does not divide; [1, 16]: fewer rows than one tile."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_ln_mlp, fused_ln_qkv

    layer = _bert_layer(cuda, width, heads, hidden)
    gen = torch.Generator().manual_seed(n + b)
    x = _rounded(torch.randn(b, n, width, generator=gen).to(cuda), dtype)
    q, k, v = (_rounded(torch.randn(b, heads, n, width // heads, generator=gen).to(cuda), dtype)
               for _ in range(3))
    mask = torch.ones(b, n, device=cuda)
    mask[0, n // 3:] = 0.0
    mask[-1] = 0.0
    bias = (1.0 - mask) * -1e9
    counters = (fused_ln_qkv.fused_ln_qkv_rawx, fused_attn_o.fused_attn_o_residual_postln,
                fused_ln_mlp.fused_postnorm_mlp_ln, fb.fused_block_infer_postnorm)
    before = [f.launches for f in counters]
    akw = dict(heads=heads, bias=bias, post_ln=layer.attn_ln, ln_eps=1e-12)
    bkw = dict(heads=heads, eps=1e-12, key_bias=bias, layout="postnorm")
    with torch.no_grad():
        _check(lambda t: fused_ln_qkv.fused_ln_qkv(t, None, layer.attn, heads=heads),
               lambda t: fused_ln_qkv.fused_ln_qkv_plain(t, None, layer.attn, heads=heads),
               [x.to(dtype)], [x])
        _check(lambda *t: fused_attn_o.fused_attn_o_residual(*t, layer.attn.o, **akw),
               lambda *t: fused_attn_o.fused_attn_o_residual_plain(*t, layer.attn.o, **akw),
               [t.to(dtype) for t in (q, k, v, x)], [q, k, v, x])
        _check(lambda t: fused_ln_mlp.fused_postnorm_mlp_ln(t, layer.ffn, layer.ffn_ln),
               lambda t: fused_ln_mlp.fused_postnorm_mlp_ln_plain(t, layer.ffn, layer.ffn_ln),
               [x.to(dtype)], [x])
        _check(lambda t: fb.fused_block_infer(t, layer, **bkw),
               lambda t: fb.fused_block_infer_plain(t, layer, **bkw), [x.to(dtype)], [x])
        y = fb.fused_block_infer(x.to(dtype), layer, **bkw)
    assert bool(torch.isfinite(y[-1]).all())
    assert [f.launches for f in counters] == [n_ + 1 for n_ in before[:3]] + [before[3] + 2]


@pytest.mark.parametrize("route", ["chain", "whole_layer"])
def test_bert_apply_kernels_match_plain(cuda, monkeypatch, route):
    """The full-width tower (depth cut to 2) in bf16 on padded captions:
    features against the plain path, 3e-2 * max(1, max|ref|); float32
    1e-4 * max|ref|."""
    from nextgen_uia_tpu_torch.models import bert
    from nextgen_uia_tpu_torch.ops import PLAIN, fused_ln_qkv

    cfg = bert.BertConfig(depth=2, block_impl="fused_infer")
    if route == "whole_layer":
        monkeypatch.setenv("NEXTGEN_UIA_FUSED_BLOCK_BERT", "1")
    tower = bert.bert_init(torch.Generator().manual_seed(0), cfg).to(cuda)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(1, 30000, (6, 256), generator=gen)
    for i, n in enumerate((3, 40, 100, 256, 17, 64)):
        ids[i, n:] = 0
    ids = ids.to(cuda)
    k5, k1 = fused_ln_qkv.fused_ln_qkv_rawx.launches, fb.fused_block_infer_postnorm.launches
    with torch.no_grad():
        got = bert.bert_apply(tower, cfg, ids, dtype=torch.bfloat16)
        ref = bert.bert_apply(tower, cfg, ids, ops=PLAIN)
    assert got.shape == (6, 512) and got.dtype == torch.bfloat16
    whole = route == "whole_layer"
    assert fused_ln_qkv.fused_ln_qkv_rawx.launches - k5 == (0 if whole else 2)
    assert fb.fused_block_infer_postnorm.launches - k1 == (2 if whole else 0)
    scale = ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= 3e-2 * max(1.0, scale)
    with torch.no_grad():
        f32 = bert.bert_apply(tower, cfg, ids)
    assert (f32 - ref).abs().max().item() <= 1e-4 * scale


def test_bert_forward_only_kernels_refuse_autograd_on_the_card(cuda):
    """K1 post-norm, the eval route's whole layer, is forward only: autograd
    reaching it raises. The chain's three ops differentiate on the card
    (test_bert_chain_backward_matches_plain)."""
    layer = _bert_layer(cuda, 128, 2, 512)
    x = torch.randn(2, 16, 128, device=cuda, requires_grad=True)
    out = fb.fused_block_infer(x, layer, heads=2, eps=1e-12, layout="postnorm")
    with pytest.raises(NotImplementedError, match="forward only.*ROADMAP"):
        out.sum().backward()


@pytest.mark.parametrize("m,d,hidden,act,dtype", [
    (4096, 768, 3072, "gelu", torch.bfloat16), (4096, 768, 3072, "gelu", torch.float32),
    (77, 128, 512, "quick_gelu", torch.float32), (203, 128, 512, "gelu", torch.bfloat16)])
def test_fused_mlp_backward_kernel_matches_plain(cuda, m, d, hidden, act, dtype):
    """K10's backward (dx) against fused_mlp_backward_plain, one launch,
    and autograd through fused_mlp reaching it."""
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(m + d)
    x, g = (_rounded(torch.randn(m, d, generator=gen).to(cuda), dtype) for _ in range(2))
    w1 = _rounded(torch.randn(d, hidden, generator=gen).to(cuda) / d ** 0.5, dtype)
    w2 = _rounded(torch.randn(hidden, d, generator=gen).to(cuda) / hidden ** 0.5, dtype)
    b1, b2 = (0.1 * torch.randn(n, generator=gen).to(cuda) for n in (hidden, d))
    before = fm.fused_mlp_backward.launches
    with torch.no_grad():
        _check(lambda *t: fm.fused_mlp_backward(*t, act=act),
               lambda *t: fm.fused_mlp_backward_plain(*t, act=act),
               [x.to(dtype), w1, b1, w2, g.to(dtype)], [x, w1, b1, w2, g])
    xx = x.to(dtype).requires_grad_()
    (fm.fused_mlp(xx, w1, b1, w2, b2, act=act).float() * g).sum().backward()
    assert fm.fused_mlp_backward.launches == before + 2
    want = fm.fused_mlp_backward_plain(x, w1, b1, w2, g, act=act)
    _check(lambda: xx.grad, lambda: want, [])


@pytest.mark.parametrize("b,n,width,heads", [
    (16, 256, 768, 12), (3, 40, 128, 2), (7, 197, 768, 12), (1, 16, 768, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_rawx_backward_kernel_matches_plain(cuda, b, n, width, heads, dtype):
    """K5 raw-x's backward (dx from head-major dq, dk, dv) against its plain
    version, one launch, and autograd through fused_ln_qkv with ln=None;
    two calls bitwise equal (no atomics, no split of K). 197 tokens: a
    count the 128-token M tile does not divide; [1, 16]: under one tile."""
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv

    layer = _bert_layer(cuda, width, heads, 4 * width)
    gen = torch.Generator().manual_seed(n + b)
    dy = [_rounded(torch.randn(b, heads, n, width // heads, generator=gen).to(cuda), dtype)
          for _ in range(3)]
    w, _ = fused_ln_qkv._rawx_weights(layer.attn, torch.float32)
    before = fused_ln_qkv.fused_ln_qkv_rawx_backward.launches
    _check(lambda *t: fused_ln_qkv.fused_ln_qkv_rawx_backward(w, *t, dtype=dtype),
           lambda *t: fused_ln_qkv.fused_ln_qkv_rawx_backward_plain(w, *t, dtype=torch.float32),
           [t.to(dtype) for t in dy], dy)
    x = torch.randn(b, n, width, generator=gen).to(cuda).to(dtype).requires_grad_()
    outs = fused_ln_qkv.fused_ln_qkv(x, None, layer.attn, heads=heads)
    sum((o.float() * t).sum() for o, t in zip(outs, dy)).backward()
    assert fused_ln_qkv.fused_ln_qkv_rawx_backward.launches == before + 2
    want = fused_ln_qkv.fused_ln_qkv_rawx_backward_plain(w, *dy, dtype=torch.float32)
    _check(lambda: x.grad, lambda: want, [])
    again = [fused_ln_qkv.fused_ln_qkv_rawx_backward(w, *[t.to(dtype) for t in dy], dtype=dtype)
             for _ in range(2)]
    assert torch.equal(*again)


@pytest.mark.parametrize("backward", [False, True])
def test_qkv_rawx_bf16_kernel_refuses_head_dim_not_a_multiple_of_64(cuda, backward):
    """The Hopper GEMM's K step (backward) and output box (forward) are one
    head's 64 columns: bf16 with dh = 32 raises and names the limit, where
    float32 (the SIMT GEMM, dh % 8) runs."""
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv

    layer = _bert_layer(cuda, 128, 4, 512)
    x = torch.randn(2, 24, 128, device=cuda)
    dy = [torch.randn(2, 4, 24, 32, device=cuda) for _ in range(3)]
    w, _ = fused_ln_qkv._rawx_weights(layer.attn, torch.float32)

    def run(dtype):
        if backward:
            return fused_ln_qkv.fused_ln_qkv_rawx_backward(w, *[t.to(dtype) for t in dy],
                                                           dtype=dtype)
        return fused_ln_qkv.fused_ln_qkv(x.to(dtype), None, layer.attn, heads=4)

    with torch.no_grad():
        run(torch.float32)
        with pytest.raises(ValueError, match="head dim % 64 == 0"):
            run(torch.bfloat16)


@pytest.mark.parametrize("shape", [(64, 14, 14, 64), (2, 9, 11, 32), (1, 3, 5, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwconv7_kernels_match_plain(cuda, shape, dtype):
    """K4 forward and backward (dx, dk) against their plain versions: float32
    1e-4 * max|ref|, bf16 3e-2 * max(1, max|ref|); one launch each."""
    from nextgen_uia_tpu_torch.ops import dwconv

    gen = torch.Generator().manual_seed(sum(shape))
    x, g = (_rounded(torch.randn(*shape, generator=gen).to(cuda), dtype) for _ in range(2))
    k = _rounded(0.2 * torch.randn(shape[0], 7, 7, shape[3], generator=gen).to(cuda), dtype)
    counts = (dwconv.dwconv7_per_sample.launches, dwconv.dwconv7_per_sample_backward.launches)
    with torch.no_grad():
        _check(dwconv.dwconv7_per_sample, dwconv.dwconv7_per_sample_plain,
               [x.to(dtype), k.to(dtype)], [x, k])
        _check(dwconv.dwconv7_per_sample_backward, dwconv.dwconv7_per_sample_backward_plain,
               [x.to(dtype), k.to(dtype), g.to(dtype)], [x, k, g])
    assert (dwconv.dwconv7_per_sample.launches, dwconv.dwconv7_per_sample_backward.launches) == \
        (counts[0] + 1, counts[1] + 1)


def test_bert_chain_backward_matches_plain(cuda):
    """The full-width tower (depth 2) with LoRA in layer 0 only, float32 on
    padded captions: layer 1 runs the chain (K5 raw-x, K6 post-LN, K9) and
    its backwards (K5 raw-x's kernel; K6 post-LN's and K9's by plain
    recomposition), layer 0 the LoRA route (K7, K10 and their backwards);
    every LoRA and bias gradient against the plain path within 1e-4 * the
    largest max|ref| (and 3e-2 * its own but for the key bias, whose exact
    gradient is zero)."""
    from nextgen_uia_tpu_torch.adapters.lora import inject_lora_bert
    from nextgen_uia_tpu_torch.core.partition import partition
    from nextgen_uia_tpu_torch.models import bert
    from nextgen_uia_tpu_torch.ops import KERNELS, PLAIN, fused_ln_qkv
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    cfg = bert.BertConfig(depth=2)
    gen = torch.Generator().manual_seed(0)
    tower = bert.bert_init(gen, cfg)
    inject_lora_bert(gen, tower, dim=768, num_layers=1)
    with torch.no_grad():
        for pair in tower.layers[0].attn.lora.children():
            pair.b.normal_(0.0, 0.02, generator=gen)
    lora_attn = "layers/0/attn/"
    train, _ = partition(tower, lambda p: "lora" in p or (p.startswith(lora_attn)
                                                         and p.endswith("/b")))
    tower.to(cuda)
    ids = torch.randint(1, 30000, (4, 96), generator=gen)
    for i, n in enumerate((3, 40, 96, 17)):
        ids[i, n:] = 0
    ids = ids.to(cuda)

    def grads(ops):
        for t in train.values():
            t.grad = None
        bert.bert_apply(tower, cfg, ids, ops=ops).square().sum().backward()
        return {k: t.grad.clone() for k, t in train.items()}

    counts = (fused_ln_qkv.fused_ln_qkv_rawx_backward.launches, fm.fused_mlp_backward.launches)
    got = grads(KERNELS)
    torch.cuda.synchronize()
    assert (fused_ln_qkv.fused_ln_qkv_rawx_backward.launches - counts[0],
            fm.fused_mlp_backward.launches - counts[1]) == (1, 1)
    want = grads(PLAIN)
    top = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        err, own = (got[k] - w).abs().max().item(), w.abs().max().item()
        assert err <= 1e-4 * top, (k, err, top)
        assert k.endswith("attn/k/b") or err <= 3e-2 * own, (k, err, own)


def _mona(device, dim, variant, seed):
    """A MONA adapter whose gamma, LN and frequency filter are perturbed
    (the init's gamma 1e-6 would hide the LayerNorm branch), trainable."""
    from nextgen_uia_tpu_torch.adapters.mona import Mona

    gen = torch.Generator().manual_seed(seed)
    m = Mona(gen, dim, 64, variant)
    with torch.no_grad():
        m.gamma.copy_(0.5 * torch.randn(dim, generator=gen))
        m.norm.scale.add_(0.1 * torch.randn(dim, generator=gen))
        m.norm.bias.add_(0.1 * torch.randn(dim, generator=gen))
        if hasattr(m, "freq_filter"):
            m.freq_filter.add_(0.3 * torch.randn(64, generator=gen))
    for t in m.parameters():
        t.requires_grad_(True)
    return m.to(device)


@pytest.mark.parametrize("b,grid,tail,dim,variant", [
    (4, 14, 0, 768, "hybrid"), (3, 4, 3, 128, "baseline"), (2, 5, 1, 128, "noise_aware"),
    (2, 4, 0, 128, "freq_enhanced")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mona_kernels_match_plain(cuda, b, grid, tail, dim, variant, dtype):
    """K12 forward and backward against the plain versions on the same
    inputs: output and dx within 1e-4 * max|ref| (float32) or 3e-2 * max|ref|
    (bfloat16); each parameter gradient within 1e-4 * the largest max|ref|
    and 3e-2 * its own (float32), or 3e-2 * the largest (bfloat16); two
    backward calls bitwise equal."""
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    m = _mona(cuda, dim, variant, seed=b + grid)
    n = grid * grid + 1 + tail
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(b, n, dim, generator=gen).to(cuda, dtype)
    g = torch.randn(b, n, dim, generator=gen).to(cuda, dtype)
    mask = ((torch.rand(b, n, 64, generator=gen) < 0.9).float() / 0.9).to(cuda)
    kw = dict(variant=variant, mask=mask)
    f0, b0 = fm.mona_block_fused.launches, fm.mona_block_fused_backward.launches
    with torch.no_grad():
        out, saved = fm.mona_block_fused_forward(m, x, (grid, grid), **kw)
        ref = fm.mona_block_fused_plain(m, x, (grid, grid), **kw)
        dx, grads = fm.mona_block_fused_backward(m, x, (grid, grid), g, saved, **kw)
        dx2, grads2 = fm.mona_block_fused_backward(m, x, (grid, grid), g, saved, **kw)
        want_dx, want = fm.mona_block_fused_backward_plain(m, x, (grid, grid), g, **kw)
    torch.cuda.synchronize()
    assert (fm.mona_block_fused.launches - f0, fm.mona_block_fused_backward.launches - b0) == (1, 2)
    lim = 1e-4 if dtype == torch.float32 else 3e-2
    for got, r in ((out, ref), (dx, want_dx)):
        assert (got.float() - r.float()).abs().max().item() <= lim * r.float().abs().max().item()
    assert torch.equal(dx, dx2)
    top = max(t.abs().max().item() for t in want.values())
    assert set(grads) == set(want) == {k for k, _ in m.named_parameters()}
    for k, r in want.items():
        assert torch.equal(grads[k], grads2[k]), f"{k} not bitwise repeatable"
        diff, own = (grads[k] - r).abs().max().item(), r.abs().max().item()
        assert diff <= lim * top, f"{k}: {diff:.3e} > {lim} * {top:.3e}"
        if dtype == torch.float32:
            assert diff <= 3e-2 * own, f"{k}: {diff:.3e} > 3e-2 * {own:.3e}"


def test_fused_mona_autograd_on_the_card(cuda):
    """Through autograd: dx only when x needs it (block 0's input needs
    none), every parameter's gradient, one forward and one backward launch."""
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    m = _mona(cuda, 128, "hybrid", seed=0)
    x = torch.randn(2, 17, 128, device=cuda)
    for needs_dx in (False, True):
        xx = x.clone().requires_grad_(needs_dx)
        f0, b0 = fm.mona_block_fused.launches, fm.mona_block_fused_backward.launches
        fm.mona_block_fused(m, xx, (4, 4), variant="hybrid").square().sum().backward()
        assert (fm.mona_block_fused.launches - f0, fm.mona_block_fused_backward.launches - b0) \
            == (1, 1)
        assert (xx.grad is not None) == needs_dx
        assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                   for t in m.parameters())
        for t in m.parameters():
            t.grad = None


def _attention(device, width, seed):
    from nextgen_uia_tpu_torch.nn.attention import Attention

    return Attention(torch.Generator().manual_seed(seed), width).to(device)


@pytest.mark.parametrize("b,n,width,heads,causal,bias", [
    (4, 197, 768, 12, False, True), (3, 77, 512, 8, True, False), (2, 40, 128, 2, True, True),
    (3, 50, 128, 2, False, True), (1, 1, 128, 2, False, False), (5, 129, 256, 4, True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_kernels_match_plain(cuda, b, n, width, heads, causal, bias, dtype):
    """K11 forward and dx backward, and the hybrid forward (plain products
    around K7), against the plain versions on the same inputs: 1e-4 *
    max|ref| in float32, 3e-2 * max|ref| in bfloat16. The flat products'
    128-row tiles cross sequences at 50 and 129 tokens, and their last
    tile is ragged (150 and 645 rows; one row at [1, 1])."""
    from nextgen_uia_tpu_torch.ops import fused_attention as fa

    p = _attention(cuda, width, seed=n)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(b, n, width, generator=gen).to(cuda, dtype)
    g = torch.randn(b, n, width, generator=gen).to(cuda, dtype)
    kb = (torch.randn(b, n, generator=gen) - 5.0 * (torch.rand(b, n, generator=gen) < 0.2)
          ).to(cuda) if bias else None
    kw = dict(heads=heads, bias=kb, causal=causal)
    lim = 1e-4 if dtype == torch.float32 else 3e-2
    with torch.no_grad():
        pairs = [(fa.fused_attn_block(x, p, **kw), fa.fused_attn_block_plain(x, p, **kw)),
                 (fa.hybrid_attn_block(x, p, **kw), fa.hybrid_attn_block_plain(x, p, **kw)),
                 (fa.fused_attn_block_backward(x, p, g, **kw),
                  fa.fused_attn_block_backward_plain(x, p, g, **kw))]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert got.dtype == dtype and got.shape == x.shape
        scale = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= lim * scale


@pytest.mark.parametrize("b,n,width,heads,causal,bias", [
    (4, 197, 768, 12, False, True), (3, 77, 512, 8, True, False)])
def test_fused_attention_backward_is_bitwise_deterministic(cuda, b, n, width, heads, causal,
                                                           bias):
    """Two calls of K11's bf16 backward give bitwise-equal dx (no atomics,
    no split of K in its products or its attention backward)."""
    from nextgen_uia_tpu_torch.ops import fused_attention as fa

    p = _attention(cuda, width, seed=n)
    gen = torch.Generator().manual_seed(n + 1)
    x, g = (torch.randn(b, n, width, generator=gen).to(cuda, torch.bfloat16) for _ in range(2))
    kb = torch.randn(b, n, generator=gen).to(cuda) if bias else None
    with torch.no_grad():
        first, second = (fa.fused_attn_block_backward(x, p, g, heads=heads, bias=kb,
                                                      causal=causal) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """On the card the K11 and K12 routes launch their kernels (counted) and
    never call a plain version, forward or backward."""
    from nextgen_uia_tpu_torch.ops import fused_attention as fa
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, names in ((fm, ("_forward_core", "_backward_plain")),
                       (fa, ("fused_attn_block_plain", "fused_attn_block_backward_plain",
                             "flash_attention_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    m = _mona(cuda, 128, "hybrid", seed=1)
    p = _attention(cuda, 128, seed=1)
    x = torch.randn(2, 17, 128, device=cuda, requires_grad=True)
    counts = [fm.mona_block_fused.launches, fm.mona_block_fused_backward.launches,
              fa.fused_attn_block.launches, fa.fused_attn_block_backward.launches]
    y = fm.mona_block_fused(m, x, (4, 4), variant="hybrid")
    y = fa.fused_attn_block(y, p, heads=2) + fa.hybrid_attn_block(y, p, heads=2, causal=True)
    y.square().sum().backward()
    assert [fm.mona_block_fused.launches, fm.mona_block_fused_backward.launches,
            fa.fused_attn_block.launches, fa.fused_attn_block_backward.launches] == \
        [counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + 2]


def _k6_k8_backward_args(device, b, n, width, heads, seed):
    from nextgen_uia_tpu_torch.ops import fused_ln_mlp

    blk = _block(device, width, heads)
    gen = torch.Generator().manual_seed(seed)
    bf16, dh = torch.bfloat16, width // heads
    q, k, v = (torch.randn(b, heads, n, dh, generator=gen).to(device, bf16) for _ in range(3))
    x, g = (torch.randn(b, n, width, generator=gen).to(device, bf16) for _ in range(2))
    ws = fused_ln_mlp._weights(blk.ln2, blk.mlp, torch.float32)[:5]
    return blk, (q, k, v), x, g, ws


@pytest.mark.parametrize("m", [4096, 1001])
def test_fused_mlp_backward_is_bitwise_deterministic(cuda, m):
    """Two calls of K10's bf16 backward give bitwise-equal dx (each output
    element one thread's sum in a fixed order, no atomics)."""
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(m)
    bf16 = torch.bfloat16
    x, g = (torch.randn(m, 768, generator=gen).to(cuda, bf16) for _ in range(2))
    w1 = (torch.randn(768, 3072, generator=gen) / 768 ** 0.5).to(cuda, bf16)
    w2 = (torch.randn(3072, 768, generator=gen) / 3072 ** 0.5).to(cuda, bf16)
    b1 = (0.1 * torch.randn(3072, generator=gen)).to(cuda)
    with torch.no_grad():
        first, second = (fm.fused_mlp_backward(x, w1, b1, w2, g) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,n,width,heads", [(64, 197, 768, 12), (3, 50, 128, 2)])
def test_k6_k8_backward_is_bitwise_deterministic(cuda, b, n, width, heads):
    """Two calls of K6's and of K8's bf16 backward give bitwise-equal
    gradients (no atomics, no split of K in their products or K7's
    backward); K6 also with a key bias and n_real < N."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_ln_mlp

    blk, (q, k, v), x, g, ws = _k6_k8_backward_args(cuda, b, n, width, heads, seed=n)
    wo = blk.attn.o.w.to(torch.bfloat16)
    kb = torch.randn(b, n, generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.no_grad():
        for kw in ({}, dict(bias=kb, n_real=n - 7)):
            first, second = (fused_attn_o.fused_attn_o_residual_backward(q, k, v, wo, g, **kw)
                             for _ in range(2))
            assert all(torch.equal(a, c) for a, c in zip(first, second))
        first, second = (fused_ln_mlp.fused_ln_mlp_residual_backward(x, *ws, g)
                         for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_bf16_k6_refuses_head_dim_not_64(cuda):
    """The bf16 K6 kernels are K7's wgmma kernels and the Hopper GEMM core:
    a head dim other than 64 raises, forward and backward, naming the
    shape; float32 takes it."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o

    blk = _block(cuda, 128, 4)
    q = torch.randn(2, 4, 17, 32, device=cuda)
    x = torch.randn(2, 17, 128, device=cuda)
    bf = [t.to(torch.bfloat16) for t in (q, x)]
    with torch.no_grad():
        with pytest.raises(ValueError, match=r"q \(2, 4, 17, 32\).*head dim 32"):
            fused_attn_o.fused_attn_o_residual(bf[0], bf[0], bf[0], bf[1], blk.attn.o, heads=4)
        with pytest.raises(ValueError, match=r"q \(2, 4, 17, 32\).*head dim 32"):
            fused_attn_o.fused_attn_o_residual_backward(bf[0], bf[0], bf[0], blk.attn.o.w, bf[1])
        out = fused_attn_o.fused_attn_o_residual(q, q, q, x, blk.attn.o, heads=4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def _device_kernel_names(fn, what, expect, forbid):
    """The names of the kernels torch.profiler sees in calls of fn. A
    window can hold only part of the calls' kernels, or none at all (the
    profiler has come back empty on the card for a window of one short
    call), so a window that lacks a kernel whose name holds each of
    ``expect`` is profiled again with twice the calls: 6 windows, 2 to 64
    calls, as chip_smoke.py::kernel_device_ms profiles 20 calls. Every
    window that shows a kernel whose name holds one of ``forbid`` fails, and
    so does a run of windows that never held the expected ones, whether
    they recorded other kernels or no device activity at all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for window in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 << window):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        bad = sorted(k for k in names if any(f in k for f in forbid))
        assert not bad, (what, bad)
        if all(any(e in k for k in names) for e in expect):
            return names
        seen |= names
    pytest.fail(f"{what}: no profiler window of 6 (2 to 64 calls) held a kernel named like "
                f"each of {list(expect)}; seen {sorted(seen) or 'no device activity'}")


def test_bf16_k6_k8_reach_no_wmma_gemm(cuda):
    """A bf16 K6 or K8 call, forward or backward, runs its products on the
    Hopper GEMM core and its attention on K7's kernels: the profiler sees
    no WMMA GEMM (gemm_bf16) and no SIMT attention kernel."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o, fused_ln_mlp

    blk, (q, k, v), x, g, ws = _k6_k8_backward_args(cuda, 4, 197, 768, 12, seed=3)
    wo = blk.attn.o.w.to(torch.bfloat16)
    calls = {
        "K6 forward": lambda: fused_attn_o.fused_attn_o_residual(q, k, v, x, blk.attn.o,
                                                                 heads=12),
        "K6 backward": lambda: fused_attn_o.fused_attn_o_residual_backward(q, k, v, wo, g),
        "K8 forward": lambda: fused_ln_mlp.fused_ln_mlp_residual(x, blk.ln2, blk.mlp),
        "K8 backward": lambda: fused_ln_mlp.fused_ln_mlp_residual_backward(x, *ws, g)}
    with torch.no_grad():
        for what, fn in calls.items():
            _device_kernel_names(fn, what, ("hopper::gemm_kernel",),
                                 ("gemm_bf16", "attention_kernel", "simt"))


def test_bf16_k1_k6post_reach_no_wmma_gemm(cuda):
    """A bf16 K1 call (pre-norm, causal, post-norm with a padding bias) or K6
    post-LN call runs its products on the Hopper GEMM core and its attention
    on K7's kernels: the profiler sees hopper::gemm_kernel and a flash
    kernel, no WMMA GEMM (gemm_bf16) and no SIMT attention kernel."""
    from nextgen_uia_tpu_torch.ops import fused_attn_o

    bf16 = torch.bfloat16
    blk, tblk = _block(cuda, 768, 12), _block(cuda, 512, 8)
    layer = _bert_layer(cuda, 768, 12, 3072)
    gen = torch.Generator().manual_seed(4)
    x, tx, bx = (torch.randn(*shape, generator=gen).to(cuda, bf16)
                 for shape in ((4, 197, 768), (8, 77, 512), (4, 256, 768)))
    q, k, v = (torch.randn(4, 12, 256, 64, generator=gen).to(cuda, bf16) for _ in range(3))
    bias = torch.zeros(4, 256, device=cuda)
    bias[0, 100:], bias[-1] = -1e9, -1e9
    calls = {
        "K1 pre-norm": lambda: fb.fused_block_infer(x, blk, heads=12, eps=1e-6),
        "K1 causal": lambda: fb.fused_block_infer(tx, tblk, heads=8, act="quick_gelu",
                                                  causal=True),
        "K1 post-norm": lambda: fb.fused_block_infer(bx, layer, heads=12, eps=1e-12,
                                                     key_bias=bias, layout="postnorm"),
        "K6 post-LN": lambda: fused_attn_o.fused_attn_o_residual(
            q, k, v, bx, layer.attn.o, heads=12, bias=bias, post_ln=layer.attn_ln)}
    with torch.no_grad():
        for what, fn in calls.items():
            _device_kernel_names(fn, what, ("hopper::gemm_kernel", "flash"),
                                 ("gemm_bf16", "attention_kernel", "simt"))


def test_bf16_k9_k10_reach_no_wmma_gemm(cuda):
    """A bf16 K9 call (BERT's chunk [256, 256, 768]) and K10's forward (an
    odd row count) and backward run every product on the Hopper GEMM core:
    the profiler sees hopper::gemm_kernel and no WMMA GEMM (gemm_bf16)."""
    from nextgen_uia_tpu_torch.ops import fused_ln_mlp
    from nextgen_uia_tpu_torch.ops import fused_mlp as fm

    bf16 = torch.bfloat16
    layer = _bert_layer(cuda, 768, 12, 3072)
    gen = torch.Generator().manual_seed(9)
    bx = torch.randn(256, 256, 768, generator=gen).to(cuda, bf16)
    x, g = (torch.randn(1001, 768, generator=gen).to(cuda, bf16) for _ in range(2))
    fc1, fc2 = layer.ffn.fc1, layer.ffn.fc2
    w1, w2 = fc1.w.to(bf16), fc2.w.to(bf16)
    calls = {
        "K9": lambda: fused_ln_mlp.fused_postnorm_mlp_ln(bx, layer.ffn, layer.ffn_ln),
        "K10 forward": lambda: fm.fused_mlp(x, fc1.w, fc1.b, fc2.w, fc2.b),
        "K10 backward": lambda: fm.fused_mlp_backward(x, w1, fc1.b, w2, g)}
    with torch.no_grad():
        for what, fn in calls.items():
            _device_kernel_names(fn, what, ("hopper::gemm_kernel",), ("gemm_bf16",))


@pytest.mark.parametrize("b,n,width,heads", [
    (64, 197, 768, 12), (32, 197, 768, 12), (3, 37, 768, 12), (1, 1, 768, 12),
    (2, 130, 128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_prenorm_kernels_match_plain(cuda, b, n, width, heads, dtype):
    """K5 pre-norm (on the Hopper GEMM core in bf16) forward and dx backward
    against their plain versions at the bench step's and the supervised
    step's [B, 197, 768] and at ragged token counts (37, 130: a sequence's
    last 128-row tile ragged; 1: under one tile), one launch each; the bf16
    backward bitwise equal over two calls."""
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv

    blk = _block(cuda, width, heads)
    gen = torch.Generator().manual_seed(n + b)
    x = _rounded(torch.randn(b, n, width, generator=gen).to(cuda), dtype)
    dy = [_rounded(torch.randn(b, heads, n, width // heads, generator=gen).to(cuda), dtype)
          for _ in range(3)]
    gamma, _, w_qkv, _ = fused_ln_qkv._weights(blk.ln1, blk.attn, torch.float32)
    w_qkv = _rounded(w_qkv, dtype)
    before = (fused_ln_qkv.fused_ln_qkv.launches, fused_ln_qkv.fused_ln_qkv_backward.launches)
    with torch.no_grad():
        _check(lambda t: fused_ln_qkv.fused_ln_qkv(t, blk.ln1, blk.attn, heads=heads),
               lambda t: fused_ln_qkv.fused_ln_qkv_plain(t, blk.ln1, blk.attn, heads=heads),
               [x.to(dtype)], [x])
        _check(lambda *t: fused_ln_qkv.fused_ln_qkv_backward(t[0], gamma, w_qkv, *t[1:]),
               lambda *t: fused_ln_qkv.fused_ln_qkv_backward_plain(t[0], gamma, w_qkv, *t[1:]),
               [t.to(dtype) for t in [x, *dy]], [x, *dy])
        again = [fused_ln_qkv.fused_ln_qkv_backward(x.to(dtype), gamma, w_qkv,
                                                    *[t.to(dtype) for t in dy])
                 for _ in range(2)]
    torch.cuda.synchronize()
    assert (fused_ln_qkv.fused_ln_qkv.launches, fused_ln_qkv.fused_ln_qkv_backward.launches) \
        == (before[0] + 1, before[1] + 3)
    assert torch.equal(*again)


@pytest.mark.parametrize("backward", [False, True])
def test_k5_prenorm_bf16_refuses_head_dim_not_a_multiple_of_64(cuda, backward):
    """K5 pre-norm's bf16 products are the Hopper GEMM core's, whose K step
    (backward) and output box (forward) are one head's 64 columns: bf16
    with dh = 32 raises and names the limit; float32 (the SIMT GEMM) runs."""
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv

    blk = _block(cuda, 128, 4)
    x = torch.randn(2, 24, 128, device=cuda)
    dy = [torch.randn(2, 4, 24, 32, device=cuda) for _ in range(3)]
    gamma, _, w_qkv, _ = fused_ln_qkv._weights(blk.ln1, blk.attn, torch.float32)

    def run(dtype):
        if backward:
            return fused_ln_qkv.fused_ln_qkv_backward(x.to(dtype), gamma, w_qkv,
                                                      *[t.to(dtype) for t in dy])
        return fused_ln_qkv.fused_ln_qkv(x.to(dtype), blk.ln1, blk.attn, heads=4)

    with torch.no_grad():
        with pytest.raises(ValueError, match=r"fused_ln_qkv bf16 .*head dim 32"):
            run(torch.bfloat16)
        run(torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,grid,tail,variant", [
    (64, 14, 0, "hybrid"), (32, 14, 0, "hybrid"), (3, 14, 5, "noise_aware"),
    (5, 7, 3, "freq_enhanced"), (1, 14, 0, "baseline")])
def test_fused_mona_bf16_at_path_and_ragged_shapes(cuda, b, grid, tail, variant):
    """K12 in bf16 (its products on wgmma) at the bench step's [64, 197,
    768], the supervised step's [32, 197, 768] and row counts no tile
    divides (3 * 201, 5 * 53, 197), against its plain version within 3e-2
    * max|ref| (output, dx; parameter gradients against the largest); two
    backward calls bitwise equal, also without dx."""
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    m = _mona(cuda, 768, variant, seed=b + tail)
    n = grid * grid + 1 + tail
    gen = torch.Generator().manual_seed(n + b)
    x = torch.randn(b, n, 768, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(b, n, 768, generator=gen).to(cuda, torch.bfloat16)
    mask = ((torch.rand(b, n, 64, generator=gen) < 0.9).float() / 0.9).to(cuda)
    kw = dict(variant=variant, mask=mask)
    hw = (grid, grid)
    with torch.no_grad():
        out, saved = fm.mona_block_fused_forward(m, x, hw, **kw)
        ref = fm.mona_block_fused_plain(m, x, hw, **kw)
        dx, grads = fm.mona_block_fused_backward(m, x, hw, g, saved, **kw)
        dx2, grads2 = fm.mona_block_fused_backward(m, x, hw, g, saved, **kw)
        none, grads3 = fm.mona_block_fused_backward(m, x, hw, g, saved, need_dx=False, **kw)
        want_dx, want = fm.mona_block_fused_backward_plain(m, x, hw, g, **kw)
    torch.cuda.synchronize()
    for got, r in ((out, ref), (dx, want_dx)):
        assert (got.float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item()
    assert none is None and torch.equal(dx, dx2)
    top = max(t.abs().max().item() for t in want.values())
    for k, r in want.items():
        assert torch.equal(grads[k], grads2[k]) and torch.equal(grads[k], grads3[k]), k
        diff = (grads[k] - r).abs().max().item()
        assert diff <= 3e-2 * top, f"{k}: {diff:.3e} > 3e-2 * {top:.3e}"


def test_fused_mona_bf16_refuses_widths_its_kernels_do_not_take(cuda):
    """K12's bf16 LayerNorm backward stages 16 rows of the width in shared
    memory: a bf16 width above 1536 raises and names the limit, before any
    launch; float32 (the SIMT kernels) is not held to it."""
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    m = _mona(cuda, 1600, "baseline", seed=1)
    x = torch.randn(2, 17, 1600, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match=r"mona_block_fused.*bf16 width 1600"):
            fm.mona_block_fused_forward(m, x.to(torch.bfloat16), (4, 4), variant="baseline")
        fm.mona_block_fused_forward(m, x, (4, 4), variant="baseline")
    torch.cuda.synchronize()


def test_bf16_k5_k12_reach_no_wmma_or_simt_product(cuda):
    """A bf16 K5 pre-norm call (forward, dx backward) and a bf16 K12 call
    (forward, full backward) run every product on wgmma: the profiler sees
    hopper::gemm_kernel (and K12's mona_wgrad_kernel), no WMMA GEMM
    (gemm_bf16), no colgemm_kernel and no mona_down_kernel."""
    from nextgen_uia_tpu_torch.ops import fused_ln_qkv
    from nextgen_uia_tpu_torch.ops import fused_mona as fm

    bf16 = torch.bfloat16
    blk = _block(cuda, 768, 12)
    mona = _mona(cuda, 768, "hybrid", seed=2)
    gen = torch.Generator().manual_seed(5)
    x, g = (torch.randn(4, 197, 768, generator=gen).to(cuda, bf16) for _ in range(2))
    dy = [torch.randn(4, 12, 197, 64, generator=gen).to(cuda, bf16) for _ in range(3)]
    gamma, _, w_qkv, _ = fused_ln_qkv._weights(blk.ln1, blk.attn, bf16)
    with torch.no_grad():
        _, saved = fm.mona_block_fused_forward(mona, x, (14, 14), variant="hybrid")
    calls = {
        "K5 forward": lambda: fused_ln_qkv.fused_ln_qkv(x, blk.ln1, blk.attn, heads=12),
        "K5 backward": lambda: fused_ln_qkv.fused_ln_qkv_backward(x, gamma, w_qkv, *dy),
        "K12 forward": lambda: fm.mona_block_fused_forward(mona, x, (14, 14), variant="hybrid"),
        "K12 backward": lambda: fm.mona_block_fused_backward(mona, x, (14, 14), g, saved,
                                                             variant="hybrid")}
    with torch.no_grad():
        for what, fn in calls.items():
            expect = ("hopper::gemm_kernel",) + (
                ("mona_wgrad_kernel",) if what == "K12 backward" else ())
            _device_kernel_names(fn, what, expect,
                                 ("gemm_bf16", "colgemm_kernel", "mona_down_kernel"))
