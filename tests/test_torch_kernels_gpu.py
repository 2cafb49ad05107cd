"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a): a CUDA kernel has no CPU mode,
so here they skip. Run them there with
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``. Tolerances:
float32 inputs, block max|d| <= 1e-4 * max|ref| and spatial op <= 1e-5
(the same float32 math summed in another order); bfloat16 inputs against
the float32 plain version, block max|d| <= 3e-2 at unit scale and spatial op
<= one bf16 ulp at the output's scale.
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
    (2, 17, 128, 2, "gelu"), (3, 197, 128, 4, "quick_gelu"), (2, 256, 768, 12, "gelu")])
def test_fused_block_kernel_matches_plain(cuda, b, n, width, heads, act):
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
        ref_b = fb.fused_block_infer_plain(xb.float(), blk, heads=heads, act=act)
        got_b = fb.fused_block_infer(xb, blk, heads=heads, act=act)
        assert got_b.dtype == torch.bfloat16
        assert (got_b.float() - ref_b).abs().max() <= 3e-2


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
        with pytest.raises(ValueError, match="tokens"):
            fb.fused_block_infer(torch.zeros(1, 300, 128, device=cuda), _block(cuda, 128, 2),
                                 heads=2)


@pytest.mark.parametrize("shape", [(32, 14, 14, 64), (2, 9, 11, 32), (1, 3, 5, 8)])
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
