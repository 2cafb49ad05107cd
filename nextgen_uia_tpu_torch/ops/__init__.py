"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``KERNELS`` is the set of block ops the models call: on a CUDA tensor each
launches its kernel (forward, and backward through autograd), on a CPU
tensor it runs its plain versions. ``PLAIN`` runs the same math through the
plain forwards on any device, differentiated by autograd; it is what a
reference run on the card compares against (it launches no kernel and
counts nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

# modules, not their functions: fused_ln_qkv is both a module and its op
from . import dwconv, flash_attention, fused_attention, fused_attn_o, fused_block, fused_ln_mlp
from . import fused_ln_qkv, fused_mlp, fused_mona, lut


@dataclasses.dataclass(frozen=True)
class BlockOps:
    fused_block_infer: Callable
    mona_spatial: Callable
    fused_ln_qkv: Callable
    fused_attn_o_residual: Callable
    fused_ln_mlp_residual: Callable
    fused_postnorm_mlp_ln: Callable
    flash_attention: Callable
    fused_mlp: Callable
    equalize: Callable  # in place: (x, idx) -> x
    mona_block_fused: Callable
    fused_attn_block: Callable
    hybrid_attn_block: Callable


KERNELS = BlockOps(fused_block.fused_block_infer, dwconv.mona_spatial,
                   fused_ln_qkv.fused_ln_qkv, fused_attn_o.fused_attn_o_residual,
                   fused_ln_mlp.fused_ln_mlp_residual, fused_ln_mlp.fused_postnorm_mlp_ln,
                   flash_attention.flash_attention,
                   fused_mlp.fused_mlp, lut.equalize_,
                   fused_mona.mona_block_fused, fused_attention.fused_attn_block,
                   fused_attention.hybrid_attn_block)
PLAIN = BlockOps(fused_block.fused_block_infer_plain, dwconv.mona_spatial_plain,
                 fused_ln_qkv.fused_ln_qkv_plain, fused_attn_o.fused_attn_o_residual_plain,
                 fused_ln_mlp.fused_ln_mlp_residual_plain,
                 fused_ln_mlp.fused_postnorm_mlp_ln_plain, flash_attention.flash_attention_plain,
                 fused_mlp.fused_mlp_plain, lut.equalize_plain,
                 fused_mona.mona_block_fused_plain,
                 fused_attention.fused_attn_block_plain, fused_attention.hybrid_attn_block_plain)
