"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``KERNELS`` is the serving path's set of block ops; ``PLAIN`` runs the same
math through the plain versions on any device and is what a reference run
on the card compares against (it launches no kernel and counts nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .dwconv import mona_spatial, mona_spatial_plain
from .fused_block import fused_block_infer, fused_block_infer_plain


@dataclasses.dataclass(frozen=True)
class BlockOps:
    fused_block_infer: Callable
    mona_spatial: Callable


KERNELS = BlockOps(fused_block_infer, mona_spatial)
PLAIN = BlockOps(fused_block_infer_plain, mona_spatial_plain)
