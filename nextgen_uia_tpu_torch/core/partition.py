"""Flat '/'-joined parameter paths (counterpart of nextgen_uia_tpu/core/partition.py).

A module's state-dict key is its JAX flat path with '/' replaced by '.', so
``visual.blocks.3.mona.down.w`` here is ``visual/blocks/3/mona/down/w`` in
the JAX package and in every ``.npz`` checkpoint.
"""

from __future__ import annotations

import torch


def path_str(key: str) -> str:
    """State-dict key -> JAX flat path."""
    return key.replace(".", "/")


def flatten_with_paths(module: torch.nn.Module):
    """[(flat path, tensor)] over every parameter and buffer of ``module``."""
    return [(path_str(k), v) for k, v in module.state_dict().items()]
