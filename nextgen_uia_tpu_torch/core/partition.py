"""Flat '/'-joined parameter paths and the trainable/frozen split
(counterpart of nextgen_uia_tpu/core/partition.py).

A module's state-dict key is its JAX flat path with '/' replaced by '.', so
``visual.blocks.3.mona.down.w`` here is ``visual/blocks/3/mona/down/w`` in
the JAX package and in every ``.npz`` checkpoint. Where the JAX package
splits its parameter tree into (trainable, frozen) subtrees, the port marks
each parameter's ``requires_grad`` by the same path predicate.
"""

from __future__ import annotations

from typing import Callable

import torch


def path_str(key: str) -> str:
    """State-dict key -> JAX flat path."""
    return key.replace(".", "/")


def flatten_with_paths(module: torch.nn.Module):
    """[(flat path, tensor)] over every parameter and buffer of ``module``."""
    return [(path_str(k), v) for k, v in module.state_dict().items()]


def by_keywords(*keywords: str) -> Callable[[str], bool]:
    """Predicate matching any path containing one of the (lowercased)
    keywords - the reference's ``"mona" in name.lower()`` convention."""
    kws = tuple(k.lower() for k in keywords)
    return lambda path: any(k in path.lower() for k in kws)


def partition(module: torch.nn.Module, predicate: Callable[[str], bool]):
    """Mark every parameter of ``module`` trainable (``requires_grad``) when
    ``predicate`` holds for its flat path, frozen otherwise, in place.
    Returns (trainable, frozen): flat path -> parameter, in module order."""
    trainable, frozen = {}, {}
    for key, p in module.named_parameters():
        path = path_str(key)
        p.requires_grad_(predicate(path))
        (trainable if p.requires_grad else frozen)[path] = p
    return trainable, frozen
