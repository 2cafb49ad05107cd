"""Component-scoped checkpoints: the weight bridge to the JAX package.

Same format as nextgen_uia_tpu/core/checkpoint.py: one ``.npz`` of
'/'-joined path -> array, loaded by name-intersection merge. Because a
module's state-dict keys are the JAX paths with '.' for '/', a file written
by either package loads into the other with a rename and a dtype/device cast
and no transposes. Full train states for ``--resume`` are the port's own
layout (``save_train_state``/``load_train_state``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .partition import flatten_with_paths, path_str


def save(path: str, module: torch.nn.Module, *, keyword_filter=None) -> int:
    """Save (optionally keyword-filtered) parameters; returns count saved."""
    flat = dict(flatten_with_paths(module))
    if keyword_filter:
        kws = [k.lower() for k in keyword_filter]
        flat = {p: v for p, v in flat.items() if any(k in p.lower() for k in kws)}
    return save_flat(path, flat)


def save_flat(path: str, flat: dict) -> int:
    """Save a flat path -> tensor dict as the JAX package's .npz."""
    arrays = {p: v.detach().cpu().numpy() for p, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return len(arrays)


class NoMatch(ValueError):
    """Checkpoint/template name intersection is empty (distinct from the
    shape-mismatch ValueError, so callers can retry another root)."""


def peek_keys(path: str) -> list[str]:
    """Names stored in a .npz checkpoint without loading the arrays."""
    with np.load(path) as data:
        return list(data.files)


def load_flat(path: str) -> dict:
    """Read a .npz checkpoint into a flat path -> array dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@torch.no_grad()
def merge_flat(saved: dict, module: torch.nn.Module, *, source: str = "checkpoint",
               skip=()):
    """Name-intersection merge of a flat path -> array dict into ``module``,
    in place (each matched tensor is copied into, cast to its dtype and
    device). ``skip``: path prefixes left at their current values.

    Returns (module, loaded_count); raises NoMatch if nothing matched and
    ValueError on a shape mismatch.
    """
    n = 0
    for key, t in module.state_dict().items():
        name = path_str(key)
        if name not in saved or any(name.startswith(s) for s in skip):
            continue
        arr = saved[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"Shape mismatch for {name}: ckpt {arr.shape} "
                             f"vs model {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.asarray(arr)))
        n += 1
    if n == 0:
        raise NoMatch(f"No parameters from {source} matched the model tree")
    return module, n


def load_into(path: str, module: torch.nn.Module, *, skip=()):
    """Name-intersection merge of a saved checkpoint into ``module``.

    Returns (module, loaded_count); raises NoMatch if nothing matched.
    """
    return merge_flat(load_flat(path), module, source=path, skip=skip)


def save_train_state(path: str, flat: dict, extra: dict | None = None) -> int:
    """Atomic full-state save of a flat path -> array dict (parameters,
    optimizer moments, counters); ``extra`` holds host scalars (epoch,
    best...). ``extra`` rides inside the .npz (key ``__meta__``), so the
    state and its position publish in one os.replace, as in the JAX
    package; a .meta.json copy is written afterwards for inspection."""
    import json

    flat = {k: np.asarray(v) for k, v in flat.items()}
    if extra is not None:
        flat["__meta__"] = np.array(json.dumps(extra))
    tmp = path + ".tmp.npz"  # explicit .npz so np.savez does not append one
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    return len(flat) - (1 if extra is not None else 0)


def load_train_state(path: str):
    """(flat path -> array dict, extra dict) of a file save_train_state wrote."""
    import json

    saved = load_flat(path)
    meta = saved.pop("__meta__", None)
    return saved, ({} if meta is None else json.loads(str(meta.item())))
