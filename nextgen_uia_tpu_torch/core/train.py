"""Training/eval helpers (counterpart of nextgen_uia_tpu/core/train.py).
The serving slice needs only the ragged-batch padding; the training step
comes with the fine-tune slice."""

from __future__ import annotations

import numpy as np


def pad_eval_batch(batch: dict, multiple: int):
    """Host-side: pad array leaves' leading dim up to a multiple of
    ``multiple`` by repeating the last row (finite values keep softmax
    well-behaved); non-array leaves pass through. Returns (batch, n_real);
    slice every output back to n_real."""

    def is_arr(v):
        return hasattr(v, "shape") and hasattr(v, "dtype") and getattr(v, "ndim", 0) >= 1

    n = next(v.shape[0] for v in batch.values() if is_arr(v))
    if multiple <= 1 or n % multiple == 0:
        return batch, n
    pad = multiple - n % multiple
    out = {}
    for k, v in batch.items():
        if is_arr(v):
            a = np.asarray(v)
            out[k] = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        else:
            out[k] = v
    return out, n
