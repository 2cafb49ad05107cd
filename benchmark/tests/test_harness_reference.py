"""At a tiny size on the CPU, the reference agrees with the port's plain path
(float32 compute, ``harness_tiny.SIZES``) on one step or batch of each mode,
in every number a cell compares."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import harness_tiny as T

CELLS = ["biomedclip_mona.finetune_b256", "dinov2_seg.train_b24",
         "biomedclip_mona.zeroshot_b256", "dinov2_seg.predict_b24"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_plain_path(cell):
    c = T.TinyCell(cell)
    mode = c.module("modes")
    with T.tiny_cells():
        run = mode.Run(c, T.SEED, torch.device("cpu"), T.sizes(c))
        run.window(0.05)
        run.free()
        numbers = run.check()
    bars = {"loss_gap": 1e-5, "grad_gap": 1e-3, "grad_gap_median": 1e-3, "change_gap": 1e-3,
            "change_gap_median": 1e-3, "logit_gap": 1e-4, "logit_rms_gap": 1e-4,
            "map_flips": 0.0}
    bars.update({f"late_{k}": v for k, v in bars.items()})
    # the worst leaf's gradient, of the first steps and of the late step,
    # whether or not a cell compares it
    held = set(c.limits) | ({"grad_gap", "late_grad_gap"} if "loss_gap" in numbers else set())
    for k in held:
        assert numbers[k] <= bars[k], (k, numbers[k], getattr(run, "detail", None))
