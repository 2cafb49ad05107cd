"""``correct`` comes out false for the control and for each fault a cell can
have, each planted under a run at a tiny size on the CPU (the look for a
card skipped); a sound run comes out true."""

from __future__ import annotations

import pytest
import torch

from benchmark import faults as F
from benchmark.tests import harness_tiny as T

TRAIN = ["biomedclip_mona.finetune_b256", "dinov2_seg.train_b24"]
INFER = ["biomedclip_mona.zeroshot_b256", "dinov2_seg.predict_b24"]
CASES = ([(c, f) for c in TRAIN for f in ("unchanged", "half_batch")]
         + [(c, f) for c in INFER for f in ("half_batch", "altered_answer")])


@pytest.mark.parametrize("cell", TRAIN + INFER)
def test_sound_run_correct(cell):
    rc, line = T.run_cell(cell)
    assert rc == 0 and line["correct"] is True, line


@pytest.mark.parametrize("cell", TRAIN + INFER)
def test_traced_run_reports_its_keys(cell):
    rc, line = T.run_cell(cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails(cell, fault):
    _, prog = T.build(cell)
    rc, line = T.run_cell(cell, program=F.FAULTS[fault](prog))
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", TRAIN + INFER)
def test_control_separates(cell):
    """At a tiny size the control (the reference one precision step lower in
    the program's place) reads at least three times what the program does
    on one of the cell's numbers; at the cell's own size it fails the
    limits (``test_harness_gpu.py``)."""
    c = T.TinyCell(cell)
    with T.tiny_cells():
        run = c.module("modes").Run(c, T.SEED, torch.device("cpu"), T.sizes(c))
        run.window(0.05)
        run.free()
        sound, control = run.check(), run.control()
    assert any(control[k] >= 3 * max(sound[k], 1e-6) for k in control), (sound, control)
