"""``control.py`` drives each seed through ``run.drive`` and reads what a
run compares: at a tiny size on the CPU, a sound seed reads correct, a
planted fault not, and the control and the witness give every number the
program's reading gives."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from benchmark import control
from benchmark.tests import harness_tiny as T


@pytest.mark.parametrize("cell", ["biomedclip_mona.finetune_b256", "dinov2_seg.train_b24"])
def test_control_readings_on_the_cpu(cell, tmp_path):
    c = T.TinyCell(cell)
    seeds = f"{T.SEED},{T.SEED + 1}"
    argv = ["--workload", cell, "--seeds", str(T.SEED), "--control-seeds", str(T.SEED + 1),
            "--faults", "half_batch", "--seconds", "0.2", "--out", str(tmp_path)]
    if c.config_name == "biomedclip_mona":
        argv += ["--witness", "kernels_bf16,bf16", "--witness-seeds", seeds]
    out = io.StringIO()
    with T.tiny_cells(), contextlib.redirect_stdout(out):
        assert control.main(argv, device=torch.device("cpu"), overrides=T.SIZES[c.config_name]) == 0
    recs = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    kinds = [r["kind"] for r in recs]
    assert kinds[:3] == ["program", "control", "half_batch"]
    assert recs[0]["correct"] is True and recs[2]["correct"] is False
    for r in recs:
        assert set(recs[0]["numbers"]) == set(r["numbers"]), r["kind"]
        assert {"late_loss_gap", "late_grad_gap_median", "late_change_gap_median"} <= set(r["numbers"])
    assert len((tmp_path / f"{cell}.jsonl").read_text().splitlines()) == len(recs)
