"""On the card (skipped without one): a cell's run through the command line
comes out correct, and at each cell's own size the control (the reference
one precision step lower in the program's place) comes out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness as H

CELLS = [w["name"] for w in H.benchmark_spec()["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
def test_cell_on_the_card():
    _card()
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", "2147483901", "--seconds", "5", "--trace", "0"],
                         cwd=H.REPO, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    _card()
    res = subprocess.run([sys.executable, "-m", "benchmark.control", "--workload", cell,
                          "--control-seeds", "2147483911,2147483912,2147483913",
                          "--seconds", "2"], cwd=H.REPO, capture_output=True, text=True,
                         timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in res.stdout.strip().splitlines():
        rec = json.loads(line)
        assert rec["kind"] == "control" and rec["correct"] is False, rec
