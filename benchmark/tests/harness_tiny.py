"""Tiny sizes for driving the harness on the CPU: the configurations' shapes
cut (widths too, which no cell may do: these sizes exist only here), and
float32 compute, so that a sound run reads well inside the limits set for
bf16 at the cells' own sizes and a planted fault stands out."""

from __future__ import annotations

import contextlib
import io
import json

import torch

from benchmark import harness as H
from benchmark import run

SIZES = {
    "biomedclip_mona": {"depth": 2, "text_depth": 1, "image_size": 32, "width": 64, "heads": 4,
                        "mlp_dim": 256, "embed_dim": 32, "text_width": 64, "text_heads": 4,
                        "text_intermediate": 128, "context_length": 16, "mona_bottleneck": 16,
                        "compute_dtype": "float32"},
    "dinov2_seg": {"debug_tiny": True, "width": 64, "depth": 5, "heads": 4, "mlp_dim": 256,
                   "compute_dtype": "float32"},
}
TRAFFIC = {"biomedclip_mona": {"batch": 4, "pool": 4, "trace_seconds": 0.1},
           "dinov2_seg": {"batch": 2, "pool": 4, "trace_seconds": 0.1}}
SEED = 2 ** 31 + 12345


class TinyCell(H.Cell):
    def __init__(self, name, spec=None):
        super().__init__(name, spec)
        self.traffic = {**self.traffic, **TRAFFIC[self.config_name]}


def sizes(cell) -> dict:
    return {**cell.config, **SIZES[cell.config_name]}


@contextlib.contextmanager
def tiny_cells():
    orig = H.Cell
    H.Cell = TinyCell
    try:
        yield
    finally:
        H.Cell = orig


def run_cell(name, *, trace=0, seconds=0.3, program=None, seed=SEED):
    """One whole run on the CPU at tiny sizes; (exit code, last JSON line)."""
    cell = TinyCell(name)
    out = io.StringIO()
    with tiny_cells(), contextlib.redirect_stdout(out):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"),
                      overrides=SIZES[cell.config_name], program=program)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def build(name, seed=SEED):
    """(cell, built program) at tiny sizes on the CPU."""
    cell = TinyCell(name)
    mode = cell.module("modes")
    mod = cell.module("programs")
    cls = mod.Train if mode.KIND == "train" else mod.Infer
    return cell, cls(sizes(cell), cell.traffic, seed, torch.device("cpu"))
