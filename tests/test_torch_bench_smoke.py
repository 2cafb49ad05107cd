"""Smoke test of the port's bench (``python -m nextgen_uia_tpu_torch.bench``)
on the CPU at toy size, once per MONA route.

A regression in the bench would void the number a chip run reports, so the
step runs end to end here with NEXTGEN_UIA_BENCH_* shrunk to seconds of CPU
work (depth 1, 32 px, float32, one warm-up and one step per window) and
``device="cpu"``. The rate is not asserted (a CPU time says nothing about
the card); the one JSON line and its four keys are.
"""

import json

import pytest

from nextgen_uia_tpu_torch import bench
from nextgen_uia_tpu_torch.ops import fused_mona

SMOKE_ENV = {"NEXTGEN_UIA_BENCH_BATCH": "4", "NEXTGEN_UIA_BENCH_STEPS": "1",
             "NEXTGEN_UIA_BENCH_WARMUP": "1", "NEXTGEN_UIA_BENCH_DEPTH": "1",
             "NEXTGEN_UIA_BENCH_IMG": "32", "NEXTGEN_UIA_BENCH_DTYPE": "float32"}


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_bench_prints_one_json_line(monkeypatch, capsys, fused):
    for k, v in SMOKE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("NEXTGEN_UIA_FUSED_MONA", "1" if fused else "0")
    calls = []
    core = fused_mona._forward_core
    monkeypatch.setattr(fused_mona, "_forward_core", lambda *a: calls.append(1) or core(*a))
    bench.main(device="cpu")
    assert bool(calls) == fused  # the fused route ran K12's plain version on the CPU
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "BUSI Mona fine-tune images/sec/chip"
    assert rec["unit"] == "images/sec/chip" and rec["value"] > 0 and rec["vs_baseline"] >= 0
    assert ("fused" in captured.err) == fused and "cpu" in captured.err
    assert fused_mona.mona_block_fused.launches == 0  # the CPU launches no kernel


@pytest.mark.parametrize("mode", ["SUPERVISED", "EVAL", "INPUT"])
def test_bench_refuses_unported_modes(monkeypatch, mode):
    monkeypatch.setenv(f"NEXTGEN_UIA_BENCH_{mode}", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section A, item 16"):
        bench.main(device="cpu")


def test_bench_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
