"""The count functions reproduce the kernel table's bounds from shapes."""

from __future__ import annotations

import pytest

from benchmark import harness as H
from benchmark.counts import biomedclip_mona as CB
from benchmark.counts import dinov2_seg as CD

PEAKS = H.read_json(H.ROOT / "peaks.json")["H100"]


def test_k8_forward_bound_at_64_197_768():
    """PERF.md's K8 forward bound at [64, 197, 768]: 0.1203 ms (ops)."""
    k8 = next(op for op in CB._block_fwd(64, 197, 768, 12, 3072) if op[0] == "mlp_block")
    least, _ = H.least_seconds([k8], PEAKS)
    assert 1e3 * least == pytest.approx(0.1203, abs=5e-5)


def test_k8_backward_bound_at_64_197_768():
    """PERF.md's K8 backward bound at [64, 197, 768]: 0.1805 ms, which counts
    the hidden's recompute beside the two input gradients (three products,
    where the benchmark's minimal backward counts two)."""
    bwd = next(op for op in CB._block_bwd(64, 197, 768, 12, 3072) if op[0] == "mlp_block_bwd")
    assert 1e3 * 1.5 * bwd[1] / PEAKS["bf16"] == pytest.approx(0.1805, abs=5e-5)


@pytest.mark.parametrize("cell", [w["name"] for w in H.benchmark_spec()["workloads"]])
def test_counts_positive_and_bounded(cell):
    c = H.Cell(cell)
    kind = c.module("modes").KIND
    work = c.module("counts").work(c.config, c.traffic, kind)
    least, compute = H.least_seconds(work, PEAKS)
    assert 0 < compute <= least
    assert all(f >= 0 and b > 0 and p in PEAKS for _, f, b, p in work)


def test_decoder_parameters_counted():
    from benchmark.reference import dinov2_seg as R
    s = H.read_json(H.ROOT / "configs" / "dinov2_seg.json")
    n = sum(int(__import__("math").prod(sh)) for name, sh, _ in R.param_spec(s)
            if name.startswith("head."))
    assert CD.n_decoder_params(s) == n
