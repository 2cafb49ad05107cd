"""Shared machinery of the benchmark: finding a cell's files by name, making
weights and inputs from the seed, reading the profiler's trace, and the
comparison that decides ``correct``.

Layout (every name is the one ``BENCHMARK.json`` uses):

- ``configs/<config>.json``: the model's sizes as run, its source and cuts;
- ``programs/<config>.py``: builds the port's objects for the configuration
  (the system under test, its entry points, the weights loaded through the
  port's own modules);
- ``reference/<config>.py``: the plain float32 reference and the parameter
  spec the weights are drawn from; it imports nothing of the port;
- ``counts/<config>.py``: the operations and bytes of one step or batch;
- ``traffic/<traffic>.json``: the traffic mix, read by ``modes/<mode>.py``;
- ``workloads/<cell>.json``: the cell's correctness limits and the readings
  they were set from;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``peaks.json``: the card's published peaks.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# modules that must never be loaded by a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "nextgen_uia_tpu")


def read_json(path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def load_file(path: Path, name: str):
    """A module loaded from a file path (metric readers carry dots in their
    names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything a run of one cell needs, found by name."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or benchmark_spec()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        self.config_name = self.entry["config"]
        conf = {c["name"]: c for c in spec["configs"]}[self.config_name]
        self.config = read_json(REPO / conf["file"])
        self.traffic_name = self.entry["traffic"]
        self.traffic = read_json(ROOT / "traffic" / f"{self.traffic_name}.json")
        self.workload = read_json(ROOT / "workloads" / f"{name}.json")
        self.limits = self.workload["limits"]
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]

    def module(self, kind: str):
        """``<kind>/<config>.py`` (programs, reference, counts) or
        ``modes/<mode>.py``."""
        key = self.traffic["mode"] if kind == "modes" else self.config_name
        return importlib.import_module(f"benchmark.{kind}.{key}")

    def reader(self, metric: str):
        return load_file(ROOT / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}")


def sub_seed(seed: int, k: int) -> int:
    """An independent 63-bit seed for stream ``k`` of a run's seed."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407 * (k + 1)) % (2 ** 63)


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, k))


def make_weights(spec, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for each (name, shape, init) of
    ``spec``, drawn from the seed in two large calls (one uniform, one
    normal buffer) and shaped per tensor. ``init``: ('zeros',), ('ones',),
    ('const', v), ('uniform', lo, hi) or ('normal', std)."""
    gen = generator(seed, 0, device)
    numel = lambda shape: math.prod(shape)  # noqa: E731
    n_u = sum(numel(s) for _, s, i in spec if i[0] == "uniform")
    n_n = sum(numel(s) for _, s, i in spec if i[0] == "normal")
    u = torch.rand(n_u, generator=gen, device=device)
    z = torch.randn(n_n, generator=gen, device=device)
    out, ou, on = {}, 0, 0
    for name, shape, init in spec:
        n = numel(shape)
        if init[0] == "uniform":
            t = u[ou:ou + n].view(shape).mul_(init[2] - init[1]).add_(init[1])
            ou += n
        elif init[0] == "normal":
            t = z[on:on + n].view(shape).mul_(init[1])
            on += n
        else:
            value = {"zeros": 0.0, "ones": 1.0}.get(init[0], init[-1])
            t = torch.full(shape, float(value), device=device)
        out[name] = t
    return out


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def device_info(device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def round_off_leaves(grad: dict, below: float = 1e-3) -> set:
    """Leaves whose reference gradient is nought to rounding (under
    ``below`` of the median leaf's norm), such as a bias just before a
    normalisation: Adam moves them by round-off alone."""
    norms = leaf_norms(grad)
    med = statistics.median(norms.values())
    return {k for k, v in norms.items() if v < below * med}


def norm_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """Per leaf, the gap between the program's norm and the reference's over
    max(the reference's norm of that leaf, the median leaf's), leaves in
    ``skip`` left out."""
    norms = {k: v for k, v in leaf_norms(ref).items() if k not in skip}
    med = statistics.median(norms.values())
    out = {}
    for k, r in norms.items():
        p = float(torch.linalg.vector_norm(prog[k].double()))
        out[k] = abs(p - r) / max(r, med) if math.isfinite(p) else math.inf
    return out


def worst_and_median(gaps: dict) -> tuple:
    """(the worst gap, its leaf, the median leaf's gap); a NaN reads inf."""
    vals = {k: (v if v == v else math.inf) for k, v in gaps.items()}
    leaf = max(vals, key=vals.get)
    return vals[leaf], leaf, statistics.median(vals.values())


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number within its limit (a NaN or a missing number
    fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def print_limits(numbers: dict, limits: dict) -> dict:
    """The compared numbers beside their limits, as the last lines on
    standard error; returns them for the result's last key."""
    out = {}
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        out[k] = {"value": v, "limit": lim}
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------


def read_trace(path: str) -> dict:
    """Kernels [(start_us, end_us, name)] and host annotations
    [(start_us, end_us, name)] of a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
        elif cat == "user_annotation":
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    kernels.sort()
    return {"kernels": kernels, "ranges": ranges}


def union_intervals(kernels):
    """Merged [(start, end)] of the kernels' intervals."""
    merged = []
    for s, e, _ in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize_trace(trace: dict, n_steps: int) -> dict:
    """Busy seconds (the union of kernel intervals), launches, the device
    operations that took most time and the longest idle gaps between the
    first and last kernel, each named by the innermost host range open at
    the gap's start."""
    kernels, ranges = trace["kernels"], trace["ranges"]
    merged = union_intervals(kernels)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)
    named = []
    for dur, at in gaps[:10]:
        open_ = [r for r in ranges if r[0] <= at < r[1]]
        name = min(open_, key=lambda r: r[1] - r[0])[2] if open_ else "no host range"
        named.append([name, dur * 1e-6])
    return {"busy_s": busy_us * 1e-6, "launches": len(kernels), "steps": n_steps,
            "device_ops": [[n, t * 1e-6] for n, t in top], "idle_gaps": named}


def peaks_for(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (peaks.json), or None
    where the table has no entry for it."""
    table = read_json(ROOT / "peaks.json")
    for key, val in table.items():
        if key != "_source" and key in kind:
            return val
    return None


def least_seconds(work, peaks: dict) -> tuple:
    """(least seconds for the counted work: per operation the larger of
    operations over the peak of its precision and bytes over the memory's
    bandwidth, summed; seconds of the operations alone at their peaks)."""
    least, compute = 0.0, 0.0
    for _, flops, nbytes, prec in work:
        t_c = flops / peaks[prec] if flops else 0.0
        least += max(t_c, nbytes / peaks["bytes_per_s"])
        compute += t_c
    return least, compute


def env_for_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only the first run of a cell there builds; set before torch loads
    anything that reads them."""
    build = REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
