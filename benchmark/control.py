"""Readings that set a cell's correctness limits: the numbers ``run.py``
compares, for sound runs of the program over many seeds, for the control
(the reference one precision step below the configuration's, in the
program's place), for faults planted under the program (``faults.py``) and
for witnesses (the reference at a named precision, ``reference.WITNESSES``,
in the program's place), each seed driven through ``run.drive``, the
sequence a benchmark run takes, at the cell's own size, in one process.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch] [--fault-seeds 7,8] \\
        [--witness kernels_bf16 --witness-seeds 1,2] [--set compute_dtype=float32] \\
        [--seconds 2]

``--set`` replaces configuration values for every job of the call (a
number, true, false or a word). One JSON line per reading on standard
output, also appended to ``<cell>.jsonl`` under ``--out`` (default
``chiprun_out/readings``). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def _ints(text):
    return [int(v) for v in text.split(",") if v]


def _setting(text):
    key, _, value = text.partition("=")
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def main(argv=None, *, device=None, overrides=None) -> int:
    """The readings of one call. ``device`` and ``overrides`` (sizes
    replacing the configuration's) serve the harness's own tests on the
    CPU; the command line passes neither."""
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--witness", default="")
    p.add_argument("--witness-seeds", type=_ints, default=[])
    p.add_argument("--set", type=_setting, action="append", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="the readings' directory "
                   "(default chiprun_out/readings)")
    args = p.parse_args(argv)
    from benchmark import faults as FL
    from benchmark import harness as H
    from benchmark import run as RUN
    H.env_for_caches()
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    cuda = device.type == "cuda"
    cell = H.Cell(args.workload)
    mode = cell.module("modes")
    sizes = {**cell.config, **(overrides or {}), **dict(args.set)}
    out_dir = Path(args.out) if args.out else H.REPO / "chiprun_out" / "readings"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [("program", s, None, "check") for s in args.seeds]
    jobs += [("control", s, None, "control") for s in args.control_seeds]
    for f in filter(None, args.faults.split(",")):
        jobs += [(f, s, f, "check") for s in (args.fault_seeds or args.control_seeds)]
    for w in filter(None, args.witness.split(",")):
        jobs += [(f"witness:{w}", s, None, w) for s in args.witness_seeds]
    with open(out_dir / f"{cell.name}.jsonl", "a") as sink:
        for kind, seed, fault, judge in jobs:
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            prog = None
            if fault:
                build = cell.module("programs").Train if mode.KIND == "train" else \
                    cell.module("programs").Infer
                prog = FL.FAULTS[fault](build(sizes, cell.traffic, seed, device))
            r = RUN.drive(cell, seed, args.seconds, device, sizes, program=prog, judge=judge)
            del prog
            numbers, w = r["numbers"], r["window"]
            line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                               "set": dict(args.set), "numbers": numbers,
                               "correct": H.judge(numbers, cell.limits), "steps": w["n"],
                               "window_s": w["elapsed"], "build_s": r["t_ready"] - t0,
                               "check_s": r["check_s"],
                               "peak_bytes": r["device"]["memory_peak_bytes"],
                               "detail": getattr(r["run"], "detail", None)}, default=str)
            print(line, flush=True)
            sink.write(line + "\n")
            sink.flush()
            del r
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
