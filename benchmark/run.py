"""The port's benchmark: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell on one CUDA card from the seed, warms up the cell's own
shapes (set-up, ``setup_s``: process start to the first timed step), runs
the cell's traffic for ``--seconds``, reads the peak memory, frees the
program and checks what the timed path produced against the plain float32
reference, then prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``;
with ``--trace 1`` its per-layer metrics, read from a window as long as the
untraced one and then a short profiled window), ``device``, ``breakdown``
(traced runs) and, last, ``checks``: each compared number beside its limit.

It exits with another code than 0 and prints no result when there is no
CUDA card, when the port is missing, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def _card_note(device) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "clocks.max.sm,temperature.gpu", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _trace(run, w: dict, device) -> dict:
    """A profiled window of whole steps (one untimed step first, so the
    profiler's start-up stays out): busy seconds, launches, the top device
    operations and idle gaps."""
    import torch

    from benchmark import harness as H

    per = w["elapsed"] / w["n"]
    n = max(3, math.ceil(run.traffic["trace_seconds"] / per))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="benchmark_trace_") as d:
        path = os.path.join(d, "trace.json")
        sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched,
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            run.traced_steps(1)
            _sync(device)
            prof.step()
            t0 = time.perf_counter()
            for i in range(n):
                run.traced_steps(1)
                if i == n - 1:
                    _sync(device)
                    t1 = time.perf_counter()
                prof.step()
        summary = H.summarize_trace(H.read_trace(path), n)
    summary["window_s"] = t1 - t0
    return summary


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(cell, seed: int, seconds: float, device, sizes: dict, *, program=None,
          trace: bool = False, judge: str = "check") -> dict:
    """The one sequence of a run, from the build to the comparison: the
    configuration's precision (PyTorch's defaults: cuDNN TF32 on, matmul
    TF32 off), the cell's mode built and warmed up (``program``: a built
    program object, with a fault planted), the window, the profiled window
    (``trace``), the device's readings, the program freed, then the
    reference (TF32 off) judging what the program produced (``judge``
    'check'), or the reference at the control's precision ('control') or at
    a witness's (its name) in the program's place."""
    import torch

    from benchmark import harness as H

    mode = cell.module("modes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = bool(sizes.get("cudnn_tf32", True))
    t_run = time.perf_counter()
    run = mode.Run(cell, seed, device, sizes, program=program)
    # Set-up's objects are moved out of the collector's reach, so that a full
    # collection in the window walks only what the window made.
    gc.collect()
    gc.freeze()
    _sync(device)
    t_ready = time.perf_counter()
    try:
        w = run.window(seconds)
        traced = _trace(run, w, device) if trace else None
    finally:
        gc.unfreeze()
    if device.type == "cuda":
        dev, note = H.device_info(device), _card_note(device)
    else:
        dev = {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        note = "cpu"
    run.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    if judge == "check":
        numbers = run.check()
    elif judge == "control":
        numbers = run.control()
    else:
        numbers = run.witness(judge)
    return {"mode": mode, "run": run, "window": w, "traced": traced, "device": dev,
            "card": note, "numbers": numbers, "t_run": t_run, "t_ready": t_ready,
            "check_s": time.perf_counter() - t_check}


def main(argv=None, *, device=None, overrides=None, program=None) -> int:
    """One run. ``device``, ``overrides`` (sizes replacing the
    configuration's) and ``program`` (a built program object, with a fault
    planted) serve the harness's own tests on the CPU; the command line
    passes none of them."""
    args = parse(argv)
    try:
        from benchmark import harness as H
        H.env_for_caches()
        import torch
        t_torch = time.perf_counter()
        cell = H.Cell(args.workload)
        cell.module("modes")
        cell.module("programs")  # the port: a checkout without it stops here
        t_port = time.perf_counter()
    except ImportError as e:
        print(f"benchmark: cannot load the cell's modules: {e}", file=sys.stderr)
        return 3
    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: {cell.name} needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        _sync(device)

    sizes = {**cell.config, **(overrides or {})}
    r = drive(cell, args.seed, args.seconds, device, sizes, program=program,
              trace=bool(args.trace))
    run, w, traced, dev, numbers = r["run"], r["window"], r["traced"], r["device"], r["numbers"]
    setup_s = r["t_ready"] - T0
    phases = {"import_torch_s": t_torch - T0, "import_port_s": t_port - t_torch,
              "cuda_init_s": r["t_run"] - t_port, **run.setup_phases}
    correct = H.judge(numbers, cell.limits)

    found = H.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 4

    if args.trace:
        ctx = {"kind": r["mode"].KIND, "window": w, "trace": traced,
               "peaks": H.peaks_for(dev["kind"]),
               "work": cell.module("counts").work(sizes, cell.traffic, r["mode"].KIND)}
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    else:
        e2e = run.end_to_end(w)
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]][0], "unit": m["unit"]}

    host = sorted(w["host"])
    info = {"cell": cell.name, "seed": args.seed, "card": r["card"], "setup_s": setup_s,
            "setup_phases": phases, "window_s": w["elapsed"], "steps": w["n"],
            "host_ms_quartiles": [1e3 * q for q in statistics.quantiles(host, n=4)]
            if len(host) > 1 else None, "host_ms_max": 1e3 * host[-1],
            "check_s": r["check_s"], "latency": getattr(run, "latency_note", None),
            "numbers": numbers, "detail": getattr(run, "detail", None)}
    if traced:
        info["traced_steps"] = traced["steps"]
        info["launches"] = traced["launches"]
    print(json.dumps(info, default=str))
    checks = H.print_limits(numbers, cell.limits)
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
