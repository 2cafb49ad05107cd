"""Profiling hooks (counterpart of nextgen_uia_tpu/core/profiling.py):
torch.profiler trace capture around a window, named regions that show in
the trace viewer, a completion barrier, and a per-step timer that reads
CUDA events on a CUDA device and the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a torch.profiler trace of the block (the CPU, and CUDA when
    the host has it) and write it into ``logdir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, which Perfetto and chrome://tracing open);
    a no-op when ``logdir`` is None or empty."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logging.info(f"torch.profiler trace -> {path}")


def annotate(name: str):
    """Named region for the trace viewer (a context manager or decorator)."""
    return torch.profiler.record_function(name)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    values = x.values() if isinstance(x, dict) else x
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def force_completion(x) -> float:
    """Wait for the device of the first tensor in ``x`` (a tensor, or a
    dict, list or tuple of them) and return that tensor's first element."""
    t = _first_tensor(x)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


class StepTimer:
    """Steady-state step timing with warmup exclusion: CUDA events around
    the step on a CUDA ``device`` (device time of the stream's work between
    ``start`` and ``stop``), the host clock otherwise."""

    def __init__(self, warmup: int = 3, device=None):
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0
        self._last = None
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def start(self):
        if self._cuda:
            self._last = torch.cuda.Event(enable_timing=True)
            self._last.record()
        else:
            self._last = time.perf_counter()

    def stop(self, result=None):
        """Seconds since ``start``, after ``result`` (if given) is done."""
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._last.elapsed_time(end) / 1e3
        else:
            if result is not None:
                force_completion(result)
            dt = time.perf_counter() - self._last
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.times) * 1e3) if self.times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        if not self.times:
            return float("nan")
        return items_per_step / float(np.mean(self.times))
