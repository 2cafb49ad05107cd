"""Device kernels launched per step, counted in the profiler's trace of the traced
window (whole steps only)."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.launches(ctx, "train")
