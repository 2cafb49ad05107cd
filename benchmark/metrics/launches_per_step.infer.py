"""Device kernels launched per batch, counted in the profiler's trace of the traced
window (whole batches only)."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.launches(ctx, "infer")
