"""One minus the union of kernel intervals over the profiled window's
length, in percent."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.device_idle_pct(ctx, "infer")
