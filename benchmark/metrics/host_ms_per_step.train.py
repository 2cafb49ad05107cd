"""Host milliseconds inside the harness's call into the task entry, per
train step (TrainStep.__call__): a span on the host clock in the
benchmark's own files, over the untraced window of the traced run."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.host_ms(ctx, "train")
