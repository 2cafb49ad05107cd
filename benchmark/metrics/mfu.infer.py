"""The whole batch's share of the card's peak: its counted operations at the
peak of their precision, over the wall time per batch of the traced run's
untraced window."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.mfu(ctx, "infer")
