"""The least time the card could take for one batch's counted work (per operation
the larger of its operations over the peak of its precision and its bytes
over the memory's bandwidth; counts/<config>.py), over the card's busy time
per batch (the union of kernel intervals in the traced window)."""

from benchmark.metrics import _layers


def read(ctx):
    return _layers.kernel_roofline_pct(ctx, "infer")
