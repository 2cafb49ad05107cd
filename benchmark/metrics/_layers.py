"""The arithmetic the per-layer readers share. ``ctx``: 'kind' ('train' or
'infer'), 'window' (the untraced window of the traced run: steps 'n',
'elapsed' seconds, 'host' seconds inside each call), 'trace' (the profiled
window: 'busy_s', 'launches', 'steps', 'window_s'), 'work' (the counted
operations of one step or batch) and 'peaks' (the card's, or None). A
reader that finds nothing to read returns None."""

from __future__ import annotations

from benchmark import harness as H


def host_ms(ctx, kind):
    if ctx["kind"] != kind or not ctx["window"]["host"]:
        return None
    host = ctx["window"]["host"]
    return 1e3 * sum(host) / len(host)


def launches(ctx, kind):
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or not t["launches"]:
        return None
    return t["launches"] / t["steps"]


def kernel_roofline_pct(ctx, kind):
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or t["busy_s"] <= 0 or not ctx["peaks"]:
        return None
    least, _ = H.least_seconds(ctx["work"], ctx["peaks"])
    return 100.0 * least / (t["busy_s"] / t["steps"])


def device_idle_pct(ctx, kind):
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx, kind):
    w, t = ctx["window"], ctx["trace"]
    if ctx["kind"] != kind or not t or t["busy_s"] <= 0 or not ctx["peaks"]:
        return None
    _, compute = H.least_seconds(ctx["work"], ctx["peaks"])
    return 100.0 * compute / (w["elapsed"] / w["n"])
