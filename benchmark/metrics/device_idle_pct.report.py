"""The share of the profiled reports' window in which no operation ran
on the device."""

from benchmark.metrics import _common


def read(ctx):
    if ctx.get("kind") != "report":
        return None
    return _common.idle_pct(ctx)
