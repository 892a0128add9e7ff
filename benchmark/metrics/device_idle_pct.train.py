"""The share of the profiled epoch in which no operation ran on the
device, averaged over the cards."""

from benchmark.metrics import _common


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return _common.idle_pct(ctx)
