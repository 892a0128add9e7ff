"""The report path's Shift-GCN kernel ops (K1, K4) of the profiled
reports, four streams each, counted from the model's shapes at each
report's window count: their bound time over the device time of the
kernels that ``kernel_names/`` assigns to them."""

from benchmark import costs
from benchmark.metrics import _common


def read(ctx):
    if ctx.get("kind") != "report" or _common.profile(ctx) is None:
        return None
    ops = [op for w in ctx["profiled_windows"]
           for op in costs.ops(ctx["config"], w, 4, False)] * 4
    return _common.roofline_pct(dict(ctx, dtype=ctx["config"]["serve_dtype"]),
                                ops, ("K1", "K4"))
