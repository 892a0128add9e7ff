"""The Shift-GCN kernel ops of the profiled steps (K1, K2+K3, K4, K5,
K6, counted from the model's shapes for one rank's clips): their bound
time over the device time of the kernels that ``kernel_names/`` assigns
to them."""

from benchmark import costs
from benchmark.metrics import _common


def read(ctx):
    prof = _common.profile(ctx)
    if ctx.get("kind") != "train" or prof is None:
        return None
    itemsize = 2 if ctx["dtype"] == "bfloat16" else 4
    ops = costs.ops(ctx["config"], ctx["batch"] // ctx["world"], itemsize,
                    True) * prof["units"]
    return _common.roofline_pct(ctx, ops, _common.PORT_OPS)
