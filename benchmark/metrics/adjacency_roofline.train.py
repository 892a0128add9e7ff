"""2s-AGCN's adjacency ops of the profiled steps (``adjacency`` and
``adjacency_grad``, counted from the model's shapes by its family's
``ops``): their bound time over the device time of the kernels that
``kernel_names/`` assigns to them.  The bound is the ops' bytes at every
published shape: their FLOPs would take a third of that time even at the
fp32 SIMT rate.  None for a family with no such ops or a run whose
profile holds none of the kernels."""

from benchmark import costs
from benchmark.metrics import _common

GROUPS = ("adjacency", "adjacency_grad")


def read(ctx):
    prof = _common.profile(ctx)
    if ctx.get("kind") != "train" or prof is None:
        return None
    ops = [op for op in costs.ops(ctx["config"], ctx["batch"] // ctx["world"],
                                  4, True) if op[0] in GROUPS]
    if not ops:
        return None
    return _common.roofline_pct(ctx, ops * prof["units"], GROUPS)
