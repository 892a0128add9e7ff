"""2s-AGCN's 9-tap temporal convs of the profiled steps (the ``tcn1``
conv of every unit: forward, input gradient and weight gradient, counted
here from ``families/agcn2s.py``'s unit shapes): their bound time over
the device time of the kernels that ``kernel_names/`` assigns to
``tconv`` and ``tconv_grad``.  Each op moves its inputs once and its
outputs once (forward x, W, b -> y; input gradient dy, W -> dx; weight
gradient x, dy -> dW, db) and does 2 N' V T_out C_out C_in 9 FLOPs; the
bound is the larger of the bytes at the HBM rate and the FLOPs at the
input type's highest rate.  None for a family with no such convs or a run
whose profile holds none of the kernels."""

from benchmark.families import agcn2s
from benchmark.metrics import _common

GROUPS = ("tconv", "tconv_grad")


def conv_ops(config: dict, clips: int, itemsize: int) -> list:
    """(op, bytes, flops) of the forward, input gradient and weight
    gradient of each unit's 9-tap conv, one training step of ``clips``
    clips."""
    args = config["model_args"]
    rows = clips * args["num_person"] * args["num_point"]
    taps = agcn2s.TEMPORAL_KERNEL
    ops = []
    for t_in, t_out, _, cout, _, _ in agcn2s.unit_shapes(config):
        x = rows * t_in * cout * itemsize
        y = rows * t_out * cout * itemsize
        w = cout * cout * taps * itemsize
        b = cout * itemsize
        flops = 2.0 * rows * t_out * cout * cout * taps
        ops += [("tconv", x + w + b + y, flops),
                ("tconv_grad", y + w + x, flops),
                ("tconv_grad", x + y + w + b, flops)]
    return ops


def read(ctx):
    prof = _common.profile(ctx)
    if (ctx.get("kind") != "train" or prof is None
            or ctx["config"].get("family") != agcn2s.MODEL):
        return None
    itemsize = 2 if ctx["dtype"] == "bfloat16" else 4
    ops = conv_ops(ctx["config"], ctx["batch"] // ctx["world"], itemsize)
    return _common.roofline_pct(ctx, ops * prof["units"], GROUPS)
