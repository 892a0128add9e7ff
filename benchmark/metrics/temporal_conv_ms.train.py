"""Device ms per profiled step in 2s-AGCN's 9-tap temporal conv kernels
(forward, input gradient and weight gradient, as ``kernel_names/`` names
them); None where the profile holds none of them."""

from benchmark.metrics import _common

GROUPS = ("tconv", "tconv_grad")


def read(ctx):
    prof = _common.profile(ctx)
    if ctx.get("kind") != "train" or prof is None:
        return None
    spent = _common.group_seconds(prof, ctx["kernel_names"], GROUPS)
    return 1e3 * spent / prof["units"] if spent > 0 else None
