"""Model FLOPs of the report path: the window's windows/s times the four
streams times one clip's forward FLOPs (``costs.py``), over the card's
peak in the serving precision."""

from benchmark import costs


def read(ctx):
    if ctx.get("kind") != "report" or ctx.get("peaks") is None:
        return None
    flops = (ctx["windows_per_s"] * 4
             * costs.forward_flops_per_clip(ctx["config"]))
    return costs.mfu_pct(flops, ctx["peaks"], ctx["config"]["serve_dtype"])
