"""Model FLOPs of a training step per clip (``costs.py``: three times the
forward's multiply-adds, nothing recomputed) times the window's clips/s,
over the card's peak in the configuration's activation precision (over
all cards on several)."""

from benchmark import costs


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("peaks") is None:
        return None
    flops = costs.step_flops_per_clip(ctx["config"]) * ctx["clips_per_s"]
    return costs.mfu_pct(flops / ctx["world"], ctx["peaks"], ctx["dtype"])
