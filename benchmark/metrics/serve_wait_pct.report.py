"""The share of the program's report time (its ``serve.report`` span) in
the streams' blocking host-to-device copies and the ensemble's softmax
and read-back (its ``serve.h2d`` and ``serve.readback`` spans), where the
host waits for the device, over the window's reports
(``_spans.report_share``)."""

from benchmark.metrics import _spans


def read(ctx):
    if ctx.get("kind") != "report":
        return None
    return _spans.report_share(("serve.h2d", "serve.readback"), ctx)
