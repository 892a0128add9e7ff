"""The share of the program's report time (its ``serve.report`` span) in
the four streams' forwards, weighted and summed (its ``serve.forward``
spans): the host's dispatch of their launches, and any wait for the
device inside them, over the window's reports (``_spans.report_share``)."""

from benchmark.metrics import _spans


def read(ctx):
    if ctx.get("kind") != "report":
        return None
    return _spans.report_share(("serve.forward",), ctx)
