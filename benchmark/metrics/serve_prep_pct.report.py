"""The share of the program's report time (its ``serve.report`` span)
spent windowing, pre-normalizing and deriving the modalities (its
``serve.windows``, ``serve.pre_normalization`` and ``serve.modalities``
spans), over the window's reports (``_spans.report_share``)."""

from benchmark.metrics import _spans


def read(ctx):
    if ctx.get("kind") != "report":
        return None
    return _spans.report_share(("serve.windows", "serve.pre_normalization",
                                "serve.modalities"), ctx)
