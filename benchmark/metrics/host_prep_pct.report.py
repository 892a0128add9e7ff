"""The share of report time the host spent in the pipeline's windowing,
pre-normalization and modality derivation (the benchmark's spans around
those calls, over its spans around each report), over the traced run's
reports."""

PREP = ("create_sliding_windows", "pre_normalization", "derive_modalities")


def read(ctx):
    spans = ctx.get("spans") or {}
    if ctx.get("kind") != "report" or not spans.get("report"):
        return None
    return 100.0 * sum(spans.get(k, 0.0) for k in PREP) / spans["report"]
