"""The program's own spans (``shift_gcn_torch.utils.trace``), read in the
run's process after the window.  A program without the registry, or
without the spans a reader needs, gives None."""

import statistics


def snapshot() -> dict:
    try:
        from shift_gcn_torch.utils import trace
    except ImportError:
        return {}
    return trace.snapshot()


def report_share(names, ctx):
    """The spans ``names`` over ``serve.report``, in percent, over the
    run's last ``ctx["reports"]`` reports (as many as the window served).
    Set-up's reports are left out: each is the first at its window count,
    and their forwards take seconds that the window's never do.  A span
    opened k times a report (once a stream) gives its last k times as
    many durations."""
    spans = snapshot()
    report = spans.get("serve.report")
    n = ctx.get("reports")
    if not report or not n or any(name not in spans for name in names):
        return None
    per_report = {name: round(spans[name]["count"] / report["count"])
                  for name in names}
    if not all(per_report.values()):
        return None
    # each name's ring keeps its last durations: as many reports as all hold
    n = min([n, len(report["recent_s"])]
            + [len(spans[name]["recent_s"]) // k
               for name, k in per_report.items()])
    total = sum(report["recent_s"][-n:]) if n > 0 else 0.0
    if total <= 0:
        return None
    part = sum(sum(spans[name]["recent_s"][-n * k:])
               for name, k in per_report.items())
    return 100.0 * part / total


def median_ms(name):
    """The median of the span's last durations, in ms."""
    entry = snapshot().get(name)
    if not entry or not entry["recent_s"]:
        return None
    return 1e3 * statistics.median(entry["recent_s"])
