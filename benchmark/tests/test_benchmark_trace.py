"""The idle gaps of a profiled window, split by the benchmark span that
was open."""

import pytest

from benchmark.trace import SPAN_PREFIX, Spans, busy_and_gaps, idle_by_span


def test_a_gap_is_split_by_the_innermost_open_span():
    spans = [(0, 100, SPAN_PREFIX + "report"),
             (10, 40, SPAN_PREFIX + "pre_normalization")]
    gaps = [(5, 50), (90, 120)]
    by_span = idle_by_span(gaps, spans)
    assert by_span == pytest.approx({"report": (5 + 10 + 10) * 1e-6,
                                     "pre_normalization": 30e-6,
                                     "outside any span": 20e-6})


def test_spans_total_their_seconds():
    spans = Spans()
    for _ in range(3):
        with spans.span("step"):
            pass
    wrapped = spans.wrap("call", lambda x: x + 1)
    assert wrapped(1) == 2
    assert spans.counts == {"step": 3, "call": 1}
    assert set(spans.seconds) == {"step", "call"}


def test_busy_is_the_union_of_intervals_within_the_window():
    busy, gaps = busy_and_gaps([(5, 20), (10, 30), (40, 50), (90, 120)],
                               0, 100)
    assert busy == 15 + 10 + 10 + 10
    assert gaps == [(0, 5), (30, 40), (50, 90)]
