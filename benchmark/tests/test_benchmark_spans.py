"""The readers of the program's spans (``metrics/serve_*_pct.report.py``,
``metrics/epoch_start_ms.train.py``): their numbers from spans seeded
into the registry, and None where the registry, the spans or the cell
kind do not fit."""

import sys
import types

import pytest

from benchmark import manifest
from shift_gcn_torch.utils import trace

SERVE = ("serve_prep_pct.report", "serve_dispatch_pct.report",
         "serve_wait_pct.report")
TRAIN = ("epoch_start_ms.train",)


@pytest.fixture(autouse=True)
def empty_registry():
    trace.reset()
    yield
    trace.reset()


def seed(monkeypatch, spans):
    """Run ``spans``, each (name, ns, children), on a clock that makes
    each span last ``ns`` nanoseconds, its children inside it."""
    steps = []
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: steps.append(0) or sum(steps)))

    def run(name, ns, children=()):
        with trace.span(name):
            inner = 0
            for child in children:
                inner += run(*child)
            steps[-1] += ns - inner
        return ns

    for span in spans:
        run(*span)


def report(ns_windows, ns_prenorm, ns_mods, ns_h2d, ns_fwd, ns_read, total):
    streams = [("serve.h2d", ns_h2d), ("serve.forward", ns_fwd)] * 4
    return ("serve.report", total, [
        ("serve.windows", ns_windows), ("serve.pre_normalization", ns_prenorm),
        ("serve.modalities", ns_mods), *streams, ("serve.readback", ns_read)])


def read(name, kind, reports=2):
    return manifest.metric_reader(name)({"kind": kind, "reports": reports})


# a set-up report: its forwards take seconds (the first at its shape)
WARM = report(10, 200, 40, 5, 900_000, 30, 3_700_000)


def test_serving_shares_of_the_window_reports(monkeypatch):
    # set-up's report, then the window's two: 1000 and 3000 ns, the
    # second three times the first
    seed(monkeypatch, [WARM, report(10, 200, 40, 5, 100, 30, 1000),
                       report(30, 600, 120, 15, 300, 90, 3000)])
    assert trace.snapshot()["serve.report"]["count"] == 3
    assert read("serve_prep_pct.report", "report") == pytest.approx(25.0)
    assert read("serve_dispatch_pct.report", "report") == pytest.approx(40.0)
    assert read("serve_wait_pct.report", "report") == pytest.approx(5.0)
    # over all three the set-up report would swamp the window's
    assert read("serve_dispatch_pct.report", "report", 3) == \
        pytest.approx(100 * (3_600_000 + 1600) / 3_704_000)


def test_serving_shares_within_the_rings(monkeypatch):
    """Rings of 8 durations hold two reports' four streams: the shares
    are over those two, the same reports for every span."""
    monkeypatch.setattr(trace, "RING", 8)
    seed(monkeypatch, [WARM, report(10, 200, 40, 5, 100, 30, 1000),
                       report(30, 600, 120, 15, 300, 90, 3000)])
    assert read("serve_dispatch_pct.report", "report", 3) == \
        pytest.approx(40.0)


def test_epoch_start_is_the_median(monkeypatch):
    seed(monkeypatch, [("train.epoch_start", ns) for ns in
                       (90_000_000, 150_000_000, 160_000_000)]
         + [("train.step", 180_000_000)])
    assert read("epoch_start_ms.train", "train") == pytest.approx(150.0)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_an_empty_registry_reads_none(name):
    assert read(name, "report" if name in SERVE else "train") is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_the_other_cell_kind_reads_none(monkeypatch, name):
    seed(monkeypatch, [report(10, 200, 40, 5, 100, 30, 1000),
                       ("train.epoch_start", 1000)])
    assert read(name, "train" if name in SERVE else "report") is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_program_without_the_registry_reads_none(monkeypatch, name):
    # a program without the registry (shift_gcn_torch.utils.trace)
    monkeypatch.setitem(sys.modules, "shift_gcn_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["shift_gcn_torch.utils"], "trace")
    assert read(name, "report" if name in SERVE else "train") is None
