"""A run with its timed path broken underneath comes out not correct.

Each cell at test size (``toy.py``) runs past the look for a card, on the
CPU, once sound (correct) and once with each fault that the cell can
have planted in the program: a step that leaves the state unchanged;
half of each batch left out, the mean taken over the rest; a report's
answer altered where the predictor produces it.  The cells' own limits
judge them."""

import contextlib
import sys

import pytest
import torch

from benchmark.tests import toy


@pytest.fixture
def copy(tmp_path_factory, monkeypatch):
    root = toy.make(tmp_path_factory.mktemp("faults") / "copy")
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    return root


def run(root, workload: str, fault=None):
    from benchmark import control, manifest, result
    from benchmark import run as bench_run

    cell = manifest.cell(workload, root)
    context = (contextlib.nullcontext() if fault is None
               else getattr(control, fault)())
    with context:
        outcome, device = bench_run.run_cell(cell, 2 ** 31 + 21, 0.3, False,
                                             torch.device("cpu"))
    return result.build(cell, outcome, False, device)


CASES = [("fall_train_b64", None), ("fall_train_b64", "unchanged_state"),
         ("fall_train_b64", "half_batch"),
         ("ntu60_train_b64", None), ("ntu60_train_b64", "unchanged_state"),
         ("ntu60_train_b64", "half_batch"),
         ("fall_report_tracks", None),
         ("fall_report_tracks", "altered_answer")]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(copy, cpu_torch, workload, fault):
    line = run(copy, workload, fault)
    assert line["correct"] == (fault is None), line["checks"]
