"""Each cell's control, the reference computed one precision below the
configuration's in the program's place, comes out as not correct under
the cell's limits: here at test size on the CPU, and on a card at the
cell's own size (``card``)."""

import json
import sys

import pytest
import torch

from benchmark import checks, manifest
from benchmark.tests import toy

ONE_CARD = ["fall_train_b64", "ntu60_train_b64", "fall_report_tracks"]


@pytest.fixture
def copy(tmp_path_factory, monkeypatch):
    root = toy.make(tmp_path_factory.mktemp("control") / "copy")
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    return root


def judged(cell, readings):
    return {part: checks.judge(numbers, cell.limits)[0]
            for part, numbers in [("program", readings["program"]),
                                  ("control", readings["control"])]}


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_fails_at_test_size(copy, cpu_torch, workload):
    from benchmark import control
    from benchmark import manifest as copied

    cell = copied.cell(workload, copy)
    readings = control.readings(cell, 2 ** 31 + 31, torch.device("cpu"))
    assert judged(cell, readings) == {"program": True, "control": False}, \
        json.dumps(readings)


@pytest.mark.card
@pytest.mark.parametrize("workload", ONE_CARD)
@pytest.mark.parametrize("seed", [2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43])
def test_control_fails_at_the_cells_size(cuda, workload, seed):
    from benchmark import control

    cell = manifest.cell(workload)
    readings = control.readings(cell, seed, cuda)
    assert judged(cell, readings) == {"program": True, "control": False}, \
        json.dumps(readings)
