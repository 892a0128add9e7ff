"""Tests of the benchmark harness.  They run on the CPU at small sizes;
those marked ``card`` need a CUDA card and skip without one (decided in
the ``cuda`` fixture, never at import).  Run them from the repository's
root: ``python -m pytest benchmark/tests -q``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


@pytest.fixture
def cpu_torch():
    """oneDNN off (its conv backward is unsafe beside the rank processes)
    and a few threads, restored afterwards."""
    mkldnn, threads = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False
    torch.set_num_threads(min(4, threads))
    yield
    torch.backends.mkldnn.enabled = mkldnn
    torch.set_num_threads(threads)
