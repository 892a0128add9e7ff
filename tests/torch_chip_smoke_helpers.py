"""The fixtures that the rehearsals of chip_smoke.py's phases share
(tests/test_torch_chip_smoke*.py).

A rehearsal runs torch on one CPU thread: the pytest workers share the
machine's cores, and a rehearsal's many small parallel regions, each
waiting at a barrier for threads the other workers have descheduled,
took minutes under that contention (the four-stream rehearsal 724.8 s,
the lowering-knob one 695.7 s) where one thread takes as long as eight
alone (29.8 s, 161 s)."""

from unittest import mock

import pytest
import torch

import chip_smoke


@pytest.fixture
def rehearsal(monkeypatch):
    """chip_smoke at T=40, batches of 4 and 10 artifact clips, on the CPU
    and one torch thread; yields the list its ``fail`` calls append to."""
    failures = []
    monkeypatch.setattr(chip_smoke, "T_WINDOW", 40)
    monkeypatch.setattr(chip_smoke, "N_WINDOWS", 4)
    monkeypatch.setattr(chip_smoke, "ARTIFACT_CLIPS", 10)
    monkeypatch.setattr(chip_smoke, "fail", failures.append)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=10, reps=5: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "profile_call", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cpu = mock.Mock(return_value=torch.device("cpu"))
    for module in ("inference.pipeline", "models.shift_gcn",
                   "inference.export", "inference.serve"):
        monkeypatch.setattr(f"shift_gcn_torch.{module}.resolve_device", cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield failures
    torch.set_num_threads(threads)


@pytest.fixture
def training_rehearsal(rehearsal, monkeypatch):
    """``rehearsal`` with the Trainer and every family on the CPU, the
    peak-memory reads stubbed and oneDNN off (its convolution backward
    corrupts the heap once the reference package's XLA code has run in
    the process, as other test files of a worker may have done)."""
    cpu = mock.Mock(return_value=torch.device("cpu"))
    for module in ("train.trainer", "models.stgcn", "models.ring_gnn"):
        monkeypatch.setattr(f"shift_gcn_torch.{module}.resolve_device", cpu)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    return rehearsal
