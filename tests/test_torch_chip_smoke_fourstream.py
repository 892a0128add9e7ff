"""Control flow of chip_smoke.py's four-stream training phase (14),
rehearsed on the CPU at a small size: the kernels' plain versions run in
place of the kernels, so every check but the launch counts must pass,
and the launch counts must fail (the plain versions launch nothing)."""

from unittest import mock

import numpy as np
import torch

import chip_smoke
from torch_chip_smoke_helpers import rehearsal  # noqa: F401 (a fixture)


def test_fourstream_phase_rehearses_on_cpu(rehearsal, monkeypatch, capsys,
                                           tmp_path):
    """Phase 14 on configs/mediapipe/train_fourstream.yaml, the full-width
    model at T=40, 2 steps of 4 clips and 6 validation clips."""
    monkeypatch.setattr(chip_smoke, "TRAIN_CLIPS", 8)
    monkeypatch.setattr(chip_smoke, "VAL_CLIPS", 6)
    config_at = chip_smoke.training_config
    monkeypatch.setattr(
        chip_smoke, "training_config",
        lambda *args: config_at(*args, "--batch_size", "4",
                                "--test_batch_size", "4"))
    cpu = mock.Mock(return_value=torch.device("cpu"))
    monkeypatch.setattr("shift_gcn_torch.train.trainer.resolve_device", cpu)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr("shift_gcn_torch.utils.device_guard.time.sleep",
                        mock.Mock(side_effect=AssertionError("slept")))
    launches, stats, step_ms = chip_smoke.run_fourstream(
        np.random.default_rng(0), torch.device("cpu"), str(tmp_path),
        "card")
    # only the launch counts fail: the plain versions launch nothing
    assert len(rehearsal) == 1, rehearsal
    assert "four-stream launch counts" in rehearsal[0]
    assert set(launches.values()) == {0}
    assert len(stats["stream_losses"]) == 2 and step_ms == 1.0
    out = capsys.readouterr().out
    assert out.count("[fourstream]") == 1
    assert "device guard healthy, a failing probe raised after 3" in out
