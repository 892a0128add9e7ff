"""Control flow of chip_smoke.py's live-serving phases (11-13) and its
four-stream training phase (14), rehearsed on the CPU at a small size:
the kernels' plain versions run in place of the kernels, so every check
but the launch counts must pass, and the launch counts must fail (the
plain versions launch nothing)."""

import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.inference import pipeline
from shift_gcn_torch.inference.streaming import StreamingFallDetector
from shift_gcn_torch.models.shift_gcn import config_from_reference_args
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}


@pytest.fixture
def rehearsal(monkeypatch):
    """chip_smoke at T=40, batches of 4 and 10 artifact clips, on the CPU;
    returns the list its ``fail`` calls append to."""
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
    return failures


def test_live_serving_phases_rehearse_on_cpu(rehearsal, capsys):
    config = config_from_reference_args(ARGS)
    rng = np.random.default_rng(0)
    dev = torch.device("cpu")
    chip_smoke.check_stream_shapes(config, torch.Generator().manual_seed(0),
                                   rng, dev)
    assert rehearsal == []
    dicts = {m: state_dict_from_arrays(*chip_smoke.random_arrays(config, rng))
             for m in pipeline.MODALITY_ORDER}
    p50, p90 = chip_smoke.check_streaming(
        pipeline.EnsemblePredictor(dicts, model_config=config), rng, "card")
    assert 0 < p50 <= p90
    times = chip_smoke.check_artifacts(dicts["joint"], config, rng, dev,
                                       "card")
    assert set(times) == {"inputs", "baked"}
    # two streaming runs and two artifacts: only their launch counts fail
    assert len(rehearsal) == 4, rehearsal
    assert all("launch counts" in msg for msg in rehearsal), rehearsal
    out = capsys.readouterr().out
    assert "max|logit - live| 0," in out
    assert out.count("[stream]") == 3 and out.count("[artifact]") == 2


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


class _Scripted:
    def __init__(self, probs):
        self.config = config_from_reference_args(ARGS)
        self.graph = get_graph("mediapipe_pose")
        self._probs = list(probs)

    def predict(self, batch):
        p = self._probs.pop(0)
        return np.array([[1.0 - p, p]])


@pytest.mark.parametrize("probs", [[0.2, 0.7, 0.8, 0.1, 0.9],
                                   [0.6, 0.4, 0.6, 0.6, 0.3]])
def test_hysteresis_events_are_the_detectors(probs):
    """Phase 12 derives the expected events from the offline scores with
    ``hysteresis_events``: it must be the detector's rule."""
    det = StreamingFallDetector(_Scripted(probs), window=8, hop=4)
    got = []
    for _ in range(4 * len(probs)):
        upd = det.push(np.zeros((3, 33, 1), np.float32))
        if upd is not None:
            got.append(upd.event)
    closing = [u["event"] for u in det.finalize()["final_updates"]]
    want, still_open = chip_smoke.hysteresis_events(probs, 0.5)
    assert got == want
    assert closing == (["fall_end"] if still_open else [])


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr
