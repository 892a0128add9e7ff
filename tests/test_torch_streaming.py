"""Port streaming detector (shift_gcn_torch.inference.streaming) vs the
reference package's on the CPU, from the same exported reference ``.pt``
checkpoints; plus the port's counterparts of tests/test_streaming.py and
its deliberate differences (a finalize that raises leaves the detector
re-finalizable; the closing fall_end carries the last window's score)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from shift_gcn_tpu.inference import pipeline as jax_pipeline
from shift_gcn_tpu.inference import streaming as jax_streaming
from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.utils.checkpoint import export_reference_checkpoint
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.inference import pipeline, streaming
from shift_gcn_torch.inference.streaming import (
    StreamingFallDetector, StreamUpdate, run_stream)
from shift_gcn_torch.models.shift_gcn import (
    ModelConfig, config_from_reference_args)

WINDOW, HOP = 64, 32
ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose", "blocks": [[3, 8, 1, False], [8, 8, 2]]}
MODEL_ARGS = ("{num_class: 2, num_point: 33, num_person: 1, "
              "graph: mediapipe_pose, blocks: [[3, 8, 1, false], [8, 8, 2]]}")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Reference-layout .pt files of two streams, from the reference
    package's init with non-trivial eval BN statistics."""
    root = tmp_path_factory.mktemp("stream_pt")
    cfg = jax_model.config_from_reference_args(ARGS)
    paths = {}
    for i, modality in enumerate(["joint", "bone"]):
        params, state = jax_model.init_params(jax.random.key(20 + i), cfg)
        params = jax.tree_util.tree_map(np.array, params)
        state = jax.tree_util.tree_map(np.array, state)
        # a smaller classifier keeps the probabilities off saturation
        params["fc"]["weight"] *= 0.3
        rng = np.random.default_rng(i)
        for block in ("l1", "l2"):
            bn = state[block]["tcn1"]["bn2"]
            bn["running_mean"] = rng.normal(
                0, 0.3, bn["running_mean"].shape).astype(np.float32)
            bn["running_var"] = rng.uniform(
                0.5, 1.5, bn["running_var"].shape).astype(np.float32)
        paths[modality] = export_reference_checkpoint(
            str(root / f"{modality}.pt"), params, state)
    return cfg, paths


@pytest.fixture(scope="module")
def predictors(checkpoints):
    cfg, paths = checkpoints
    ref = jax_pipeline.EnsemblePredictor(paths, model_config=cfg)
    port = pipeline.EnsemblePredictor(
        paths, model_config=config_from_reference_args(ARGS), device="cpu")
    return ref, port


def _landmarks(t, seed):
    return np.random.default_rng(seed).standard_normal(
        (3, t, 33, 1)).astype(np.float32)


def _separated_threshold(probs):
    """A threshold inside the range of ``probs`` and far (relative to the
    parity tolerance) from each of them, so events and intervals are
    compared exactly."""
    p = np.unique(np.asarray(probs))
    gaps = np.diff(p)
    i = int(np.argmax(gaps))
    assert gaps[i] > 1e-4
    return float((p[i] + p[i + 1]) / 2)


def _update_fields(u):
    u = u if isinstance(u, dict) else dataclasses.asdict(u)
    return (u["frame_index"], tuple(u["span"]), u["fall_active"],
            u["event"], u["partial"])


@pytest.mark.parametrize("t", [40, 192, 250])
def test_stream_matches_reference(predictors, t):
    """The same landmarks through both detectors: equal frame indices,
    spans, partial flags, hysteresis states and events; fall_prob and the
    finalize() report within 1e-5."""
    ref, port = predictors
    landmarks = _landmarks(t, 100 + t)
    kw = {"window": WINDOW, "hop": HOP}
    probe, probe_updates = jax_streaming.run_stream(landmarks, ref, **kw)
    threshold = _separated_threshold(
        [u.fall_prob for u in probe_updates]
        + [u["fall_prob"] for u in probe["final_updates"]]
        + probe["frame_probabilities"])
    want, want_updates = jax_streaming.run_stream(
        landmarks, ref, threshold=threshold, **kw)
    got, got_updates = run_stream(landmarks, port, threshold=threshold, **kw)
    assert [_update_fields(u) for u in got_updates] == [
        _update_fields(u) for u in want_updates]
    np.testing.assert_allclose([u.fall_prob for u in got_updates],
                               [u.fall_prob for u in want_updates],
                               atol=1e-5)
    assert list(got) == list(want)
    for key in ("total_frames", "num_windows", "fall_detected"):
        assert got[key] == want[key], key
    assert ([(iv["start_frame"], iv["end_frame"])
             for iv in got["fall_intervals"]]
            == [(iv["start_frame"], iv["end_frame"])
                for iv in want["fall_intervals"]])
    np.testing.assert_allclose(got["frame_probabilities"],
                               want["frame_probabilities"], atol=1e-5)
    np.testing.assert_allclose(got["max_fall_probability"],
                               want["max_fall_probability"], atol=1e-5)
    assert [_update_fields(u) for u in got["final_updates"]] == [
        _update_fields(u) for u in want["final_updates"]]
    np.testing.assert_allclose(
        [u["fall_prob"] for u in got["final_updates"]],
        [u["fall_prob"] for u in want["final_updates"]], atol=1e-5)


@pytest.mark.parametrize("t", [40, 192, 250])
def test_offline_parity(predictors, t):
    """finalize() == run_on_landmarks at hop == stride, within fp
    tolerance: short stream (single padded window), aligned end, and
    unaligned end (tail window)."""
    _, port = predictors
    landmarks = _landmarks(t, t)
    offline = pipeline.run_on_landmarks(
        landmarks, port, window=WINDOW, stride=HOP, threshold=0.5)
    online, _ = run_stream(landmarks, port, window=WINDOW, hop=HOP,
                           threshold=0.5)
    assert online["total_frames"] == offline["total_frames"] == t
    assert online["num_windows"] == offline["num_windows"]
    np.testing.assert_allclose(
        online["frame_probabilities"], offline["frame_probabilities"],
        rtol=1e-5, atol=1e-6)
    assert ([(iv["start_frame"], iv["end_frame"])
             for iv in online["fall_intervals"]]
            == [(iv["start_frame"], iv["end_frame"])
                for iv in offline["fall_intervals"]])
    assert online["max_fall_probability"] == pytest.approx(
        offline["max_fall_probability"], rel=1e-5, abs=1e-6)


def test_update_cadence_and_spans(predictors):
    """Evaluations fire every `hop` frames; warm-up windows are flagged
    partial and left out of the report's window count."""
    _, port = predictors
    landmarks = _landmarks(128, 0)
    seen = []
    report, updates = run_stream(landmarks, port, window=WINDOW, hop=HOP,
                                 on_update=seen.append)
    assert seen == updates  # the live hook fires for every update
    assert [u.frame_index for u in updates] == [31, 63, 95, 127]
    assert [u.partial for u in updates] == [True, False, False, False]
    assert [u.span for u in updates] == [
        (0, 32), (0, 64), (32, 96), (64, 128)]
    # only the 3 full windows aggregate (offline spans for t=128)
    assert report["num_windows"] == 3
    assert all(isinstance(u, StreamUpdate) for u in updates)


def test_cli_streams_landmark_file(checkpoints, tmp_path, capsys):
    """End-to-end CLI on the CPU: replay a saved .npy landmark array,
    write the report JSON; --model-args selects the small architecture."""
    _, paths = checkpoints
    lm_file = tmp_path / "lm.npy"
    np.save(lm_file, _landmarks(96, 7))
    out = tmp_path / "report.json"
    streaming.main([
        "--landmarks", str(lm_file), "--joint", paths["joint"],
        "--model-args", MODEL_ARGS, "--window", str(WINDOW),
        "--hop", str(HOP), "--output", str(out), "--device", "cpu"])
    report = json.loads(out.read_text())
    assert report["total_frames"] == 96
    # offline spans for t=96 at 64/32: (0,64) + (32,96)
    assert report["num_windows"] == 2
    assert len(report["frame_probabilities"]) == 96
    summary = capsys.readouterr().out
    assert '"total_frames": 96' in summary


def test_cli_streams_video_through_pose_backend(checkpoints, tmp_path,
                                                monkeypatch):
    """--video goes through the named pose backend (a stub here); the
    report equals the --landmarks replay of the same landmarks."""
    from shift_gcn_torch.data.gendata import mediapipe

    _, paths = checkpoints
    landmarks = _landmarks(80, 8)
    monkeypatch.setitem(mediapipe._BACKENDS, "stub",
                        lambda path, max_frame: (landmarks, None))
    np.save(tmp_path / "lm.npy", landmarks)
    common = ["--joint", paths["joint"], "--model-args", MODEL_ARGS,
              "--window", str(WINDOW), "--hop", str(HOP), "--device", "cpu"]
    streaming.main(["--video", "clip.mp4", "--pose-backend", "stub",
                    "--output", str(tmp_path / "a.json"), *common])
    streaming.main(["--landmarks", str(tmp_path / "lm.npy"),
                    "--output", str(tmp_path / "b.json"), *common])
    assert (json.loads((tmp_path / "a.json").read_text())
            == json.loads((tmp_path / "b.json").read_text()))


def test_cli_needs_cuda_by_default(checkpoints, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    _, paths = checkpoints
    np.save(tmp_path / "lm.npy", _landmarks(40, 9))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.main(["--landmarks", str(tmp_path / "lm.npy"),
                        "--joint", paths["joint"], "--model-args",
                        MODEL_ARGS, "--output", str(tmp_path / "r.json")])


class _ScriptedPredictor:
    """Fake predictor emitting a fixed fall-probability sequence (the
    real forward path is covered by the parity tests above); ``fail``
    holds call numbers that raise instead."""

    def __init__(self, probs, fail=()):
        self.config = ModelConfig(
            num_class=2, num_point=33, num_person=1,
            graph="mediapipe_pose")
        self.graph = get_graph("mediapipe_pose")
        self._probs = list(probs)
        self._fail = set(fail)
        self.calls = 0

    def predict(self, batch):
        assert batch.shape == (1, 3, WINDOW, 33, 1)
        self.calls += 1
        if self.calls in self._fail:
            raise RuntimeError("forward failed")
        p = self._probs.pop(0)
        return np.array([[1.0 - p, p]], np.float64)


def _push_zeros(det, frames):
    updates = []
    for _ in range(frames):
        upd = det.push(np.zeros((3, 33, 1), np.float32))
        if upd is not None:
            updates.append(upd)
    return updates


def test_hysteresis_events():
    """min_consecutive suppresses single-window spikes; transitions fire
    as fall_start/fall_end exactly once per crossing."""
    # eval sequence: spike, quiet, two sustained highs, then low
    det = StreamingFallDetector(
        _ScriptedPredictor([0.9, 0.1, 0.8, 0.8, 0.2]), window=WINDOW,
        hop=HOP, threshold=0.5, min_consecutive=2)
    updates = _push_zeros(det, 5 * HOP)
    assert [u.event for u in updates] == [
        None, None, None, "fall_start", "fall_end"]
    assert [u.fall_active for u in updates] == [
        False, False, False, True, False]


def test_immediate_start_with_min_consecutive_one():
    det = StreamingFallDetector(
        _ScriptedPredictor([0.7, 0.6, 0.3]), window=WINDOW, hop=HOP,
        threshold=0.5, min_consecutive=1)
    assert [u.event for u in _push_zeros(det, 3 * HOP)] == [
        "fall_start", None, "fall_end"]


def test_finalize_surfaces_tail_and_closing_events():
    """A fall first crossing threshold in the tail window (scored only
    inside finalize) still emits fall_start, and a fall open at stream end
    gets a closing fall_end, via report['final_updates']; the closing
    update carries the last evaluated window's score."""
    # evals: push at t=32 (partial, 0.1), t=64 (full, 0.1); finalize tail
    # [16, 80) scores 0.9 -> fall_start, then stream-end fall_end
    det = StreamingFallDetector(
        _ScriptedPredictor([0.1, 0.1, 0.9]), window=WINDOW, hop=HOP)
    assert all(u.event is None for u in _push_zeros(det, 80))
    report = det.finalize()
    events = [u["event"] for u in report["final_updates"]]
    assert events == ["fall_start", "fall_end"]
    assert report["final_updates"][0]["span"] == (16, 80)
    closing = report["final_updates"][1]
    assert closing["fall_active"] is False
    assert closing["fall_prob"] == report["final_updates"][0]["fall_prob"]
    assert closing["fall_prob"] == 0.9
    # tail window recorded: offline spans for t=80 are (0,64) + (16,80)
    assert report["num_windows"] == 2


def test_finalize_reuses_last_partial_eval():
    """Stream length a hop multiple below one window: the last push
    already scored the exact padded buffer, so finalize reuses it (no
    second forward, no double hysteresis count)."""
    pred = _ScriptedPredictor([0.8])
    det = StreamingFallDetector(pred, window=WINDOW, hop=HOP,
                                min_consecutive=1)
    events = [u.event for u in _push_zeros(det, HOP)]
    report = det.finalize()
    assert pred.calls == 1  # no second forward in finalize
    assert events == ["fall_start"]  # delivered at push time...
    # ...so finalize adds only the stream-end closure, and the reused
    # score becomes the offline single padded window
    assert [u["event"] for u in report["final_updates"]] == ["fall_end"]
    assert report["num_windows"] == 1
    assert report["frame_probabilities"] == [0.8] * HOP


@pytest.mark.parametrize("frames", [20, 80])
def test_failed_finalize_leaves_detector_refinalizable(frames):
    """The port's deliberate difference: a tail forward that raises
    inside finalize() leaves the detector unfinalized and unchanged, so
    a second finalize() gives the report a clean run gives."""
    probs = [0.1, 0.1, 0.9]
    n_push = frames // HOP
    fail_at = n_push + 1  # the tail forward, the first call of finalize
    det = StreamingFallDetector(
        _ScriptedPredictor(probs[:n_push] + [0.9], fail=(fail_at,)),
        window=WINDOW, hop=HOP)
    _push_zeros(det, frames)
    with pytest.raises(RuntimeError, match="forward failed"):
        det.finalize()
    report = det.finalize()
    clean = StreamingFallDetector(
        _ScriptedPredictor(probs[:n_push] + [0.9]), window=WINDOW, hop=HOP)
    _push_zeros(clean, frames)
    assert report == clean.finalize()
    with pytest.raises(RuntimeError, match="already finalized"):
        det.finalize()


def test_api_guards():
    det = StreamingFallDetector(
        _ScriptedPredictor([0.1] * 8), window=WINDOW, hop=HOP)
    with pytest.raises(ValueError):
        det.push(np.zeros((3, 25, 1), np.float32))
    det.push(np.zeros((3, 33, 1), np.float32))
    report = det.finalize()
    assert report["total_frames"] == 1
    assert report["num_windows"] == 1  # offline single padded window
    with pytest.raises(RuntimeError):
        det.push(np.zeros((3, 33, 1), np.float32))
    with pytest.raises(RuntimeError):
        det.finalize()
    with pytest.raises(ValueError):
        StreamingFallDetector(_ScriptedPredictor([]), window=0)
    with pytest.raises(ValueError):
        StreamingFallDetector(_ScriptedPredictor([]), min_consecutive=0)
    # window must tile into hops, else leading frames would silently
    # aggregate to probability 0.0
    with pytest.raises(ValueError):
        StreamingFallDetector(_ScriptedPredictor([]), window=64, hop=48)
    with pytest.raises(ValueError):
        StreamingFallDetector(_ScriptedPredictor([]), window=64, hop=100)
    # empty stream: clean empty report, no evaluation
    empty = StreamingFallDetector(_ScriptedPredictor([]), window=WINDOW,
                                  hop=HOP)
    rep = empty.finalize()
    assert rep["total_frames"] == 0 and rep["num_windows"] == 0
    assert rep["fall_detected"] is False
