"""Port serving path (shift_gcn_torch.inference.pipeline) vs the
reference package's pipeline on the CPU, from the same exported
reference ``.pt`` checkpoints; plus the port's import hygiene."""

import json
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from shift_gcn_tpu.inference import pipeline as jax_pipeline
from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.utils.checkpoint import export_reference_checkpoint
from shift_gcn_torch.inference import pipeline
from shift_gcn_torch.models.shift_gcn import config_from_reference_args
from shift_gcn_torch.utils.checkpoint import load_reference_checkpoint

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "shift_gcn_torch"
ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_pt")
    cfg = jax_model.config_from_reference_args(ARGS)
    paths = {}
    for i, modality in enumerate(["joint", "bone"]):
        params, state = jax_model.init_params(jax.random.key(10 + i), cfg)
        params = jax.tree_util.tree_map(np.array, params)
        state = jax.tree_util.tree_map(np.array, state)
        # a small classifier keeps the probabilities off saturation
        params["fc"]["weight"] *= 0.02
        rng = np.random.default_rng(i)
        for block in ("l1", "l2", "l3"):
            bn = state[block]["tcn1"]["bn2"]
            bn["running_mean"] = rng.normal(0, 0.3, bn["running_mean"].shape
                                            ).astype(np.float32)
            bn["running_var"] = rng.uniform(0.5, 1.5, bn["running_var"].shape
                                            ).astype(np.float32)
        paths[modality] = export_reference_checkpoint(
            str(root / f"{modality}.pt"), params, state)
    return cfg, paths


def _landmarks(t, seed):
    return np.random.default_rng(seed).standard_normal(
        (3, t, 33, 1)).astype(np.float32)


def _separated_threshold(probs):
    """A threshold far (relative to the parity tolerance) from every
    frame probability, inside their range, so intervals are compared
    exactly."""
    p = np.unique(np.asarray(probs))
    gaps = np.diff(p)
    i = int(np.argmax(gaps))
    assert gaps[i] > 1e-4
    return float((p[i] + p[i + 1]) / 2)


def test_run_on_landmarks_matches_reference(checkpoints):
    cfg, paths = checkpoints
    ref = jax_pipeline.EnsemblePredictor(paths, model_config=cfg)
    port = pipeline.EnsemblePredictor(
        paths, model_config=config_from_reference_args(ARGS), device="cpu")
    landmarks = _landmarks(90, 0)
    kw = {"window": 32, "stride": 16}
    probe = jax_pipeline.run_on_landmarks(landmarks, ref, **kw)
    threshold = _separated_threshold(probe["frame_probabilities"])
    want = jax_pipeline.run_on_landmarks(landmarks, ref, threshold=threshold,
                                         **kw)
    got = pipeline.run_on_landmarks(landmarks, port, threshold=threshold,
                                    **kw)
    assert list(got) == list(want)
    for key in ("total_frames", "num_windows", "fall_detected"):
        assert got[key] == want[key], key
    assert want["fall_intervals"], "threshold should split the frames"
    assert ([(iv["start_frame"], iv["end_frame"])
             for iv in got["fall_intervals"]]
            == [(iv["start_frame"], iv["end_frame"])
                for iv in want["fall_intervals"]])
    # fp32 logits through 3 units with a different temporal/spatial
    # algorithm on the reference side, then softmax: roundoff only
    np.testing.assert_allclose(got["frame_probabilities"],
                               want["frame_probabilities"], atol=1e-5)
    np.testing.assert_allclose(got["max_fall_probability"],
                               want["max_fall_probability"], atol=1e-5)


def test_predictor_accepts_state_dicts(checkpoints):
    cfg, paths = checkpoints
    port_cfg = config_from_reference_args(ARGS)
    windows, _ = pipeline.create_sliding_windows(_landmarks(40, 1), 32, 16)
    from_files = pipeline.EnsemblePredictor(paths, model_config=port_cfg,
                                            device="cpu")
    state_dicts = {m: load_reference_checkpoint(p)[0]
                   for m, p in paths.items()}
    from_dicts = pipeline.EnsemblePredictor(state_dicts, model_config=port_cfg,
                                            device="cpu")
    np.testing.assert_array_equal(from_files.predict(windows),
                                  from_dicts.predict(windows))


def test_load_reference_checkpoint_pkl_and_resume_dict(checkpoints, tmp_path):
    _, paths = checkpoints
    sd, meta = load_reference_checkpoint(paths["joint"])
    assert meta == {}
    pkl = tmp_path / "w.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({f"module.{k}": v.numpy() for k, v in sd.items()}, f)
    sd2, _ = load_reference_checkpoint(str(pkl))
    assert list(sd2) == list(sd)
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k
    pt = tmp_path / "resume.pt"
    torch.save({"model_state_dict": sd, "epoch": 3, "best_acc": 0.5}, pt)
    sd3, meta3 = load_reference_checkpoint(str(pt))
    assert meta3 == {"epoch": 3, "best_acc": 0.5} and list(sd3) == list(sd)


@pytest.mark.parametrize("t,window,stride", [(700, 300, 150), (100, 300, 150),
                                             (90, 32, 16)])
def test_windows_and_aggregation_match_reference(t, window, stride):
    data = _landmarks(t, 2)
    w1, s1 = pipeline.create_sliding_windows(data, window, stride)
    w2, s2 = jax_pipeline.create_sliding_windows(data, window, stride)
    np.testing.assert_array_equal(w1, w2)
    assert s1 == s2
    scores = np.random.default_rng(3).uniform(size=len(s1))
    got = pipeline.build_report(scores, s1, t, 0.5)
    want = jax_pipeline.build_report(scores, s2, t, 0.5)
    assert got == want


def test_predictor_without_device_needs_cuda(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    _, paths = checkpoints
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.EnsemblePredictor(paths)


def test_port_sources_name_no_reference_framework():
    files = sorted(p for p in PORT_ROOT.rglob("*")
                   if p.is_file() and p.suffix in (".py", ".cu", ".cuh"))
    assert any(p.suffix == ".cu" for p in files)
    banned = re.compile(r"\bjax\b|shift_gcn_tpu", re.IGNORECASE)
    offenders = [str(p) for p in files if banned.search(p.read_text())]
    assert offenders == []


def test_port_import_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import shift_gcn_torch\n"
        "for m in pkgutil.walk_packages(shift_gcn_torch.__path__,\n"
        "                               'shift_gcn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'shift_gcn_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=PORT_ROOT.parent, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Video -> report: run_pipeline, checkpoint discovery, the CLI
# ---------------------------------------------------------------------------


def _write_video(path, frames, size=(64, 48)):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             size)
    assert writer.isOpened()
    for i in range(frames):
        writer.write(np.full((size[1], size[0], 3), (i * 7) % 255, np.uint8))
    writer.release()
    return str(path)


def _stub_backend(landmarks):
    """A pose backend returning fixed world and pixel landmarks."""
    t = landmarks.shape[1]
    pixels = np.random.default_rng(1).uniform(
        1, 40, (t, 33, 2)).astype(np.float32)
    return lambda path, max_frame: (landmarks[:, :max_frame], pixels)


def _read_frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_run_pipeline_matches_reference(checkpoints, tmp_path, monkeypatch):
    """The same stub pose backend registered on both sides: equal report
    keys, windows and intervals, probabilities within 1e-5; the JSON on
    disk is the returned report, and the annotated video has every frame."""
    from shift_gcn_tpu.data.gendata import mediapipe as jax_mediapipe
    from shift_gcn_torch.data.gendata import mediapipe

    cfg, paths = checkpoints
    landmarks = _landmarks(60, 4)
    video = _write_video(tmp_path / "clip.mp4", 60)
    backend = _stub_backend(landmarks)
    monkeypatch.setitem(jax_mediapipe._BACKENDS, "stub", backend)
    monkeypatch.setitem(mediapipe._BACKENDS, "stub", backend)
    kw = {"window": 32, "stride": 16, "pose_backend": "stub"}
    probe = jax_pipeline.run_pipeline(video, paths, model_config=cfg, **kw)
    threshold = _separated_threshold(probe["frame_probabilities"])
    want = jax_pipeline.run_pipeline(video, paths, model_config=cfg,
                                     threshold=threshold, **kw)
    out_json, out_video = tmp_path / "r.json", tmp_path / "annotated.mp4"
    got = pipeline.run_pipeline(
        video, paths, model_config=config_from_reference_args(ARGS),
        threshold=threshold, output_json=str(out_json),
        output_video=str(out_video), device="cpu", **kw)
    assert got.pop("annotated_video") == str(out_video)
    assert list(got) == list(want)
    for key in ("total_frames", "num_windows", "fall_detected", "video"):
        assert got[key] == want[key], key
    assert ([(iv["start_frame"], iv["end_frame"])
             for iv in got["fall_intervals"]]
            == [(iv["start_frame"], iv["end_frame"])
                for iv in want["fall_intervals"]])
    np.testing.assert_allclose(got["frame_probabilities"],
                               want["frame_probabilities"], atol=1e-5)
    saved = json.loads(out_json.read_text())
    assert saved.pop("annotated_video") == str(out_video)
    assert saved == json.loads(json.dumps(got))
    assert _read_frames(out_video) == 60


def test_run_pipeline_writes_report_before_render(checkpoints, tmp_path,
                                                  monkeypatch):
    """A render that fails leaves the report JSON on disk, without the
    annotated_video key (it is added only once the video exists)."""
    from shift_gcn_torch.data.gendata import mediapipe
    from shift_gcn_torch.inference import render

    _, paths = checkpoints
    monkeypatch.setitem(mediapipe._BACKENDS, "stub",
                        _stub_backend(_landmarks(40, 5)))

    def broken(*args, **kwargs):
        raise RuntimeError("render failed")

    monkeypatch.setattr(render, "render_annotated_video", broken)
    out_json = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="render failed"):
        pipeline.run_pipeline(
            "clip.mp4", paths, model_config=config_from_reference_args(ARGS),
            window=32, stride=16, pose_backend="stub",
            output_json=str(out_json), output_video=str(tmp_path / "v.mp4"),
            device="cpu")
    saved = json.loads(out_json.read_text())
    assert saved["total_frames"] == 40 and "annotated_video" not in saved


def test_run_pipeline_refuses_fourstream_and_bad_combinations(checkpoints):
    _, paths = checkpoints
    with pytest.raises(NotImplementedError, match="A9"):
        pipeline.run_pipeline("clip.mp4", fourstream_checkpoint="four.pt",
                              device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pipeline.run_pipeline("clip.mp4", device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pipeline.run_pipeline("clip.mp4", paths,
                              fourstream_checkpoint="four.pt", device="cpu")


def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")
    return str(path)


def test_auto_detect_checkpoints(tmp_path):
    """Port run dirs (the highest (epoch, step) across every matching
    dir) ahead of reference files (the highest epoch; a non-numeric epoch
    counts as 0); plain joint/bone never match a *_motion name."""
    root = tmp_path / "save_models"
    _touch(root / "fall_joint" / "fall_joint-5-100.pt")
    _touch(root / "fall_joint" / "fall_joint-12-240.pt")
    want_joint = _touch(root / "fall_joint_v2" / "fall_joint_v2-12-300.pt")
    want_jm = _touch(root / "fall-joint-motion" / "fall-joint-motion-3-60.pt")
    _touch(root / "fall_joint" / "notes.txt")
    _touch(root / "mp_joint-99-1.pt")  # a run dir was found: ignored
    _touch(root / "mp_bone-10-1.pt")
    want_bone = _touch(root / "mp_bone-30-2.pt")
    _touch(root / "mp_bone-final-9.pt")
    want_bm = _touch(root / "mp_bone_motion-50-3.pt")
    found = pipeline.auto_detect_checkpoints(str(root))
    assert found == {"joint": want_joint, "joint_motion": want_jm,
                     "bone": want_bone, "bone_motion": want_bm}
    assert pipeline.auto_detect_checkpoints(str(tmp_path / "missing")) == {}


@pytest.mark.parametrize("names", [
    ["mp_joint-3-1.pt", "mp_joint-12-2.pt", "mp_bone-final-9.pt",
     "mp_bone_motion-4-1.pt", "mp_joint_motion-7-1.pt"],
    ["x-bone-final.pt", "y_bone-2-1.pt", "z_joint-motion-5-1.pt"],
])
def test_auto_detect_reference_files_match_reference(tmp_path, names):
    """On reference-layout files alone the port picks what the reference
    package picks."""
    for name in names:
        _touch(tmp_path / name)
    assert (pipeline.auto_detect_checkpoints(str(tmp_path))
            == jax_pipeline.auto_detect_checkpoints(str(tmp_path)))


def test_pipeline_cli_full_width_model(tmp_path, monkeypatch, capsys):
    """The CLI on the full-width MediaPipe fall model (at window 32),
    checkpoints found under --save-dir, landmarks from the pose backend."""
    from shift_gcn_torch.data.gendata import mediapipe
    from shift_gcn_torch.models.shift_gcn import Model, ModelConfig

    model = Model(ModelConfig(num_class=2, num_point=33, num_person=1,
                              graph="mediapipe_pose"), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    run_dir = tmp_path / "save" / "fall_joint"
    run_dir.mkdir(parents=True)
    torch.save({"model_state_dict": model.state_dict(), "epoch": 1,
                "global_step": 5, "best_acc": 0.0},
               run_dir / "fall_joint-1-5.pt")
    monkeypatch.setitem(mediapipe._BACKENDS, "mediapipe",
                        _stub_backend(_landmarks(48, 6)))
    out = tmp_path / "results.json"
    pipeline.main(["--video", "clip.mp4", "--save-dir",
                   str(tmp_path / "save"), "--output", str(out),
                   "--window", "32", "--stride", "16", "--device", "cpu"])
    report = json.loads(out.read_text())
    assert report["total_frames"] == 48 and report["num_windows"] == 2
    assert report["video"] == "clip.mp4"
    assert np.isfinite(report["frame_probabilities"]).all()
    assert '"num_windows": 2' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        pipeline.main(["--video", "clip.mp4", "--fourstream", "four.pt",
                       "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.main(["--video", "clip.mp4", "--save-dir",
                           str(tmp_path / "save"), "--output", str(out)])


def test_graph_inward_edges_match_reference():
    from shift_gcn_tpu.graphs import get_graph as jax_get_graph
    from shift_gcn_torch.graphs import get_graph

    for name in ("ntu_rgb_d", "ntu120_rgb_d", "mediapipe_pose"):
        assert get_graph(name).inward == jax_get_graph(name).inward, name


def test_pose_backend_registry_and_unwrapping():
    import importlib.util

    from shift_gcn_tpu.data.gendata import mediapipe as jax_mediapipe
    from shift_gcn_torch.data.gendata import mediapipe
    from shift_gcn_torch.graphs import get_graph

    assert mediapipe.MEDIAPIPE_AXES == jax_mediapipe.MEDIAPIPE_AXES
    graph = get_graph("mediapipe_pose")
    assert (graph.zaxis, graph.xaxis, graph.center_joint) == tuple(
        mediapipe.MEDIAPIPE_AXES[k]
        for k in ("zaxis", "xaxis", "center_joint"))
    world, pixels = np.zeros((3, 4, 33, 1)), np.ones((4, 33, 2))
    assert mediapipe.world_landmarks((world, pixels)) is world
    assert mediapipe.world_landmarks(world) is world
    assert mediapipe.pixel_landmarks((world, pixels)) is pixels
    assert mediapipe.pixel_landmarks(world) is None
    with pytest.raises(KeyError, match="unknown pose backend"):
        mediapipe.get_backend("no-such-backend")
    if importlib.util.find_spec("mediapipe") is None:
        with pytest.raises(ImportError, match="register_backend"):
            mediapipe.get_backend("mediapipe")
