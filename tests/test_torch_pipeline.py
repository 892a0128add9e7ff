"""Port serving path (shift_gcn_torch.inference.pipeline) vs the
reference package's pipeline on the CPU, from the same exported
reference ``.pt`` checkpoints; plus the port's import hygiene."""

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
