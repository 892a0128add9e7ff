"""The port's tools against the reference package's: ``utils/visualize.py``
(the adjacency heatmaps and a skeleton animation, images equal pixel for
pixel through the Agg backend) and ``inference/gui.py``'s
``resolve_checkpoints`` (the same answers on the layouts both read, and
the port Trainer's own run dirs); ``inference.gui`` imports without
tkinter.  The Tk window is not tested."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")
Image = pytest.importorskip("PIL.Image")

from shift_gcn_tpu.inference import gui as jax_gui  # noqa: E402
from shift_gcn_tpu.utils import visualize as jax_visualize  # noqa: E402
from shift_gcn_torch.inference import gui  # noqa: E402
from shift_gcn_torch.utils import visualize  # noqa: E402


def _frames(path):
    """Every frame of an image file, decoded to RGBA arrays."""
    with Image.open(path) as image:
        frames = []
        for i in range(getattr(image, "n_frames", 1)):
            image.seek(i)
            frames.append(np.asarray(image.convert("RGBA")))
    return frames


def _assert_same_image(got, want):
    got, want = _frames(got), _frames(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph", ["ntu_rgb_d", "mediapipe_pose"])
def test_plot_adjacency_equals_reference(tmp_path, graph):
    got, want = tmp_path / "port.png", tmp_path / "ref.png"
    assert visualize.plot_adjacency(graph, save_path=str(got)) == str(got)
    jax_visualize.plot_adjacency(graph, save_path=str(want))
    _assert_same_image(got, want)


def test_animate_skeleton_equals_reference(tmp_path):
    rng = np.random.default_rng(0)
    clip = rng.uniform(-0.8, 0.8, (3, 5, 25, 2)).astype(np.float32)
    clip[:, :, 3, 1] = 0  # an absent joint: its bones are drawn empty
    got, want = tmp_path / "port.gif", tmp_path / "ref.gif"
    visualize.animate_skeleton(clip, "ntu_rgb_d", save_path=str(got),
                               fps=10)
    jax_visualize.animate_skeleton(clip, "ntu_rgb_d", save_path=str(want),
                                   fps=10)
    assert len(_frames(got)) == 5
    _assert_same_image(got, want)


def _touch(*parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()
    return path


def test_resolve_checkpoints_agrees_with_reference(tmp_path):
    root = str(tmp_path / "refs")
    weights = _touch(root, "fall_joint-30-1000.pt")
    for name in ("fall_joint-10-300.pt", "fall_bone-20-600.pt",
                 "fall_joint_motion-5-100.pt", "fall_bone_motion-final.pt"):
        _touch(root, name)
    pkl = _touch(str(tmp_path), "scores", "w.pkl")
    for path in (weights, pkl, root, str(tmp_path / "missing")):
        assert gui.resolve_checkpoints(path) == \
            jax_gui.resolve_checkpoints(path), path
    assert gui.resolve_checkpoints(root) == ({
        "joint": weights, "bone": os.path.join(root, "fall_bone-20-600.pt"),
        "joint_motion": os.path.join(root, "fall_joint_motion-5-100.pt"),
        "bone_motion": os.path.join(root, "fall_bone_motion-final.pt")},
        None)


def test_resolve_checkpoints_reads_port_run_dirs(tmp_path):
    save = str(tmp_path / "save_models")
    joint = os.path.join(save, "mediapipe_ShiftGCN_joint")
    newest = _touch(joint, "mediapipe_ShiftGCN_joint-1-16.pt")
    _touch(joint, "mediapipe_ShiftGCN_joint-0-8.pt")
    four = os.path.join(save, "mediapipe_ShiftGCN_fourstream")
    _touch(four, "mediapipe_ShiftGCN_fourstream-0-8.pt")
    four_newest = _touch(four, "mediapipe_ShiftGCN_fourstream-2-24.pt")
    bone = _touch(save, "mediapipe_ShiftGCN_bone",
                  "mediapipe_ShiftGCN_bone-3-32.pt")
    plain = _touch(str(tmp_path), "smoke", "smoke-4-40.pt")
    assert gui.resolve_checkpoints(joint) == ({"joint": newest}, None)
    assert gui.resolve_checkpoints(four) == (None, four_newest)
    assert gui.resolve_checkpoints(os.path.dirname(plain)) == (
        {"joint": plain}, None)
    assert gui.resolve_checkpoints(save) == (
        {"joint": newest, "bone": bone}, None)
    # the reference package's Orbax step dir: export it first
    os.makedirs(os.path.join(four, "24"))
    with pytest.raises(ValueError, match="export it to a .pt file"):
        gui.resolve_checkpoints(os.path.join(four, "24"))


def test_gui_imports_without_tkinter(monkeypatch):
    monkeypatch.setitem(sys.modules, "tkinter", None)
    module = importlib.reload(gui)
    assert callable(module.resolve_checkpoints)
    with pytest.raises(ImportError):
        module.launch(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.launch()
