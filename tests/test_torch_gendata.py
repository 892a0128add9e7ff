"""The port's data-generation copies (``shift_gcn_torch/data/gendata``:
``ntu``, ``modality_cli`` and the dataset half of ``mediapipe``) against
the reference package's modules on the same synthetic inputs: the
``.npy`` files and the label pickles they write must be equal byte for
byte.  NTU from synthetic ``.skeleton`` files (tests/test_gendata.py's
writer, one to three bodies), the packaged missing-skeleton manifests
through each CLI; bone and motion from one joint file; the MediaPipe
NTU fall split and the label-map mode through a fake pose backend,
registered with ``register_backend`` on both sides for the CLIs."""

import hashlib
import os

import numpy as np
import pytest

from shift_gcn_tpu.data.gendata import mediapipe as jax_mp
from shift_gcn_tpu.data.gendata import modality_cli as jax_modality
from shift_gcn_tpu.data.gendata import ntu as jax_ntu
from shift_gcn_torch.data.gendata import mediapipe, modality_cli, ntu
from test_gendata import _write_skeleton_file


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _files(got_root), _files(want_root)
    assert sorted(got) == sorted(want)
    assert any(k.endswith(".npy") for k in want)
    for name, data in want.items():
        assert got[name] == data, name


@pytest.fixture(scope="module")
def skeletons(tmp_path_factory):
    root = tmp_path_factory.mktemp("skeletons")
    # train / val under both NTU-60 benchmarks, 1-3 bodies (top-2 energy
    # selection), one sample named in the packaged manifest
    for name, frames, bodies in (
            ("S001C001P001R001A043", 12, 1), ("S001C002P003R001A001", 9, 2),
            ("S002C003P002R002A010", 14, 3), ("S001C001P004R001A002", 7, 1)):
        _write_skeleton_file(root / f"{name}.skeleton", frames,
                             bodies_per_frame=bodies)
    listed = open(ntu.default_ignored_samples("xsub")).readline().strip()
    _write_skeleton_file(root / f"{listed}.skeleton", 8)
    return root


def test_manifests_and_read_xyz_are_identical(skeletons):
    for benchmark in ("xsub", "ntu120-xsetup"):
        with open(ntu.default_ignored_samples(benchmark), "rb") as f:
            got = f.read()
        with open(jax_ntu.default_ignored_samples(benchmark), "rb") as f:
            assert got == f.read(), benchmark
    for path in sorted(skeletons.iterdir()):
        got, want = ntu.read_xyz(str(path)), jax_ntu.read_xyz(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ignored", ["auto", "none"])
def test_ntu_cli_writes_identical_files(skeletons, tmp_path, ignored):
    args = ["--data-path", str(skeletons), "--benchmark", "xsub", "xview",
            "--part", "train", "val", "--ignored-sample-path", ignored]
    ntu.main(args + ["--out-folder", str(tmp_path / "port")])
    jax_ntu.main(args + ["--out-folder", str(tmp_path / "ref")])
    _assert_same_tree(tmp_path / "port", tmp_path / "ref")


def test_modality_cli_writes_identical_files(tmp_path):
    rng = np.random.default_rng(4)
    for side in ("port", "ref"):
        os.makedirs(tmp_path / side)
        for split in ("train", "val"):
            np.save(tmp_path / side / f"{split}_data_joint.npy",
                    rng.standard_normal((5, 3, 12, 33, 1)).astype(np.float32)
                    if side == "port" else np.load(
                        tmp_path / "port" / f"{split}_data_joint.npy"))
    modality_cli.main(["--data-dir", str(tmp_path / "port"), "--graph",
                       "mediapipe"])
    jax_modality.main(["--data-dir", str(tmp_path / "ref"), "--graph",
                       "mediapipe"])
    _assert_same_tree(tmp_path / "port", tmp_path / "ref")
    assert len(_files(tmp_path / "port")) == 8  # joint, bone, 2 motions


def _fake_backend(path, max_frame):
    """Landmarks drawn from the video's name (the same on both sides
    whatever the call order); none for names containing "empty"."""
    if "empty" in path:
        return None
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(
        os.path.basename(path).encode()).digest()[:4], "little"))
    t = 20 + len(os.path.basename(path)) % 17
    world = rng.standard_normal((3, t, 33, 1)).astype(np.float32)
    return world, rng.standard_normal((t, 33, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    for name in ("S001C001P001R001A043.mp4", "S001C002P001R001A001.avi",
                 "S001C001P002R001A007.mkv", "S001C003P004R002A043.mp4",
                 "S001C001P003R001A043.mp4", "S001C002P003R001A009.mp4",
                 "S001C001P008R001A011.mp4", "notes.txt"):
        (root / name).touch()
    for name in ("fall/a.mp4", "fall/b.mp4", "walk/c.mp4", "walk/empty.mp4",
                 "fall_99.mp4", "unknown_x.mp4"):
        (root / "labeled" / name).parent.mkdir(parents=True, exist_ok=True)
        (root / "labeled" / name).touch()
    return root


@pytest.mark.parametrize("benchmark,ratio", [("xsub", 0.5), ("xview", 1.0),
                                             ("xsub", 0.0)])
def test_ntu_fall_split_writes_identical_files(videos, tmp_path, benchmark,
                                               ratio):
    for module, side in ((mediapipe, "port"), (jax_mp, "ref")):
        module.gendata_ntu_fall(
            str(videos), str(tmp_path / side), benchmark=benchmark,
            subsample_ratio=ratio, max_frame=32, seed=7,
            backend=_fake_backend)
    _assert_same_tree(tmp_path / "port", tmp_path / "ref")


def test_label_map_mode_and_clis_write_identical_files(videos, tmp_path):
    labeled = videos / "labeled"
    label_map = {"fall": 1, "walk": 0}
    split = tmp_path / "train.txt"
    split.write_text("fall/a.mp4\nwalk/c.mp4\nwalk/empty.mp4\n")
    assert mediapipe.parse_label_map("fall: 1, walk :0") == \
        jax_mp.parse_label_map("fall: 1, walk :0") == label_map
    assert mediapipe.resolve_label(str(labeled / "fall_99.mp4"),
                                   label_map) == 1
    for module, side in ((mediapipe, "port"), (jax_mp, "ref")):
        out = tmp_path / side
        module.gendata_label_map(str(labeled), str(out / "all"), label_map,
                                 max_frame=16, backend=_fake_backend)
        module.gendata_label_map(str(labeled), str(out / "split"),
                                 label_map, split_file=str(split),
                                 part="train", max_frame=16,
                                 backend=_fake_backend)
        # the CLI's two modes through the registered backend
        module.register_backend("mediapipe", _fake_backend)
        try:
            module.main(["--video-dir", str(labeled), "--out-dir",
                         str(out / "cli"), "--label-map", "fall:1,walk:0",
                         "--train-split", str(split), "--max-frame", "8"])
            module.main(["--video-dir", str(videos), "--out-dir",
                         str(out / "cli_ntu"), "--ntu-mode",
                         "--subsample-ratio", "0.5", "--max-frame", "8"])
        finally:
            module._BACKENDS.pop("mediapipe", None)
    with pytest.raises(FileNotFoundError, match="split file"):
        mediapipe.gendata_label_map(str(labeled), str(tmp_path / "x"),
                                    label_map,
                                    split_file=str(tmp_path / "nope.txt"),
                                    backend=_fake_backend)
    _assert_same_tree(tmp_path / "port", tmp_path / "ref")
