"""The port's native batch loader (shift_gcn_torch.data.native_loader)
against numpy indexing, as tests/test_native_loader.py holds the
reference package's; the feeder's native batch against its Python batch
and against the reference package's feeder; and the build: into the
port's _build/ directory, raising when g++ is missing."""

import os
import pickle
import shutil

import numpy as np
import pytest

from shift_gcn_tpu.data import feeder as jax_feeder
from shift_gcn_torch.data import feeder, native_loader
from shift_gcn_torch.data.native_loader import (
    NativeClipLoader, NativeLoaderUnavailable)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "data.npy"
    rng = np.random.default_rng(0)
    data = rng.standard_normal((20, 3, 8, 5, 1)).astype(np.float32)
    np.save(path, data)
    return str(path), data


def test_shape_and_gather(dataset):
    path, data = dataset
    loader = NativeClipLoader(path, num_threads=2)
    assert loader.shape == data.shape
    idx = np.array([3, 0, 19, 7])
    np.testing.assert_array_equal(loader.gather(idx), data[idx])
    loader.close()


def test_prefetch_roundtrip(dataset):
    path, data = dataset
    loader = NativeClipLoader(path, num_threads=2)
    idx1, idx2 = np.array([1, 2, 3]), np.array([4, 5, 6])
    loader.prefetch(idx1)
    with pytest.raises(RuntimeError, match="already outstanding"):
        loader.prefetch(idx2)
    got1 = loader.wait()
    loader.prefetch(idx2)
    got2 = loader.wait()
    np.testing.assert_array_equal(got1, data[idx1])
    np.testing.assert_array_equal(got2, data[idx2])
    with pytest.raises(RuntimeError, match="no outstanding"):
        loader.wait()
    loader.close()


def test_second_prefetch_raises_after_the_gather_finished(dataset):
    # the worker clears its busy flag as soon as the gather ends, so a
    # second prefetch before wait() must be refused by the wrapper: the
    # first batch's buffer has not been handed out yet
    path, data = dataset
    loader = NativeClipLoader(path, num_threads=2)
    idx = np.array([7, 8, 9])
    loader.prefetch(idx)
    loader._lib.sgt_wait(loader._handle)  # the worker is idle now
    with pytest.raises(RuntimeError, match="already outstanding"):
        loader.prefetch(np.array([1]))
    np.testing.assert_array_equal(loader.wait(), data[idx])
    loader.close()


def test_out_of_range_raises(dataset):
    path, _ = dataset
    loader = NativeClipLoader(path, num_threads=2)
    with pytest.raises(IndexError):
        loader.gather(np.array([99]))
    with pytest.raises(IndexError):
        loader.prefetch(np.array([-1]))
    loader.close()


def test_float64_input_converts(tmp_path):
    data = np.arange(40, dtype=np.float64).reshape(4, 10)
    path = tmp_path / "f8.npy"
    np.save(path, data)
    loader = NativeClipLoader(str(path))
    out = loader.gather(np.array([2, 1]))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, data[[2, 1]].astype(np.float32))
    loader.close()


def test_unreadable_file_raises(tmp_path):
    np.save(tmp_path / "ints.npy", np.arange(8, dtype=np.int32))
    with pytest.raises(NativeLoaderUnavailable, match="rejected"):
        NativeClipLoader(str(tmp_path / "ints.npy"))
    with pytest.raises(NativeLoaderUnavailable, match="rejected"):
        NativeClipLoader(str(tmp_path / "missing.npy"))


def test_builds_into_the_port_not_native(monkeypatch, tmp_path):
    """The library is built from the port's copy of the source (the
    repository's native/sgt_loader.cpp, code unchanged) into the build
    directory, under a name hashed from the source, and reused while it
    is up to date; nothing is written next to the source."""
    assert native_loader.BUILD_DIR == (
        native_loader.PACKAGE / "_build")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    csrc = sorted(os.listdir(native_loader.SOURCE.parent))
    lib = native_loader.build()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib.name.startswith("libsgt_loader-") and lib.suffix == ".so"
    mtime = os.path.getmtime(lib)
    assert native_loader.build() == lib
    assert os.path.getmtime(lib) == mtime  # up to date: not rebuilt
    assert sorted(os.listdir(native_loader.SOURCE.parent)) == csrc
    with open(os.path.join(REPO, "native", "sgt_loader.cpp")) as f:
        reference = f.read()
    code = native_loader.SOURCE.read_text()
    start = "#include <atomic>"
    assert code[code.index(start):] == reference[reference.index(start):]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    assert shutil.which("g++") is None
    with pytest.raises(NativeLoaderUnavailable, match="could not build"):
        native_loader.build()


def _write(root, n, t, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32)
    np.save(os.path.join(root, "data.npy"), data)
    with open(os.path.join(root, "label.pkl"), "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(n)],
                     rng.integers(0, 2, n).tolist()), f)
    return {"data_path": os.path.join(root, "data.npy"),
            "label_path": os.path.join(root, "label.pkl")}


@pytest.mark.parametrize("shuffle, drop_last, batch", [
    (True, True, 6), (False, False, 8)])
def test_feeder_native_batch_matches_python_and_reference(
        tmp_path, shuffle, drop_last, batch):
    paths = _write(str(tmp_path), 21, 12, 1)
    native = feeder.Feeder(**paths, native=True, native_threads=3)
    assert native.supports_native_batch()
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=4)
    got = feeder.BatchIterator(native, batch, **kw)
    plain = feeder.BatchIterator(feeder.Feeder(**paths), batch, **kw)
    ref = jax_feeder.BatchIterator(jax_feeder.Feeder(**paths), batch, **kw)
    for epoch in (0, 2):
        a, b, c = (list(x.epoch(epoch)) for x in (got, plain, ref))
        assert len(a) == len(b) == len(c) == got.batches_per_epoch()
        for xs, ys, zs in zip(a, b, c):
            for x, y, z in zip(xs, ys, zs):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)


def test_feeder_native_paths(tmp_path, monkeypatch):
    """Augmenting feeders take the Python path; debug truncation opens no
    loader; a loader that cannot be built raises instead of falling back
    to numpy."""
    paths = _write(str(tmp_path), 6, 12, 2)
    assert not feeder.Feeder(**paths, native=True,
                             random_move=True).supports_native_batch()
    assert not feeder.Feeder(**paths, native=True,
                             window_size=8).supports_native_batch()
    debug = feeder.Feeder(**paths, native=True, debug=True)
    assert debug.native_loader is None
    assert feeder.Feeder(**paths).native_loader is None

    def unavailable():
        raise NativeLoaderUnavailable("no compiler")

    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "build", unavailable)
    with pytest.raises(NativeLoaderUnavailable, match="no compiler"):
        feeder.Feeder(**paths, native=True)
