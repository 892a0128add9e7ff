"""The port's data surface against the reference package on the CPU:
``downsample``, ``temporal_slice``, ``openpose_match`` and
``random_choose(auto_pad_short=)`` (``data/augmentations.py``),
``Feeder(use_mmap=)`` and ``BatchIterator(prefetch=)``
(``data/feeder.py``), the Trainer built from a config whose feeder
arguments set ``use_mmap``, and ``reexec_with_resume(extra_argv=)``
(``utils/device_guard.py``).

The functions are plain numpy, so every comparison is exact: the same
array (``np.array_equal``, the same dtype and shape) from the same
seeded inputs, and the same state of the random stream after the call.
One difference is deliberate: an exception of the iterator's producer
thread is raised in the port's ``epoch``, where the reference package's
epoch ends early."""

import os
import pickle
import sys
import threading
import time
import types

import numpy as np
import pytest

from shift_gcn_torch.data import augmentations as aug
from shift_gcn_torch.data import feeder as feeder_lib
from shift_gcn_torch.utils import device_guard
from shift_gcn_tpu.data import augmentations as ref_aug
from shift_gcn_tpu.data import feeder as ref_feeder_lib
from shift_gcn_tpu.utils import device_guard as ref_device_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(seed, shape=(3, 17, 5, 2)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _streams(seed):
    """Two generators in the same state, one for each package."""
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("seeded", [False, True], ids=["rng_none", "rng"])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_downsample_matches_reference(step, seeded):
    data = _clip(step)  # T=17: neither 2 nor 3 divides it
    port_rng, ref_rng = _streams(10 + step) if seeded else (None, None)
    _same(aug.downsample(data, step, port_rng),
          ref_aug.downsample(data, step, ref_rng))
    if seeded:
        assert port_rng.integers(1 << 30) == ref_rng.integers(1 << 30)


@pytest.mark.parametrize("step", [1, 2, 3, 6])
def test_temporal_slice_matches_reference(step):
    data = _clip(step, (3, 12, 5, 2))
    got = aug.temporal_slice(data, step)
    assert got.shape == (3, 12 // step, 5, 2 * step)
    _same(got, ref_aug.temporal_slice(data, step))


@pytest.mark.parametrize("step", [5, 7])
def test_temporal_slice_raises_alike_where_step_does_not_divide(step):
    data = _clip(step, (3, 12, 5, 2))
    with pytest.raises(Exception) as ref_err:
        ref_aug.temporal_slice(data, step)
    with pytest.raises(type(ref_err.value)):
        aug.temporal_slice(data, step)


def _tracks(m, t=24, v=6, seed=0):
    """(3, T, V, M) clips of ``m`` people apart from each other, each
    moving a little a frame, with a confidence of its own; and the same
    clip with the people's slots permuted from frame T/2 on."""
    rng = np.random.default_rng(seed)
    base = np.zeros((3, t, v, m), np.float32)
    for p in range(m):
        start = rng.uniform(-1, 1, (2, 1, v)) + 10.0 * p
        steps = rng.normal(0, 0.01, (2, t, v)).cumsum(axis=1)
        base[0:2, :, :, p] = start + steps
        base[2, :, :, p] = 0.3 + 0.2 * p + rng.uniform(0, 0.01, (t, v))
    swapped = base.copy()
    perm = np.roll(np.arange(m), 1)
    swapped[:, t // 2:] = base[:, t // 2:][..., perm]
    return base, swapped


@pytest.mark.parametrize("m", [2, 3])
def test_openpose_match_matches_reference(m):
    base, swapped = _tracks(m, seed=m)
    got = aug.openpose_match(swapped)
    _same(got, ref_aug.openpose_match(swapped))
    # the swap is undone and the tracks come out by falling confidence
    order = np.argsort(-base[2].sum(axis=(0, 1)))
    _same(got, base[..., order])


@pytest.mark.parametrize("t", [12, 20, 31], ids=["short", "equal", "long"])
@pytest.mark.parametrize("pad", [True, False], ids=["pad", "no_pad"])
def test_random_choose_matches_reference(pad, t):
    data = _clip(t, (3, t, 5, 2))
    port_rng, ref_rng = _streams(t)
    got = aug.random_choose(data, 20, port_rng, auto_pad_short=pad)
    _same(got, ref_aug.random_choose(data, 20, ref_rng, auto_pad_short=pad))
    assert got.shape[1] == (t if t < 20 and not pad else 20)
    assert port_rng.integers(1 << 30) == ref_rng.integers(1 << 30)


def _write_split(root, n=11, t=24, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 3, t, 5, 2)).astype(np.float32)
    data[:, :, t - 4:] = 0.0  # trailing empty frames, as gendata leaves
    paths = {"data_path": os.path.join(root, "data.npy"),
             "label_path": os.path.join(root, "label.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(n)],
                     rng.integers(0, 3, n).tolist()), f)
    return paths


AUGMENTED = {"random_choose": True, "random_move": True,
             "random_shift": True, "window_size": 16}


@pytest.mark.parametrize("use_mmap", [False, True])
def test_feeder_use_mmap_matches_reference(tmp_path, use_mmap):
    paths = _write_split(str(tmp_path))
    args = dict(paths, use_mmap=use_mmap, normalization=True, **AUGMENTED)
    port = feeder_lib.Feeder(**args)
    ref = ref_feeder_lib.Feeder(**args)
    assert isinstance(port.data, np.memmap) == use_mmap
    assert isinstance(port.data, np.ndarray)
    _same(port.data, np.asarray(ref.data))
    port_rng, ref_rng = _streams(3)
    for i in range(len(ref)):
        _same(port.get(i, port_rng), ref.get(i, ref_rng))
    assert port.label == ref.label and port.sample_name == ref.sample_name


def _parent_epoch(it, epoch):
    """The port's epoch before the producer thread: the batches built in
    the caller's thread, one after another."""
    order = it._epoch_indices(epoch)
    rng = np.random.default_rng(it.seed + 7919 * epoch + 104729 * it.host_id)
    return [it._make_batch(order[b * it.batch_size:(b + 1) * it.batch_size],
                           rng) for b in range(it.batches_per_epoch())]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same(a, b)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_batch_iterator_prefetch_matches_reference(tmp_path, prefetch):
    paths = _write_split(str(tmp_path))
    its = [lib.BatchIterator(lib.Feeder(**paths, **AUGMENTED), 4,
                             shuffle=True, drop_last=False, seed=5,
                             prefetch=prefetch)
           for lib in (feeder_lib, ref_feeder_lib)]
    assert its[0].prefetch == prefetch
    for epoch in (0, 1):
        got = list(its[0].epoch(epoch))
        assert got[-1][3].tolist() == [1.0, 1.0, 1.0, 0.0]  # 11 = 2*4 + 3
        _same_batches(got, list(its[1].epoch(epoch)))
        _same_batches(got, _parent_epoch(its[0], epoch))


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "BatchIterator.epoch" and t.is_alive()]


def _bounded(fn, timeout=30.0):
    """Run ``fn`` on a thread joined with a timeout: a producer that never
    ends fails the test instead of hanging it.  Returns what ``fn``
    returns, and raises what it raises."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as err:  # raised again below
            out["err"] = err

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout)
    assert not worker.is_alive(), "the epoch did not end"
    if "err" in out:
        raise out["err"]
    return out.get("value")


# the reference package's producer thread dies of the planted error
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("end", ["producer_raises", "consumer_stops"])
def test_epoch_producer_errors_and_early_stop(tmp_path, end):
    """A producer exception reaches the consumer (the reference package
    ends the epoch early instead); a consumer that stops early ends the
    producer."""
    paths = _write_split(str(tmp_path))
    port = feeder_lib.Feeder(**paths)
    ref = ref_feeder_lib.Feeder(**paths)
    if end == "producer_raises":
        for f in (port, ref):
            get = f.get

            def broken(i, rng=None, get=get):
                if i == 9:
                    raise OSError("clip 9 unreadable")
                return get(i, rng)

            f.get = broken
        got = []

        def consume():
            for batch in feeder_lib.BatchIterator(port, 4).epoch(0):
                got.append(batch)

        with pytest.raises(OSError, match="clip 9 unreadable"):
            _bounded(consume)
        assert len(got) == 2
        assert len(_bounded(lambda: list(
            ref_feeder_lib.BatchIterator(ref, 4).epoch(0)))) == 2
    else:
        def stop_after_one():
            epoch = feeder_lib.BatchIterator(port, 1, prefetch=1).epoch(0)
            first = next(epoch)
            time.sleep(0.05)  # the producer fills the queue and waits
            epoch.close()
            return first

        _same(_bounded(stop_after_one)[0][0], np.asarray(port.data[0]))
    assert not _producers()


def test_epochs_stopped_at_random_points_under_thread_switching(tmp_path):
    """Stress: 12 consumers (more than this machine's cores), each reading
    epochs of its own iterator to a random batch and closing it after a
    random pause (so that the producer is sometimes waiting on a full
    queue), with the interpreter switching threads every microsecond.
    Each reads the serial loop's batches up to where it stopped, and no
    producer is left running."""
    paths = _write_split(str(tmp_path), n=24, t=12)
    errors = []

    def consumer(k):
        rng = np.random.default_rng(k)
        it = feeder_lib.BatchIterator(
            feeder_lib.Feeder(**paths, random_move=True), 2, shuffle=True,
            seed=k, prefetch=k % 3)
        try:
            for epoch in range(6):
                stop = int(rng.integers(0, it.batches_per_epoch() + 1))
                want = _parent_epoch(it, epoch)[:stop]
                batches = it.epoch(epoch)
                got = [b for _, b in zip(range(stop), batches)]
                time.sleep(float(rng.uniform(0, 0.01)))
                batches.close()
                _same_batches(got, want)
        except BaseException as err:  # reported by the main thread
            errors.append(err)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consumer, args=(k,), daemon=True)
                   for k in range(12)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads), "a consumer hung"
    finally:
        sys.setswitchinterval(saved)
    assert not errors, errors[0]
    assert not _producers()


def test_trainer_takes_use_mmap_from_the_config(tmp_path):
    """configs/smoke.yaml with ``use_mmap: false`` in both feeder
    arguments: the Trainer builds (a TypeError before the port took the
    key), its feeders hold the clips in memory, and its train epoch's
    batches are the reference package's on the same data."""
    from shift_gcn_torch.train import config
    from shift_gcn_torch.train.trainer import Trainer

    rng = np.random.default_rng(7)
    labels = rng.integers(0, 2, 10)
    data = rng.standard_normal((10, 3, 20, 33, 1)).astype(np.float32)
    paths = {"data_path": str(tmp_path / "data.npy"),
             "label_path": str(tmp_path / "label.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(10)], labels.tolist()), f)
    args = dict(paths, use_mmap=False)
    cfg = config.load_config([
        "--config", os.path.join(REPO, "configs", "smoke.yaml"),
        "--work_dir", str(tmp_path / "work"),
        "--model_saved_name", str(tmp_path / "save"),
        "--train_feeder_args", repr(args), "--test_feeder_args", repr(args),
        "--batch_size", "4", "--test_batch_size", "4"])
    trainer = Trainer(cfg, device="cpu")
    for feeder in trainer.feeders.values():
        assert not isinstance(feeder.data, np.memmap)
        _same(feeder.data, data)
    ref = ref_feeder_lib.BatchIterator(
        ref_feeder_lib.Feeder(**args), 4, shuffle=True, drop_last=True,
        seed=cfg.seed)
    _same_batches(list(trainer.iterators["train"].epoch(0)),
                  list(ref.epoch(0)))


@pytest.mark.parametrize("extra", [
    None, ["--num_epoch", "3"], ["--resume", "save/run-1-9.pt", "--x", "1"]],
    ids=["none", "flags", "resume"])
def test_reexec_extra_argv_builds_the_reference_argv(monkeypatch, extra):
    argv = ["train.py", "--config", "c.yaml", "--overwrite", "true"]
    calls = []

    def fake_execve(path, new_argv, env):
        calls.append(list(new_argv))
        raise SystemExit

    # the reference rebuilds ``python -m <module>`` from __main__'s spec
    main = types.ModuleType("__main__")
    main.__spec__ = types.SimpleNamespace(name="shift_gcn_tpu.cli.train")
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.setattr(sys, "argv", argv)
    for lib in (device_guard, ref_device_guard):
        monkeypatch.setenv(lib._REEXEC_ENV, "0")
        monkeypatch.setattr(lib.os, "execve", fake_execve)
        monkeypatch.setattr(lib.time, "sleep", lambda s: None)
        with pytest.raises(SystemExit):
            lib.reexec_with_resume(extra_argv=extra)
    port, ref = calls
    assert port == [a.replace("shift_gcn_tpu", "shift_gcn_torch")
                    for a in ref]
    assert port[port.index("--resume") + 1] == "auto"
    assert port[port.index("--overwrite") + 1] == "false"
    for flag in (extra or [])[::2]:
        assert flag in port
