"""The port's span registry (``shift_gcn_torch/utils/trace.py``) and the
spans that the serving pipeline and the Trainer open, on the CPU."""

import os
import pickle
import sys
import threading
import types

import numpy as np
import pytest
import torch

from shift_gcn_torch.inference import pipeline
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.train import config
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils import trace

ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}
SERVE = ("serve.report", "serve.windows", "serve.pre_normalization",
         "serve.modalities", "serve.h2d", "serve.forward", "serve.readback")


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward is unsafe on the CPU once JAX's
    # compiled code has run in the process (the test session imports it);
    # torch's native convolution has the same arithmetic
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.fixture(autouse=True)
def empty_registry():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def clock(monkeypatch):
    """A clock that advances by the next scripted step at each read."""
    steps = []
    now = [0]

    def perf_counter_ns():
        now[0] += steps.pop(0)
        return now[0]

    monkeypatch.setattr(trace, "time",
                        types.SimpleNamespace(perf_counter_ns=perf_counter_ns))
    return steps


def test_nesting_gives_self_time(clock):
    # outer opens at 10, inner runs 20..50, a second inner 60..65, outer
    # closes at 110
    clock.extend([10, 10, 30, 10, 5, 45])
    with trace.span("outer") as outer:
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            pass
    snap = trace.snapshot()
    assert outer.ns == 100
    assert snap["outer"]["count"] == 1
    assert snap["outer"]["total_s"] == pytest.approx(100e-9)
    assert snap["outer"]["self_s"] == pytest.approx(65e-9)
    assert snap["inner"]["count"] == 2
    assert snap["inner"]["total_s"] == pytest.approx(35e-9)
    assert snap["inner"]["self_s"] == pytest.approx(35e-9)
    assert snap["inner"]["recent_s"] == pytest.approx([30e-9, 5e-9])


def test_a_span_that_raises_still_counts(clock):
    clock.extend([1, 7, 1, 1, 3, 2])
    with pytest.raises(ValueError):
        with trace.span("broken"):
            raise ValueError("inside")
    assert trace.snapshot()["broken"]["count"] == 1
    # the stack of open spans was unwound: "after" has no parent
    with trace.span("after"):
        with trace.span("after.child"):
            pass
    snap = trace.snapshot()
    assert snap["after"]["total_s"] == pytest.approx(6e-9)
    assert snap["after"]["self_s"] == pytest.approx(3e-9)


def test_spans_of_two_threads_do_not_mix():
    """B's span runs entirely inside A's open span, on another thread: A's
    self time stays its whole duration."""
    opened, done = threading.Event(), threading.Event()

    def a():
        with trace.span("a.outer"):
            opened.set()
            assert done.wait(10)

    def b():
        assert opened.wait(10)
        with trace.span("b.inner"):
            with trace.span("b.leaf"):
                pass
        done.set()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    snap = trace.snapshot()
    assert snap["a.outer"]["self_s"] == snap["a.outer"]["total_s"]
    assert snap["b.inner"]["self_s"] < snap["b.inner"]["total_s"]
    assert snap["b.leaf"]["count"] == snap["b.inner"]["count"] == 1


def test_no_update_is_lost_across_threads():
    threads, per_thread = 8, 2000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                with trace.span("stress.outer"):
                    with trace.span("stress.inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    snap = trace.snapshot()
    assert snap["stress.outer"]["count"] == threads * per_thread
    assert snap["stress.inner"]["count"] == threads * per_thread
    # every inner span closed inside its own thread's outer span
    assert snap["stress.outer"]["self_s"] == pytest.approx(
        snap["stress.outer"]["total_s"] - snap["stress.inner"]["total_s"])


def test_duration_ring_is_bounded(clock):
    n = trace.RING + 10
    for i in range(n):
        clock.extend([1, i + 1])
        with trace.span("ring"):
            pass
    entry = trace.snapshot()["ring"]
    assert entry["count"] == n
    assert len(entry["recent_s"]) == trace.RING
    # the oldest ten durations (1..10 ns) fell out
    assert entry["recent_s"][0] == pytest.approx(11e-9)
    assert entry["recent_s"][-1] == pytest.approx(n * 1e-9)
    assert entry["total_s"] == pytest.approx(n * (n + 1) / 2 * 1e-9)


def test_reset_and_snapshot_are_plain():
    with trace.span("x"):
        pass
    snap = trace.snapshot()
    snap["x"]["count"] = 99
    assert trace.snapshot()["x"]["count"] == 1
    trace.reset()
    assert trace.snapshot() == {}


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("quiet"):
        with trace.span("quiet.inner"):
            pass
    assert trace.snapshot()["quiet"]["count"] == 1


def _predictor(streams=pipeline.MODALITY_ORDER):
    cfg = config_from_reference_args(ARGS)
    torch.manual_seed(0)
    states = {m: Model(cfg, device="cpu").state_dict() for m in streams}
    return pipeline.EnsemblePredictor(states, model_config=cfg, device="cpu")


def _landmarks(t=90, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (3, t, 33, 1)).astype(np.float32)


def test_run_on_landmarks_counts_its_spans():
    predictor = _predictor()
    trace.reset()
    report = pipeline.run_on_landmarks(_landmarks(), predictor, window=32,
                                       stride=16)
    assert report["num_windows"] == 5
    snap = trace.snapshot()
    counts = {name: snap[name]["count"] for name in SERVE}
    assert counts == {"serve.report": 1, "serve.windows": 1,
                      "serve.pre_normalization": 1, "serve.modalities": 1,
                      "serve.h2d": 4, "serve.forward": 4,
                      "serve.readback": 1}
    inside = sum(snap[name]["total_s"] for name in SERVE[1:])
    assert snap["serve.report"]["self_s"] == pytest.approx(
        snap["serve.report"]["total_s"] - inside, abs=1e-9)
    assert set(snap) == set(SERVE)


def test_profiler_shows_the_spans_nested():
    from torch.profiler import ProfilerActivity, profile

    predictor = _predictor(("joint", "bone"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.run_on_landmarks(_landmarks(), predictor, window=32,
                                  stride=16)
    events = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    names = {e.name for e in events}
    assert {trace.PREFIX + n for n in SERVE} <= names
    report = next(e for e in events if e.name == "sgt::serve.report")
    forwards = [e for e in events if e.name == "sgt::serve.forward"]
    assert len(forwards) == 2
    for e in forwards:
        assert report.time_range.start <= e.time_range.start
        assert e.time_range.end <= report.time_range.end
    # the counts of the registry are kept under the profiler too
    assert trace.snapshot()["serve.forward"]["count"] == 2


def _write_dataset(root, n, t, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32) * 0.1
    np.save(os.path.join(root, "data.npy"), data)
    with open(os.path.join(root, "label.pkl"), "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(n)], labels.tolist()), f)
    return {"data_path": os.path.join(root, "data.npy"),
            "label_path": os.path.join(root, "label.pkl")}


def test_train_epoch_counts_its_spans(tmp_path):
    paths = _write_dataset(str(tmp_path), 12, 16, 1)
    cfg = config.ExperimentConfig(
        work_dir=str(tmp_path / "work"),
        model_saved_name=str(tmp_path / "save"), train_feeder_args=paths,
        test_feeder_args=paths, model_args=dict(ARGS), batch_size=4,
        test_batch_size=4, num_epoch=1, print_log=False)
    trainer = Trainer(cfg, device="cpu")
    nb = trainer.iterators["train"].batches_per_epoch()
    assert nb == 3
    trace.reset()
    stats = trainer.train_epoch(0)
    snap = trace.snapshot()
    assert {name: snap[name]["count"] for name in snap} == {
        "train.epoch_start": 1, "train.step": nb,
        "train.feeder_wait": nb, "train.epoch_end": 1}
    assert 0.0 < stats["dataloader_share"] < 1.0
    assert len(stats["losses"]) == nb
