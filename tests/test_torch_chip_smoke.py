"""Control flow of chip_smoke.py's live-serving phases (11-13), its
four-stream training phase (14), its lowering-knob, NTU-60 and
other-family phases (15-17), the Trainer of its custom-topology
phase (22d) and its Trainer epoch with the clips memory-mapped and in
memory (phases 9 and 23) and its shift-op demo (phase 24a), rehearsed
on the CPU at a small size: the kernels' plain versions run in place of
the kernels, so every check but the launch counts must pass, and the
launch counts must fail (the plain versions launch nothing)."""

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
FULL_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
             "graph": "mediapipe_pose"}


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


@pytest.fixture
def training_rehearsal(rehearsal, monkeypatch):
    """``rehearsal`` with the Trainer and every family on the CPU, the
    peak-memory reads stubbed and oneDNN off (its convolution backward
    corrupts the heap once the reference package's XLA code has run in
    the process, as other test files of a worker may have done)."""
    cpu = mock.Mock(return_value=torch.device("cpu"))
    for module in ("train.trainer", "models.stgcn", "models.ring_gnn"):
        monkeypatch.setattr(f"shift_gcn_torch.{module}.resolve_device", cpu)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    return rehearsal


def test_lowering_knob_phase_rehearses_on_cpu(training_rehearsal, capsys,
                                              tmp_path):
    """Phase 15 on the full-width MediaPipe model at T=40 and 4 clips."""
    config = config_from_reference_args(FULL_ARGS)
    out = chip_smoke.run_lowering_knobs(
        config, np.random.default_rng(0), torch.device("cpu"),
        str(tmp_path), 0, "card")
    # six eval forwards and four steps: only their launch counts fail
    assert len(training_rehearsal) == 10, training_rehearsal
    assert all("launch counts" in msg for msg in training_rehearsal)
    # the plain path against itself: no gap at all
    assert out["xpos_fwd"] == out["far_fwd"] == out["far_fwd16"] == 0.0
    assert out["xpos_step"] == out["far_step"] == 0.0
    for label in ("bn_lp", "bn_lp_eval off", "fp32 + compute_dtype bf16"):
        loss_gap, cos, rel, agree, fwd = out[label]
        assert loss_gap == rel == fwd == 0.0 and agree == 1.0
    printed = capsys.readouterr().out
    assert printed.count("[knobs]") == 4
    assert printed.count("[step] exact_xpos fp32") == 1
    assert "|ypos| 12 loads under 16, refused under 8" in printed


def test_ntu_phase_rehearses_on_cpu(training_rehearsal, monkeypatch, capsys,
                                    tmp_path):
    """Phase 16 on configs/nturgbd-cross-subject/train_joint.yaml at T=40,
    its batch of 64 made not to fit, so that the run falls back to 4."""
    cost = chip_smoke.step_cost

    def small_card(model, batch, *args):
        if batch["data"].shape[0] > 4:
            raise torch.cuda.OutOfMemoryError("rehearsal")
        return cost(model, batch, *args)

    monkeypatch.setattr(chip_smoke, "step_cost", small_card)
    launches, step_ms, fwd_ms, peak, batch = chip_smoke.run_ntu(
        np.random.default_rng(0), torch.Generator().manual_seed(0),
        torch.device("cpu"), str(tmp_path), "card")
    assert batch == 4 and (step_ms, fwd_ms, peak) == (1.0, 1.0, 0.0)
    # only the launch counts fail: the plain versions launch nothing
    assert len(training_rehearsal) == 1, training_rehearsal
    assert "NTU-60 launch counts" in training_rehearsal[0]
    assert set(launches.values()) == {0}
    printed = capsys.readouterr().out
    assert [f"batch {b} does not fit" in printed for b in (64, 32, 16, 8)
            ] == [True] * 4
    assert "V=25, M=2, fp32, batch 4 (64 does not fit)" in printed


def test_family_phase_rehearses_on_cpu(training_rehearsal, capsys,
                                       tmp_path):
    """Phase 17 at T=40 and 4 ST-GCN clips a batch: the families launch no
    kernel, so nothing fails."""
    times = chip_smoke.run_families(np.random.default_rng(0),
                                    torch.device("cpu"), str(tmp_path),
                                    "card")
    assert training_rehearsal == []
    assert set(times) == {"stgcn", "stgcn_embed16", "ring_gnn"}
    printed = capsys.readouterr().out
    assert printed.count("[families]") == 3
    # the "card" is the CPU here: no gap to its own fp32 run
    assert ("card vs CPU (seeded init) on 8 clips: eval: logits 0 of scale "
            "off the CPU's (tol 1e-4), gradients' relative L2 off float64") \
        in printed


def test_parallel_phase_rehearses_on_cpu(training_rehearsal, monkeypatch,
                                         capsys, tmp_path):
    """Phase 18 on the CPU: a gloo group of one rank for 18a, the kernel
    checks at the ranks' launch shapes, then the rank processes of 18b
    ([2, 1]) and 18c ([2, 2], T=64 padded to 72), full width at 4 clips,
    with 18c's planted faults caught by its gates, and 18c's step with
    remat (phase 21e) bit-equal to the step without it; only the launch
    counts fail (the plain versions launch nothing): 18a's, and each
    rank's of 18b, 18c and 21e."""
    monkeypatch.setattr(chip_smoke, "T_WINDOW", 64)
    monkeypatch.setattr(chip_smoke, "T_PAD", 72)
    out = chip_smoke.run_parallel(np.random.default_rng(0),
                                  torch.device("cpu"), str(tmp_path),
                                  "card", 0)
    assert len(training_rehearsal) == 11, training_rehearsal
    assert all("launch" in msg for msg in training_rehearsal)
    assert sum("21e" in msg for msg in training_rehearsal) == 4
    assert len(out["dp_ms"]) == 2 and len(out["seqpar_ms"]) == 4
    assert "bit-equal to the same rank's step without it" in out["remat"]
    printed = capsys.readouterr().out
    assert "in a gloo group of one rank: losses" in printed
    assert "bit-equal to the run without a group" in printed
    assert printed.count("(ranks sharing one card, not a scaling figure)") \
        == 2
    assert printed.count("ypos steps equal on 2816 of 2816, 0 flips at a "
                         "tie, 0 off one") == 6
    # the kernels at the halo-extended blocks of a time rank: T_l=36 of 72
    # with 8 frames below and 9 above, odd at stride 2
    assert ("at 13 launch shapes of a [2, 1] rank (2 rows, T=64) and 13 of "
            "a [2, 2] rank") in printed
    assert "(53, 128, 2)" in printed and "(35, 256, 2)" in printed
    for fault in chip_smoke.PLANTED_FAULTS:
        assert (f"planted fault {fault}: caught on ranks [0, 1, 2, 3] of 4"
                in printed)
    assert "parameters equal on every rank, checkpoint " \
        "mediapipe_ShiftGCN_joint_seqpar-0-2.pt, 4 clips scored" in printed


def test_rank_lines_parse_in_rank_order(rehearsal):
    text = "\n".join([
        "[ Sat ] Training epoch: 1",
        '[rank] {"rank": 1, "loss": 0.5, "launches": {"shift_gcn": 10}}',
        "[W socket.cpp] a warning",
        '[rank] {"rank": 0, "loss": 0.25, "launches": {"shift_gcn": 10}}'])
    lines = chip_smoke.parse_rank_lines(text, 2)
    assert [line["rank"] for line in lines] == [0, 1]
    assert lines[0]["loss"] == 0.25 and lines[1]["launches"] == {
        "shift_gcn": 10}
    assert rehearsal == []
    chip_smoke.parse_rank_lines(text, 3)  # rank 2 printed nothing
    assert rehearsal == ["rank lines from ranks [0, 1], expected 3"]


def test_wide_graph_phase_rehearses_on_cpu(training_rehearsal, monkeypatch,
                                           capsys, tmp_path):
    """Phase 22d at T=16 on a registered 160-joint tree (22a's kind of
    topology) through ``Trainer.start()`` with the default backbone, its
    first batch made not to fit: only the launch counts fail."""
    from shift_gcn_torch import graphs
    from shift_gcn_torch.graphs import topology

    monkeypatch.setattr(chip_smoke, "T_WINDOW", 16)
    monkeypatch.setattr(chip_smoke, "WIDE_BATCHES", (2, 1))
    monkeypatch.setattr(chip_smoke, "WIDE_STEPS", 1)
    # the probe of batch 2 peaks past the card, then 1 GiB
    peaks = [100.0]
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a: (peaks.pop() if peaks else 1.0) * 2 ** 30)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: mock.Mock(total_memory=80 * 2 ** 30))
    monkeypatch.setattr(topology, "_REGISTRY", dict(topology._REGISTRY))
    graph = chip_smoke.tree_graph("rehearsal_tree", 160, 0)
    graphs.register_graph(graph)
    launches, batch, peak, step_ms = chip_smoke.wide_graph_trainer(
        np.random.default_rng(0), torch.device("cpu"), str(tmp_path), graph,
        "card")
    assert (batch, peak, step_ms) == (1, 1.0, 1.0)
    assert set(launches.values()) == {0}
    assert len(training_rehearsal) == 1, training_rehearsal
    assert "22d: launch counts" in training_rehearsal[0]
    printed = capsys.readouterr().out
    assert "22d: batch 2 does not fit (step peak 100.00 GiB" in printed
    assert "graph 'rehearsal_tree' (V=160, registered)" in printed


def test_in_memory_phase_rehearses_on_cpu(training_rehearsal, monkeypatch,
                                          capsys, tmp_path):
    """Phases 9 and 23 at T=16, 2 steps of 4 clips and 4 validation
    clips: phase 23's losses bit-equal to phase 9's with the clips in
    memory, a planted change of one loss caught; only the launch counts
    fail otherwise."""
    monkeypatch.setattr(chip_smoke, "T_WINDOW", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_CLIPS", 8)
    monkeypatch.setattr(chip_smoke, "VAL_CLIPS", 4)
    config_at = chip_smoke.one_epoch_config
    monkeypatch.setattr(
        chip_smoke, "one_epoch_config",
        lambda *args: config_at(*args, "--batch_size", "4",
                                "--test_batch_size", "4"))
    dev = torch.device("cpu")
    launches, first, replay = chip_smoke.run_trainer(
        np.random.default_rng(0), dev, str(tmp_path))
    assert set(launches.values()) == {0} and len(first["losses"]) == 2
    assert [a.shape for a, _ in replay["splits"].values()] == [
        (8, 3, 16, 33, 1), (4, 3, 16, 33, 1)]
    assert len(replay["scores"]) == 4
    for run in ("same", "planted"):
        (tmp_path / run).mkdir()
        want, scores = dict(first), dict(replay["scores"])
        if run == "planted":  # one loss and one score off by an ulp
            want["losses"] = [float(np.nextafter(np.float32(
                first["losses"][0]), np.float32(np.inf)))] + \
                first["losses"][1:]
            key = sorted(scores)[0]
            scores[key] = np.nextafter(scores[key], np.float32(np.inf))
        stats = chip_smoke.run_in_memory(dict(replay, scores=scores), want,
                                         dev, str(tmp_path / run), "card")
        assert stats["losses"] == first["losses"]
    # phase 9's launch counts, phase 23's twice, the planted loss and score
    assert len(training_rehearsal) == 5, training_rehearsal
    assert "trainer launch counts" in training_rehearsal[0]
    assert "23: trainer launch counts" in training_rehearsal[1]
    assert "23: trainer launch counts" in training_rehearsal[2]
    assert "23: losses" in training_rehearsal[3]
    assert "23: the best scores" in training_rehearsal[4]
    printed = capsys.readouterr().out
    assert printed.count("the 2 losses and the 4 best scores bit-equal "
                         "to phase 9's") == 2


def test_shift_demo_phase_rehearses_on_cpu(rehearsal, capsys):
    """Phase 24a on the CPU: the demo's run on ``dev`` and its plain run
    are both the plain versions there, so every comparison passes and
    only the launch counts (one K1 and one fused K2+K3 a stride) fail."""
    chip_smoke.run_shift_demo(torch.device("cpu"), "card")
    assert len(rehearsal) == 2, rehearsal
    for msg, stride in zip(rehearsal, (1, 2)):
        assert f"24a: demo launch counts at stride {stride}" in msg
        assert "'temporal_shift': 1, 'temporal_shift_backward': 1" in msg
    printed = capsys.readouterr().out
    assert ("grad_ypos [0.0001, 0.01, -0.01, -0.01, -0.01] equal, "
            "grad_xpos zero, grad_input max|err| 0") in printed
    assert ("grad_ypos [0.01, 0.0001, 0.0001, -0.01, -0.01] equal, "
            "grad_xpos zero, grad_input max|err| 0") in printed
