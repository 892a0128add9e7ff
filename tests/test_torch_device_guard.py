"""The port's device guard (shift_gcn_torch.utils.device_guard): the
cases of tests/test_device_guard.py, the CUDA-error path, and the
Trainer's epoch-boundary hook."""

import sys

import numpy as np
import pytest
import torch

from shift_gcn_torch.utils import device_guard


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


def test_device_healthy_on_cpu_and_tf32_restored():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert device_guard.device_healthy("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_device_error_reads_unhealthy(monkeypatch):
    """A CUDA error (torch raises it as a RuntimeError) is a failed
    check, not a crash of the guard."""
    def poisoned(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(torch.Tensor, "to", poisoned)
    assert not device_guard.device_healthy("cpu")


def test_wrong_result_reads_unhealthy(monkeypatch):
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self: real(self) * 0.0)
    assert not device_guard.device_healthy("cpu")


def test_check_passes_without_sleeping():
    sleeps = []
    device_guard.check(healthy_fn=lambda: True, sleep_fn=sleeps.append)
    assert sleeps == []
    device_guard.check(sleep_fn=sleeps.append, device="cpu")
    assert sleeps == []


def test_check_retries_then_raises():
    sleeps = []
    log = _Log()
    with pytest.raises(device_guard.DeviceUnhealthyError):
        device_guard.check(max_tries=3, wait_s=7.0,
                           healthy_fn=lambda: False,
                           sleep_fn=sleeps.append, logger=log)
    assert sleeps == [7.0, 7.0, 7.0]
    assert len(log.lines) == 3


def test_check_recovers_mid_retry():
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        return state["n"] >= 2

    sleeps = []
    device_guard.check(healthy_fn=flaky, sleep_fn=sleeps.append)
    assert len(sleeps) == 1


def test_plausible_throughput_threshold():
    assert device_guard.plausible_throughput(353.8)
    assert device_guard.plausible_throughput(2999.0)
    assert not device_guard.plausible_throughput(
        device_guard.MAX_PLAUSIBLE_CLIPS_PER_SEC + 1)


def test_reexec_depth_cap(monkeypatch):
    monkeypatch.setenv(device_guard._REEXEC_ENV,
                       str(device_guard._MAX_REEXEC))
    with pytest.raises(device_guard.DeviceUnhealthyError):
        device_guard.reexec_with_resume(wait_s=0.0)


def _capture_reexec(monkeypatch, argv, **kwargs):
    calls = {}

    def fake_execve(path, new_argv, env):
        calls["path"] = path
        calls["argv"] = new_argv
        calls["env"] = env
        raise SystemExit  # execve never returns; simulate process swap

    monkeypatch.delenv(device_guard._REEXEC_ENV, raising=False)
    monkeypatch.setattr(device_guard.os, "execve", fake_execve)
    monkeypatch.setattr(device_guard.sys, "argv", argv)
    monkeypatch.setattr(device_guard.time, "sleep", lambda s: None)
    with pytest.raises(SystemExit):
        device_guard.reexec_with_resume(**kwargs)
    return calls


def test_reexec_appends_resume_and_disables_overwrite(monkeypatch):
    calls = _capture_reexec(
        monkeypatch, ["train.py", "--config", "c.yaml"])
    argv = calls["argv"]
    assert calls["path"] == sys.executable
    assert argv[1:5] == ["-m", "shift_gcn_torch.cli.train", "--config",
                         "c.yaml"]
    assert argv[argv.index("--resume") + 1] == "auto"
    assert argv[argv.index("--overwrite") + 1] == "false"
    assert "--torch-device" not in argv
    assert calls["env"][device_guard._REEXEC_ENV] == "1"


def test_reexec_rewrites_fixed_resume_to_auto(monkeypatch):
    calls = _capture_reexec(
        monkeypatch,
        ["/x/shift_gcn_torch/cli/train.py", "--config", "c.yaml",
         "--resume", "save/run/run-10-99.pt", "--overwrite", "true",
         "--torch-device", "cuda:1"], device=torch.device("cuda", 0))
    argv = calls["argv"]
    assert argv[argv.index("--resume") + 1] == "auto"
    assert "save/run/run-10-99.pt" not in argv
    assert argv[argv.index("--overwrite") + 1] == "false"
    assert argv.count("--torch-device") == 1
    assert argv[argv.index("--torch-device") + 1] == "cuda:1"
    assert "/x/shift_gcn_torch/cli/train.py" not in argv


def test_reexec_adds_the_trainer_device(monkeypatch):
    calls = _capture_reexec(monkeypatch, ["train.py", "--config", "c.yaml"],
                            device=torch.device("cpu"))
    argv = calls["argv"]
    assert argv[argv.index("--torch-device") + 1] == "cpu"


def _trainer_stub(enabled=True):
    from shift_gcn_torch.train.config import ExperimentConfig
    from shift_gcn_torch.train.trainer import Trainer

    trainer = Trainer.__new__(Trainer)
    trainer.cfg = ExperimentConfig(device_guard=enabled)
    trainer.logger = _Log()
    trainer.device = torch.device("cpu")
    return trainer


@pytest.mark.parametrize("stats, checked", [
    ({"clips_per_sec": 353.8, "loss": 0.7}, False),
    ({"clips_per_sec": 5000.0, "loss": 0.7}, True),
    ({"clips_per_sec": 353.8, "loss": float("nan")}, True),
])
def test_trainer_guard_checks_suspicious_epochs(monkeypatch, stats, checked):
    calls = []
    monkeypatch.setattr(device_guard, "check",
                        lambda **kw: calls.append(kw))
    trainer = _trainer_stub()
    trainer._guard_device(stats)
    assert bool(calls) == checked
    if checked:
        assert calls[0]["device"] == torch.device("cpu")
    _trainer_stub(enabled=False)._guard_device(stats)
    assert len(calls) == int(checked)


def test_trainer_guard_reexecs_an_unhealthy_device(monkeypatch):
    reexecs = []

    def unhealthy(**kw):
        raise device_guard.DeviceUnhealthyError("bad")

    monkeypatch.setattr(device_guard, "check", unhealthy)
    monkeypatch.setattr(device_guard, "reexec_with_resume",
                        lambda **kw: reexecs.append(kw))
    trainer = _trainer_stub()
    trainer._guard_device({"clips_per_sec": np.inf, "loss": 1.0})
    assert len(reexecs) == 1 and reexecs[0]["device"] == trainer.device
