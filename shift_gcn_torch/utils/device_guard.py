"""Device health guard for long training runs.

A port of the reference package's ``utils/device_guard.py``, which
guards against a TPU worker that silently no-ops.  On a CUDA card the
failure it catches is a context that a fault has poisoned: an illegal
address or a kernel that dies leaves the error sticky, so every later
call in the process raises and nothing in the process can heal it.
Recovery is a fresh process that resumes from the newest checkpoint.

The Trainer calls it after every train epoch (``Trainer._guard_device``,
config key ``device_guard``):

1. An epoch is suspicious when its clips/s is implausibly high
   (``plausible_throughput``) or its mean loss is not finite.
2. ``check()`` then runs ``device_healthy``, a small fp32 matmul on the
   device against numpy, retrying a few times.
3. If the device stays unhealthy, ``check()`` raises
   ``DeviceUnhealthyError`` and the Trainer calls ``reexec_with_resume``:
   the training CLI restarts in this process's place with ``--resume
   auto`` (progress since the last save is lost, as for an operator who
   reruns with ``--resume``; reference main.py:215-229).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

# An epoch of the MediaPipe model that reads faster than this has not
# run: on an H100 80GB HBM3 at 700 W its bf16 train step runs 353.8
# clips/s at batch 64, T=300 (root PERF.md section 5, chip_smoke.py phase
# 10), and 3000 clips/s is ~8.5x that (a four-stream epoch reads ~4x
# slower still).  A much smaller model may read faster: the check then
# runs, passes and costs one small matmul.
MAX_PLAUSIBLE_CLIPS_PER_SEC = 3000.0

TRAIN_MODULE = "shift_gcn_torch.cli.train"
_REEXEC_ENV = "_SGT_TORCH_TRAIN_REEXEC"
_MAX_REEXEC = 8


class DeviceUnhealthyError(RuntimeError):
    """The device repeatedly failed the numeric sanity check."""


def device_healthy(device="cuda") -> bool:
    """One-shot check: does ``device`` compute a 128x128 fp32 matmul
    correctly?  TF32 is off for the call, as the reference pins
    precision="highest": the check must not depend on the default matmul
    precision.  A CUDA error (sticky once a fault poisoned the context)
    reads as unhealthy."""
    rng = np.random.default_rng(1234)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = (torch.from_numpy(a).to(device)
               @ torch.from_numpy(b).to(device)).cpu().numpy()
    except RuntimeError:  # torch raises CUDA errors as RuntimeErrors
        return False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return bool(np.allclose(got, a @ b, atol=1e-2))


def check(max_tries: int = 3, wait_s: float = 5.0,
          healthy_fn: Optional[Callable[[], bool]] = None,
          sleep_fn=time.sleep, logger=None, device="cuda") -> None:
    """Verify device health, retrying with waits; raise if it stays bad.
    A poisoned CUDA context does not recover with time, so the waits are
    short: the retries only rule out a one-off misreading."""
    if healthy_fn is None:
        def healthy_fn():
            return device_healthy(device)
    for attempt in range(max_tries):
        if healthy_fn():
            return
        if logger is not None:
            logger.log(f"\tDevice sanity check failed "
                       f"(attempt {attempt + 1}/{max_tries}); waiting "
                       f"{wait_s:.0f}s")
        sleep_fn(wait_s)
    raise DeviceUnhealthyError(
        f"device failed {max_tries} sanity checks; a fresh process is "
        "required")


def plausible_throughput(clips_per_sec: float) -> bool:
    return clips_per_sec < MAX_PLAUSIBLE_CLIPS_PER_SEC


def reexec_count() -> int:
    return int(os.environ.get(_REEXEC_ENV, "0"))


def reexec_with_resume(logger=None, extra_argv: Optional[list] = None,
                       wait_s: float = 5.0, device=None) -> None:
    """Replace this process with ``python -m shift_gcn_torch.cli.train``,
    this process's arguments and ``extra_argv``, resuming from the NEWEST
    checkpoint.

    An existing ``--resume <path>`` is rewritten to ``--resume auto`` (a
    fixed path would roll back to the same checkpoint every restart),
    ``--overwrite false`` is forced so the fresh process's cleanup cannot
    delete the checkpoints it resumes from, and ``--torch-device`` is kept
    (added from ``device`` when the arguments lack it).  Raises after
    _MAX_REEXEC generations, so that a card that is down for good ends
    the run.  os.execve never returns on success.
    """
    depth = reexec_count()
    if depth >= _MAX_REEXEC:
        raise DeviceUnhealthyError(
            f"device still unhealthy after {_MAX_REEXEC} fresh-process "
            "restarts; giving up")
    argv = ([sys.executable, "-m", TRAIN_MODULE] + sys.argv[1:]
            + list(extra_argv or []))
    for flag, value in (("--resume", "auto"), ("--overwrite", "false")):
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    if device is not None and "--torch-device" not in argv:
        argv += ["--torch-device", str(device)]
    if logger is not None:
        logger.log(f"\tRe-executing the trainer in a fresh process "
                   f"(restart {depth + 1}/{_MAX_REEXEC}): {' '.join(argv)}")
    time.sleep(wait_s)
    os.environ[_REEXEC_ENV] = str(depth + 1)
    os.execve(argv[0], argv, os.environ)
