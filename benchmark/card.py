"""The card a run uses, the run's environment and its guards."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark.manifest import ROOT

# modules that no run may hold once its window has closed (the JAX
# package's top-level name included), compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "shift_gcn_tpu")


class NoCard(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the port on the "
                     "card and never falls back to the CPU")
    found = torch.cuda.device_count()
    if found < count:
        raise NoCard(f"the cell needs {count} CUDA cards, this machine has "
                     f"{found}")


def configure_environment(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; no library loads JAX."""
    cache = Path(root) / "benchmark" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def build_kernels() -> float:
    """Build the port's kernels into its ``_build/`` in the checkout (the
    checkout's first run), or find them built: the seconds it took."""
    from shift_gcn_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    return time.perf_counter() - t0


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """nvidia-smi's power limit of card 0, or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_facts(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "power_limit": power_limit()}


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (/proc), so that interpreter start-up counts too."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
