"""Build and load the port's CUDA kernels; hold their launch counters.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
libraries go to ``_build/`` beside this file, named by a hash of their
source, so an edited source is rebuilt and an unchanged one is reused.
All sources are compiled at once, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("temporal_shift", "shift_gcn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else.  Callers reset them with reset_launches().
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.

    Raises RuntimeError with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _library_path(name) for name in SOURCES}
    jobs = {}
    for name, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: concurrent builders race safely
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_all()[name]))
        _declare(name, lib)
        _LIBS[name] = lib
    return _LIBS[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "temporal_shift":
        # (x, ypos, out, n, t_in, t_out, v, c, stride, is_bf16, stream)
        fn = lib.temporal_shift_forward
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    else:
        # (x, gate, w, bias, out, r, v, c, d, is_bf16, stream)
        fn = lib.shift_gcn_forward
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{status}")
