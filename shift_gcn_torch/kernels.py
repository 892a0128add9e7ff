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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("temporal_shift", "shift_gcn", "batchnorm", "adaptive",
           "agcn_tconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel -> the source that holds it
KERNELS: Dict[str, str] = {
    "temporal_shift": "temporal_shift",           # K1, forward
    "temporal_shift_backward": "temporal_shift",  # K2 and K3, fused
    "shift_gcn": "shift_gcn",                     # K4, forward
    "shift_gcn_dx": "shift_gcn",                  # K5
    "shift_gcn_wgrad": "shift_gcn",               # K6: dgate, dW, dbias
    "batch_norm_train": "batchnorm",              # train-mode BN forward
    "batch_norm_train_backward": "batchnorm",     # and its backward
    "agcn_adjacency": "adaptive",                 # 2s-AGCN's graph, forward
    "agcn_adjacency_backward": "adaptive",        # and its backward
    "agcn_tconv": "agcn_tconv",                   # 2s-AGCN's 9-tap conv
    "agcn_tconv_input_grad": "agcn_tconv",        # its input gradient
    "agcn_tconv_weight_grad": "agcn_tconv",       # dW and db
}

# Launches per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else (a kernel run as a partial-sum pass and a final
# pass, the fused temporal-shift backward and K6, counts as one launch, as
# does each train-mode BN forward and backward, whatever its passes, and
# each 2s-AGCN adjacency forward, for all of a unit's subsets, and backward,
# and each 9-tap conv forward and input gradient, with the pass that packs
# their weights, and weight gradient, with its final sum).
# Callers reset them with reset_launches().
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}

# symbols that an earlier commit's build of a source may lack (an older
# build is loaded beside this one to compare the two, bit for bit or in
# time, by scripts/shift_gcn_bitcheck.py and chip_smoke.py phase 22e)
OPTIONAL_SYMBOLS = ("shift_gcn_wgrad_smem",)


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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    plan = [i32] * 7  # r, f, then ops/batchnorm.py's LaunchPlan
    if name == "agcn_tconv":
        signatures = {
            # (backward, src, w, bias, pack, out, rows, ts, tu, tout,
            #  kdim, ndim, cin, cout, period, pad, sstride, taps, npar,
            #  chunks, nt8, bu, slab_rows, ld, bn, stream); bias null
            #  for the input gradient
            "agcn_tconv_run": [i32] + [ptr] * 5 + [i32] * 19 + [ptr],
            # (x, dy, partial, dw, db, rows, tx, ty, cin, cout, stride,
            #  splits, groups a split, stream)
            "agcn_tconv_weight": [ptr] * 5 + [i32] * 8 + [ptr],
        }
    elif name == "adaptive":
        signatures = {
            # (e, a, pa, partial, p, g, n, v, t, k, d, vp, fs, fc, chunks,
            #  stream)
            "agcn_adjacency_forward": [ptr] * 6 + [i32] * 9 + [ptr],
            # (e, p, dg, de, n, v, t, k, d, vp, fs, fc, chunks, stream)
            "agcn_adjacency_backward": [ptr] * 4 + [i32] * 9 + [ptr],
        }
    elif name == "batchnorm":
        signatures = {
            # (x, partial, stats, mean_inv, running_mean, running_var,
            #  num_batches_tracked, r, f, plan, eps, 1 - momentum,
            #  momentum, unbias, update, dtype, stream); stats or mean_inv
            #  null
            "batch_norm_train_stats": [ptr] * 7 + plan + [f32] * 4
                                      + [i32] * 2 + [ptr],
            # (stats, mean_inv, running_mean, running_var,
            #  num_batches_tracked, f, eps, 1 - momentum, momentum, unbias,
            #  update, stream)
            "batch_norm_train_finish": [ptr] * 5 + [i32] + [f32] * 4
                                       + [i32] + [ptr],
            # (x, mean_inv, w, b, y, r, f, plan, lp, dtype, stream)
            "batch_norm_train_normalize": [ptr] * 5 + plan + [i32] * 2
                                          + [ptr],
            # (x, dy, mean_inv, partial, dw, db, means, r, f, plan, dtype,
            #  stream)
            "batch_norm_train_grad_sums": [ptr] * 7 + plan + [i32] + [ptr],
            # (x, dy, mean_inv, w, means, dx, r, f, plan, dtype, stream)
            "batch_norm_train_grad_input": [ptr] * 6 + plan + [i32] + [ptr],
        }
    elif name == "temporal_shift":
        signatures = {
            # (x, ypos, out, n, t_in, t_out, v, c, stride, is_bf16, stream)
            "temporal_shift_forward": [ptr, ptr, ptr] + [i32] * 7 + [ptr],
            # (x, g, ypos, dx, partial, gy, n, t_in, t_out, v, c, stride,
            #  is_bf16, stream); dx or gy (with partial) may be null
            "temporal_shift_backward": [ptr] * 6 + [i32] * 7 + [ptr],
            # (n, t_in) -> rows of the backward's partial-sum scratch
            "temporal_shift_backward_rows": [i32] * 2,
        }
    else:
        signatures = {
            # (x, gate, w, bias, out, r, v, c, d, d0, is_bf16, stream)
            "shift_gcn_forward": [ptr] * 5 + [i32] * 6 + [ptr],
            # (g, gate, w, dx, r, v, c, d, d0, is_bf16, stream)
            "shift_gcn_dx": [ptr] * 4 + [i32] * 6 + [ptr],
            # (x, g, gate, w, partial, scratch floats, dgate, dw, dbias,
            #  r, v, c, d, d0, parts, chunk, is_bf16, stream)
            "shift_gcn_wgrad": [ptr] * 5 + [i64] + [ptr] * 3 + [i32] * 8
                               + [ptr],
            # (r, v, c, d, d0, parts, chunk) -> its scratch floats (int64)
            "shift_gcn_wgrad_scratch": [i32] * 7,
            # (v, is_bf16) -> a K6 block's dynamic shared memory, bytes
            "shift_gcn_wgrad_smem": [i32] * 2,
        }
    for symbol, argtypes in signatures.items():
        if symbol in OPTIONAL_SYMBOLS and not hasattr(lib, symbol):
            continue
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = i64 if symbol.endswith("_scratch") else ctypes.c_int


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if a raw launcher is called where autograd would record it.

    A kernel's output has no ``grad_fn``: called in grad mode on an input
    that requires grad, it would silently cut every gradient upstream.
    Only the kernel's ``torch.autograd.Function`` and its registered
    operator (``ops/library.py``) may call it then: grad mode is off
    inside both.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: called in grad mode on an input that requires "
            "grad; use the op's autograd entry point, which carries the "
            "kernel's backward")


def check_activation(kernel: str, x: torch.Tensor, layout: str) -> None:
    """Raise unless x is a contiguous fp32 or bf16 CUDA tensor with as
    many dimensions as ``layout`` names, e.g. "(N, T, V, C)"."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    if x.dim() != layout.count(",") + 1 or not x.is_contiguous():
        raise ValueError(f"{kernel}: activations must be contiguous "
                         f"{layout} tensors")


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on x's device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def launch(source: str, symbol: str, x: torch.Tensor, *args) -> int:
    """Call ``symbol`` of ``csrc/<source>.cu`` with ``args`` and x's
    current stream, with x's card as the current device: the launchers
    size their grids from the current device's properties
    (``cudaGetDevice``), which must be the card the tensors are on
    whatever the calling thread's current device is.  Returns the CUDA
    status."""
    with torch.cuda.device(x.device):
        return getattr(library(source), symbol)(*args, stream(x))


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{status}")
