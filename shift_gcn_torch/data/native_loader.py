"""ctypes bindings for the native batch loader (``csrc/sgt_loader.cpp``).

A copy of the reference package's loader bindings with one difference by
design: the library is built on first use by ``g++`` into ``_build/``
beside the package, under a name hashed from its source and flags (as
``kernels.py`` builds the CUDA sources), never into the repository's
``native/`` directory; and a build or open that fails raises
``NativeLoaderUnavailable``, with no numpy fallback.  The loader owns the
mmap and gathers batches with a thread pool; ``prefetch`` / ``wait`` give
one asynchronous request in flight.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE / "csrc" / "sgt_loader.cpp"
BUILD_DIR = PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeLoaderUnavailable(RuntimeError):
    """The native loader could not be built or could not open a file."""


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsgt_loader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the loader unless an up-to-date library exists; returns its
    path.  Raises NativeLoaderUnavailable if ``g++`` is missing or fails."""
    lib = library_path()
    with _BUILD_LOCK:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeLoaderUnavailable(
                f"could not build the native loader: {e}") from e
        except subprocess.CalledProcessError as e:
            raise NativeLoaderUnavailable(
                f"could not build the native loader:\n{e.stderr}") from e
        os.replace(tmp, lib)  # atomic: concurrent builders race safely
        return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.sgt_open.restype = ctypes.c_void_p
        lib.sgt_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.sgt_ndim.restype = ctypes.c_int
        lib.sgt_ndim.argtypes = [ctypes.c_void_p]
        lib.sgt_shape.restype = None
        lib.sgt_shape.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.sgt_gather.restype = ctypes.c_int
        lib.sgt_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.sgt_prefetch.restype = ctypes.c_int
        lib.sgt_prefetch.argtypes = lib.sgt_gather.argtypes
        lib.sgt_wait.restype = None
        lib.sgt_wait.argtypes = [ctypes.c_void_p]
        lib.sgt_close.restype = None
        lib.sgt_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class NativeClipLoader:
    """mmap-backed .npy clip gatherer with one asynchronous prefetch."""

    def __init__(self, data_path: str, num_threads: int = 4):
        lib = _lib()
        self._lib = lib
        handle = lib.sgt_open(os.fsencode(data_path), num_threads)
        if not handle:
            raise NativeLoaderUnavailable(
                f"native loader rejected {data_path} (needs a C-order "
                "little-endian f4/f8 .npy)")
        self._handle = ctypes.c_void_p(handle)
        ndim = lib.sgt_ndim(self._handle)
        dims = (ctypes.c_int64 * ndim)()
        lib.sgt_shape(self._handle, dims)
        self.shape: Tuple[int, ...] = tuple(int(d) for d in dims)
        self._pending: Optional[np.ndarray] = None
        self._keepalive: Optional[np.ndarray] = None

    def _call(self, fn, indices: np.ndarray):
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx),) + self.shape[1:], dtype=np.float32)
        rc = fn(self._handle,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return rc, idx, out

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Synchronously fetch clips[indices] -> (n, *clip_shape) float32."""
        rc, _, out = self._call(self._lib.sgt_gather, indices)
        if rc != 0:
            raise IndexError(f"index out of range in native gather (rc={rc})")
        return out

    def prefetch(self, indices: np.ndarray) -> None:
        """Start an asynchronous gather; retrieve it with wait()."""
        rc, idx, out = self._call(self._lib.sgt_prefetch, indices)
        if rc == -1:
            raise RuntimeError("a prefetch is already outstanding")
        if rc != 0:
            raise IndexError("index out of range in native prefetch")
        self._keepalive = idx  # the worker reads these buffers
        self._pending = out

    def wait(self) -> np.ndarray:
        if self._pending is None:
            raise RuntimeError("no outstanding prefetch")
        self._lib.sgt_wait(self._handle)
        out, self._pending, self._keepalive = self._pending, None, None
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.sgt_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
