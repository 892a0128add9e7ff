"""Program spans: where the port's host time goes, by name.

``with trace.span("serve.forward"):`` times the block on
``time.perf_counter_ns`` and adds it to the process's registry, which
keeps for each name the count, the total seconds, the self seconds (the
total less the time that the spans opened inside it on the same thread
covered) and the last ``RING`` durations.  Each thread has its own stack
of open spans, so spans of two threads never nest in each other.
``snapshot()`` returns the registry as a plain dict; ``reset()`` clears
it.

While a ``torch.profiler`` profile runs, and only then, a span also
opens ``record_function("sgt::" + name)``, so that the profiler's trace
(an operator's ``profile_dir`` trace, the benchmark's profile) shows the
program's spans on its own clock, nested under whatever range is open
around them.  Outside a profile a span costs two clock reads and a dict
update: a ``record_function`` costs several times that even with no
profiler running.

The spans the port opens: ``serve.report`` (``run_on_landmarks``),
inside it ``serve.windows`` and ``serve.pre_normalization``;
``serve.modalities``, and for each stream ``serve.h2d`` and
``serve.forward``, then ``serve.readback`` (``EnsemblePredictor.predict``);
``train.epoch_start`` (``Trainer.train_epoch`` until the first batch is
in hand), ``train.feeder_wait`` (each later batch), ``train.step`` and
``train.epoch_end`` (the final synchronization and the losses' readback).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict

import torch

PREFIX = "sgt::"
RING = 4096

# whether a torch profiler runs: ~0.1 µs, where a record_function costs
# ~12 µs even with no profiler running
_profiling = torch._C._autograd._profiler_enabled

_lock = threading.Lock()
_stats: Dict[str, "_Stat"] = {}
_local = threading.local()


class _Stat:
    __slots__ = ("count", "total_ns", "self_ns", "recent")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.self_ns = 0
        self.recent = collections.deque(maxlen=RING)


class span:
    """A context manager that times its block under ``name``; once the
    block has ended, ``ns`` holds its duration in nanoseconds."""

    __slots__ = ("name", "ns", "_start", "_child_ns", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self._child_ns = 0
        self._range = None

    def __enter__(self) -> "span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        if _profiling():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = time.perf_counter_ns() - self._start
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child_ns += self.ns
        with _lock:
            stat = _stats.get(self.name)
            if stat is None:
                stat = _stats[self.name] = _Stat()
            stat.count += 1
            stat.total_ns += self.ns
            stat.self_ns += self.ns - self._child_ns
            stat.recent.append(self.ns)


def snapshot() -> Dict[str, dict]:
    """Each span name -> ``count``, ``total_s``, ``self_s`` and
    ``recent_s`` (the last ``RING`` durations, oldest first)."""
    with _lock:
        return {name: {"count": s.count, "total_s": s.total_ns * 1e-9,
                       "self_s": s.self_ns * 1e-9,
                       "recent_s": [ns * 1e-9 for ns in s.recent]}
                for name, s in _stats.items()}


def reset() -> None:
    """Forget every span that has ended (open spans still count when
    they end)."""
    with _lock:
        _stats.clear()
