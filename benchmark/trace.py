"""The benchmark's own spans, and the reading of a profiled sub-window.

Spans are host intervals around calls into the program's layers, kept
in memory (a name's total seconds and count), and marked for the
profiler with ``record_function`` so that a device trace can say what
the host was doing during an idle gap.  A traced run profiles a short
steady sub-window twice with ``torch.profiler`` and keeps only a
summary.  The first pass records device activity alone, so that the
profiler adds no host work to the window it times: device seconds by
kernel name, the busy union of device intervals, and the window's
length on the host's clock between two synchronizations.  The second
records the host's operations too, for the idle gaps by the benchmark
span that was open; its window is longer by the profiler's own host
cost, which ``host_cost_s`` gives.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import torch

SPAN_PREFIX = "bench::"


class Spans:
    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return spanned


def _is_work(event, device_types) -> bool:
    """A device row that is an operation: not a CPU row, and not the
    device-side copy of an annotation (the benchmark's spans, NCCL's
    ``nccl:all_reduce``), which would count its kernels twice."""
    name = getattr(event, "key", None) or event.name
    return (event.device_type != device_types.CPU
            and not getattr(event, "is_user_annotation", False)
            and not name.startswith(SPAN_PREFIX)
            and not name.startswith("nccl:"))


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


class Profile:
    """Summary of one profiled sub-window."""

    def __init__(self, kernels: Dict[str, float], busy_s: float,
                 window_s: float, gaps: List[list], units: int,
                 host_cost_s: float):
        self.kernels = kernels        # name -> device seconds
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps              # [[span name, idle seconds], ...]
        self.units = units            # steps or reports profiled
        self.host_cost_s = host_cost_s  # second pass's window less first's

    def summary(self) -> dict:
        return {"kernels": self.kernels, "busy_s": self.busy_s,
                "window_s": self.window_s, "gaps": self.gaps,
                "units": self.units, "host_cost_s": self.host_cost_s}


def busy_and_gaps(intervals, w0: float, w1: float):
    """The busy length of ``intervals`` (start, end) clipped to [w0, w1],
    and the gaps between them, in the intervals' unit."""
    busy, gaps, cursor = 0.0, [], w0
    for s, t in sorted((max(a, w0), min(b, w1)) for a, b in intervals
                       if b > w0 and a < w1):
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if cursor < w1:
        gaps.append((cursor, w1))
    return busy, gaps


def idle_by_span(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost benchmark span open at each moment
    of each gap; ``gaps`` (start, end) and ``spans`` (start, end, name)
    in microseconds."""
    by_span: Dict[str, float] = {}
    for s, t in gaps:
        cuts = sorted({s, t} | {x for a, b, _ in spans for x in (a, b)
                                if s < x < t})
        for u, v in zip(cuts, cuts[1:]):
            open_spans = [(a, name) for a, b, name in spans if a <= u < b]
            name = (max(open_spans)[1][len(SPAN_PREFIX):] if open_spans
                    else "outside any span")
            by_span[name] = by_span.get(name, 0.0) + (v - u) * 1e-6
    return by_span


def _timed(run, device, activities):
    """``run()`` under the profiler between two synchronizations: the
    profiler and the host seconds between them."""
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=activities) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            run()
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return prof, seconds


def profile(run, units: int, device: torch.device) -> Optional[Profile]:
    """Profile ``run()`` (``units`` steps or reports) on ``device``, twice
    (see the module's note); None on a machine whose profiler sees no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return None
    prof, window_s = _timed(run, device, [ProfilerActivity.CUDA])
    device_events = [e for e in prof.events() if _is_work(e, DeviceType)]
    if not device_events:
        return None
    kernels: Dict[str, float] = {}
    for e in prof.key_averages():
        if not _is_work(e, DeviceType):
            continue
        us = _device_us(e)
        if us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us * 1e-6
    # every operation starts after the first synchronization and ends
    # before the second: the union needs no window of the device's clock
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    busy, _ = busy_and_gaps(intervals, min(a for a, _ in intervals),
                            max(b for _, b in intervals))

    prof, host_window_s = _timed(run, device, [ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
    events = prof.events()
    window = next(e for e in events if e.name == SPAN_PREFIX + "window")
    w0, w1 = window.time_range.start, window.time_range.end
    _, gaps = busy_and_gaps(
        [(e.time_range.start, e.time_range.end) for e in events
         if _is_work(e, DeviceType)], w0, w1)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(SPAN_PREFIX)
                   and e.name != SPAN_PREFIX + "window")
    by_span = idle_by_span(gaps, spans)
    gap_list = [[name, s] for name, s in sorted(by_span.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return Profile(kernels, busy * 1e-6, window_s, gap_list, units,
                   host_window_s - window_s)
