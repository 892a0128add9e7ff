"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card: prints ``nvidia-smi`` name / power limit and the torch device name;
2. build: compiles every kernel of ``shift_gcn_torch/csrc`` (one nvcc per
   source, in parallel) and prints the seconds it took;
3. temporal shift kernel vs its plain PyTorch version at every (T, C,
   stride) one forward of the serving model launches it with (64 windows,
   V=33), fp32 and bf16;
4. fused Shift-GCN kernel vs its plain version at every (T, C, D) of the
   forward, R = 64*T frames, fp32 and bf16;
5. serving: a full-width MediaPipe fall model (10 units, V=33, 2 classes)
   x 4 streams with seeded random weights serves three landmark
   sequences through ``run_on_landmarks``; the launch counters must show
   20 temporal-shift and 10 Shift-GCN launches per stream forward, and the
   probabilities must match the same predictor on the plain path;
6. timings at the serving batch (64 windows, T=300, fp32): each kernel
   per forward beside its bound, its plain version and one library call
   for the same function (temporal shift: a depthwise conv2d; Shift-GCN:
   index_select + matmul); the whole forward per stream, and
   one profiled forward: device busy share and device time by kernel.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_SIMT_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
N_WINDOWS, T_WINDOW, V = 64, 300, 33
REPORT_KEYS = ["total_frames", "num_windows", "fall_detected",
               "max_fall_probability", "fall_intervals",
               "frame_probabilities"]
K1_SOURCE = "shift_gcn_torch/csrc/temporal_shift.cu"
K4_SOURCE = "shift_gcn_torch/csrc/shift_gcn.cu"
K1_REPLACES = "shift_gcn_tpu/ops/pallas/temporal_shift_kernel.py:88"
K4_REPLACES = "shift_gcn_tpu/ops/pallas/shift_gcn_kernel.py:88"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    return err, scale


# ---------------------------------------------------------------------------
# Weights: the reference parameter layout, drawn with numpy from the seed
# ---------------------------------------------------------------------------


def random_arrays(config, rng: np.random.Generator):
    """(params, bn_state) nested numpy dicts in the reference package's
    parameter layout, with non-trivial BN statistics and ypos in [-1, 1]."""
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(f32)

    def bn(n):
        return ({"weight": rng.uniform(0.5, 1.5, n).astype(f32),
                 "bias": normal(n, 0.1)},
                {"running_mean": normal(n, 0.1),
                 "running_var": rng.uniform(0.5, 1.5, n).astype(f32),
                 "num_batches_tracked": np.asarray(100, np.int32)})

    def conv(cin, cout):
        return {"weight": normal((cout, cin, 1, 1), np.sqrt(2.0 / cout)),
                "bias": normal(cout, 0.05)}

    def shift(c):
        return {"xpos": rng.uniform(-1e-8, 1e-8, c).astype(f32),
                "ypos": rng.uniform(-1.0, 1.0, c).astype(f32)}

    v = config.num_point
    p_bn, s_bn = bn(config.num_person * config.in_channels * v)
    params, state = {"data_bn": p_bn}, {"data_bn": s_bn}
    for i, spec in enumerate(config.blocks):
        cin, cout = spec.in_channels, spec.out_channels
        g_bn, gs_bn = bn(v * cout)
        gcn = {"Linear_weight": normal((cin, cout), np.sqrt(1.0 / cout)),
               "Linear_bias": normal((1, 1, cout), 0.05),
               "Feature_Mask": normal((1, v, cin), 0.5), "bn": g_bn}
        gcn_s = {"bn": gs_bn}
        if cin != cout:
            d_bn, ds_bn = bn(cout)
            gcn["down"] = {"conv": conv(cin, cout), "bn": d_bn}
            gcn_s["down"] = {"bn": ds_bn}
        t_bn, ts_bn = bn(cout)
        t_bn2, ts_bn2 = bn(cout)
        tcn = {"bn": t_bn, "bn2": t_bn2, "shift_in": shift(cout),
               "shift_out": shift(cout),
               "temporal_linear": conv(cout, cout)}
        block = {"gcn1": gcn, "tcn1": tcn}
        block_s = {"gcn1": gcn_s, "tcn1": {"bn": ts_bn, "bn2": ts_bn2}}
        if spec.residual and (cin != cout or spec.stride != 1):
            r_bn, rs_bn = bn(cout)
            block["residual"] = {"conv": conv(cin, cout), "bn": r_bn}
            block_s["residual"] = {"bn": rs_bn}
        params[f"l{i + 1}"] = block
        state[f"l{i + 1}"] = block_s
    feat = config.blocks[-1].out_channels
    params["fc"] = {"weight": normal((config.num_class, feat), 0.02),
                    "bias": normal(config.num_class, 0.05)}
    return params, state


def landmark_sequence(rng: np.random.Generator, frames: int) -> np.ndarray:
    """A (3, T, 33, 1) pose track: a fixed random skeleton drifting by a
    smooth random walk, with per-joint jitter."""
    pose = rng.standard_normal((3, 1, V, 1)) * 0.3
    drift = np.cumsum(rng.standard_normal((3, frames, 1, 1)) * 0.01, axis=1)
    jitter = rng.standard_normal((3, frames, V, 1)) * 0.01
    return (pose + drift + jitter).astype(np.float32)


# ---------------------------------------------------------------------------
# Main-path shapes of one forward at T=300
# ---------------------------------------------------------------------------


def forward_shapes(config, t: int):
    """Per launch of one forward: K1 (t_in, c, stride), K4 (t, c, d)."""
    k1, k4 = [], []
    for spec in config.blocks:
        k4.append((t, spec.in_channels, spec.out_channels))
        k1.append((t, spec.out_channels, 1))
        k1.append((t, spec.out_channels, spec.stride))
        t //= spec.stride
    return k1, k4


def k1_cost_ms(n, t_in, c, stride, itemsize=4):
    """(bytes time, operations time) of one launch: each input read once,
    each output written once; 3 fp32 flops per output."""
    out = n * (t_in // stride) * V * c
    moved = (n * t_in * V * c + out) * itemsize + c * 4
    return moved / HBM_BYTES_PER_S * 1e3, 3.0 * out / FP32_SIMT_FLOPS * 1e3


def k4_cost_ms(r, c, d, itemsize=4):
    """(bytes time, operations time) of one launch at fp32 SIMT rate."""
    moved = (r * V * c + r * V * d) * itemsize + (V * c + c * d + d) * 4
    flops = 2.0 * r * V * c * d
    return moved / HBM_BYTES_PER_S * 1e3, flops / FP32_SIMT_FLOPS * 1e3


def shift_conv_library(x: torch.Tensor, ypos: torch.Tensor, stride: int):
    """The temporal shift as one depthwise ``F.conv2d`` over T on the
    channels-last view: per channel the taps (1 - f, f) at offsets lo and
    lo + 1 of a 2P+1 window, zero padding P on both ends, where P is the
    least radius this ``ypos`` needs.  Returns the call, with its weights
    built here, outside any timed region."""
    import torch.nn.functional as F

    n, t_in, v, c = x.shape
    y = ypos.float() + (0.0 if stride == 1 else 0.5)
    lo = torch.floor(y)
    frac = y - lo
    lo = lo.long()
    radius = int(max(int((-lo).max()), int((lo + 1).max()), 1))
    w = torch.zeros(c, 2 * radius + 1, device=x.device)
    ch = torch.arange(c, device=x.device)
    w[ch, lo + radius] = 1.0 - frac
    w[ch, lo + radius + 1] = frac
    w = w.to(x.dtype).view(c, 1, 2 * radius + 1, 1)
    t_out = t_in // stride
    xc = x.permute(0, 3, 1, 2)  # (N, C, T, V), channels-last in memory

    def call():
        out = F.conv2d(xc, w, stride=(stride, 1), padding=(radius, 0),
                       groups=c)
        return out[:, :, :t_out].permute(0, 2, 3, 1)

    return call


@contextmanager
def plain_path():
    """Route the model's two kernel calls to their plain versions."""
    from shift_gcn_torch.ops import shift_gcn_kernel, temporal_shift

    with mock.patch.object(temporal_shift, "temporal_shift",
                           temporal_shift.temporal_shift_reference), \
            mock.patch.object(shift_gcn_kernel, "fused_shift_gcn",
                              shift_gcn_kernel.shift_gcn_transform):
        yield


def profile_forward(model, batch, card: str, top: int = 10) -> None:
    """Device time of one forward by operator (torch.profiler) and the
    device's busy share of the forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows (kernels, copies) only: CPU operator rows would
    # count their kernels a second time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU),
                  key=self_device_us, reverse=True)
    busy_ms = sum(self_device_us(e) for e in rows) / 1e3
    if busy_ms == 0:
        print("[profile] device time not measured (profiler saw none)")
        return
    print(f"[profile] one forward, {batch.shape[0]} windows: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%, profiler on) | {card}")
    for e in rows[:top]:
        us = self_device_us(e)
        if us == 0:
            break
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  x{e.count:<4d} {e.key[:70]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs only on a GPU")
    from shift_gcn_torch import kernels
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
    from shift_gcn_torch.ops import shift_gcn_kernel, spatial_shift
    from shift_gcn_torch.ops import temporal_shift
    from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # 1. card -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    print(f"[build] {len(kernels.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3./4. each kernel vs its plain version at the forward's launches --
    config = ModelConfig(num_class=2, num_point=V, num_person=1,
                         graph="mediapipe_pose")
    k1_shapes, k4_shapes = forward_shapes(config, T_WINDOW)
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for t, c, stride in sorted(set(k1_shapes)):
            x = torch.randn(N_WINDOWS, t, V, c, generator=gen,
                            device=dev).to(dtype)
            y = rng.uniform(-1.0, 1.0, c).astype(np.float32)
            y[:4] = (1.0, -1.0, 6.9, -6.9)  # integer, near ±(8-1)
            ypos = torch.from_numpy(y).to(dev)
            got = temporal_shift.temporal_shift(x, ypos, stride)
            want = temporal_shift.temporal_shift_reference(x, ypos, stride)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            # fp32: identical rounding steps, ~1e-6 relative;
            # bf16: one bf16 rounding of the fp32 result
            tol = (1e-6 if dtype == torch.float32 else 2 ** -8) * scale
            if not err <= tol:
                fail(f"temporal_shift {dtype} s={stride} C={c} T={t}: "
                     f"max|err| {err:.3g} > {tol:.3g}")
            worst = max(worst, err)
        print(f"[k1] temporal_shift {str(dtype)[6:]}: "
              f"{len(set(k1_shapes))} forward shapes (T, C, s) "
              f"{sorted(set(k1_shapes))}, max|err| {worst:.3g}")
        if dtype == torch.float32:
            k1_err = worst

    k4_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for t, c, d in sorted(set(k4_shapes)):
            x = torch.randn(N_WINDOWS * t, V, c, generator=gen,
                            device=dev).to(dtype)
            gate = torch.tanh(torch.randn(V, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            b = torch.randn(d, generator=gen, device=dev) * 0.1
            got = shift_gcn_kernel.fused_shift_gcn(x, gate, w, b)
            want = spatial_shift.shift_gcn_transform(x, gate, w, b)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            # fp32: the same contraction summed in another order (cuBLAS vs
            # the kernel's k-loop); bf16: the two fp32 sums may round to
            # neighbouring bf16 values
            tol = (2e-5 if dtype == torch.float32 else 2 ** -7) * scale
            if not err <= tol:
                fail(f"shift_gcn {dtype} T={t} C={c} D={d}: max|err| "
                     f"{err:.3g} > {tol:.3g}")
            worst = max(worst, err)
        print(f"[k4] shift_gcn {str(dtype)[6:]}: {len(set(k4_shapes))} "
              f"forward shapes (T, C, D) {sorted(set(k4_shapes))} at "
              f"R={N_WINDOWS}*T, max|err| {worst:.3g}")
        if dtype == torch.float32:
            k4_err = worst

    # 5. serving path ---------------------------------------------------
    state_dicts = {m: state_dict_from_arrays(*random_arrays(config, rng))
                   for m in pipeline.MODALITY_ORDER}
    predictor = pipeline.EnsemblePredictor(state_dicts, model_config=config)
    sequences = [landmark_sequence(rng, f) for f in (900, 300, 1500)]
    kernels.reset_launches()
    reports = [pipeline.run_on_landmarks(s, predictor, window=T_WINDOW,
                                         stride=150) for s in sequences]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    forwards = len(sequences) * len(pipeline.MODALITY_ORDER)
    expect = {"temporal_shift": 20 * forwards, "shift_gcn": 10 * forwards}
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    with plain_path():
        plain_reports = [pipeline.run_on_landmarks(
            s, predictor, window=T_WINDOW, stride=150) for s in sequences]
    if dict(kernels.LAUNCHES) != launches:
        fail("the plain-path run launched kernels")
    serve_err = 0.0
    for seq, rep, plain in zip(sequences, reports, plain_reports):
        if list(rep) != REPORT_KEYS:
            fail(f"report keys {list(rep)} != {REPORT_KEYS}")
        probs = np.asarray(rep["frame_probabilities"])
        if probs.shape != (seq.shape[1],) or not np.isfinite(probs).all():
            fail("frame probabilities are not finite values per frame")
        serve_err = max(serve_err, float(np.abs(
            probs - np.asarray(plain["frame_probabilities"])).max()))
    # fp32 end to end; the only differences are K4's summation order
    if not serve_err <= 1e-4:
        fail(f"serving probabilities differ from the plain path by "
             f"{serve_err:.3g} > 1e-4")
    print(f"[serve] {len(sequences)} sequences x "
          f"{len(pipeline.MODALITY_ORDER)} streams: windows "
          f"{[r_['num_windows'] for r_ in reports]}, falls "
          f"{[r_['fall_detected'] for r_ in reports]}, launches {launches}, "
          f"max|p - p_plain| {serve_err:.3g}")

    # 6. timings at the serving batch ----------------------------------
    # per stream forward: kernel, plain, bound, library, bytes, operations
    totals = {"temporal_shift": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
              "shift_gcn": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]}
    for shape in sorted(set(k1_shapes)):
        t, c, stride = shape
        count = k1_shapes.count(shape)
        x = torch.randn(N_WINDOWS, t, V, c, generator=gen, device=dev)
        ypos = torch.from_numpy(
            rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
        library = shift_conv_library(x, ypos, stride)
        lib_err, _ = max_err(library(), temporal_shift.temporal_shift_reference(
            x, ypos, stride))
        if not lib_err <= 1e-5:
            fail(f"depthwise conv yardstick disagrees ({lib_err:.3g})")
        ms = time_ms(lambda: temporal_shift.temporal_shift(x, ypos, stride))
        plain = time_ms(lambda: temporal_shift.temporal_shift_reference(
            x, ypos, stride))
        lib = time_ms(library)
        cost = k1_cost_ms(N_WINDOWS, t, c, stride)
        bound = max(cost)
        for i, val in ((0, ms), (1, plain), (2, bound), (3, lib),
                       (4, cost[0]), (5, cost[1])):
            totals["temporal_shift"][i] += count * val
        print(f"[time] temporal_shift T={t} C={c} s={stride} x{count}: "
              f"{ms:.4f} ms (bound {bound:.4f}, plain {plain:.4f}, "
              f"depthwise conv2d {lib:.4f}) | {card}")
    for shape in sorted(set(k4_shapes)):
        t, c, d = shape
        count = k4_shapes.count(shape)
        rr = N_WINDOWS * t
        x = torch.randn(rr, V, c, generator=gen, device=dev)
        gate = torch.tanh(torch.randn(V, c, generator=gen, device=dev)) + 1
        w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
        b = torch.randn(d, generator=gen, device=dev) * 0.1
        idx_in = torch.from_numpy(
            spatial_shift.flat_shift_index(V, c, +1)).to(dev)
        idx_out = torch.from_numpy(
            spatial_shift.flat_shift_index(V, d, -1)).to(dev)

        def library():
            h = x.view(rr, V * c).index_select(1, idx_in).view(rr, V, c)
            z = torch.matmul(h * gate, w) + b
            return z.view(rr, V * d).index_select(1, idx_out).view(rr, V, d)

        lib_err, _ = max_err(library(), spatial_shift.shift_gcn_transform(
            x, gate, w, b))
        if not lib_err <= 1e-3:
            fail(f"index_select yardstick disagrees ({lib_err:.3g})")
        ms = time_ms(lambda: shift_gcn_kernel.fused_shift_gcn(x, gate, w, b))
        plain = time_ms(lambda: spatial_shift.shift_gcn_transform(
            x, gate, w, b))
        lib = time_ms(library)
        cost = k4_cost_ms(rr, c, d)
        bound = max(cost)
        for i, val in ((0, ms), (1, plain), (2, bound), (3, lib),
                       (4, cost[0]), (5, cost[1])):
            totals["shift_gcn"][i] += count * val
        by = "operations" if cost[1] > cost[0] else "bytes"
        print(f"[time] shift_gcn T={t} C={c} D={d} x{count}: {ms:.4f} ms "
              f"(bound {bound:.4f} by {by}, plain "
              f"{plain:.4f}, index_select+matmul {lib:.4f}) | {card}")

    model = Model(config)
    model.load_state_dict(state_dicts["joint"], strict=True)
    batch = torch.from_numpy(np.stack([
        pipeline.create_sliding_windows(landmark_sequence(rng, T_WINDOW))[0][0]
        for _ in range(N_WINDOWS)])).to(dev)
    with torch.inference_mode():
        fwd = time_ms(lambda: model(batch), iters=3, reps=5)
        with plain_path():
            fwd_plain = time_ms(lambda: model(batch), iters=3, reps=5)
    print(f"[time] forward per stream, {N_WINDOWS} windows x T={T_WINDOW}: "
          f"{fwd:.3f} ms kernels, {fwd_plain:.3f} ms plain path | {card}")
    profile_forward(model, batch, card)

    entries = []
    for name, source, replaces, err in (
            ("temporal_shift", K1_SOURCE, K1_REPLACES, k1_err),
            ("shift_gcn", K4_SOURCE, K4_REPLACES, k4_err)):
        ms, plain, bound, lib, bytes_ms, ops_ms = totals[name]
        bound_by = "operations" if ops_ms > bytes_ms else "bytes"
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    print("[note] kernel ms / plain_ms / bound_ms / library_ms are per "
          f"stream forward at {N_WINDOWS} windows x T={T_WINDOW}, fp32; "
          "launches are the serving run's")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
