"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card: prints ``nvidia-smi`` name / power limit and the torch device name;
2. build: compiles every kernel of ``shift_gcn_torch/csrc`` (one nvcc per
   source, in parallel) and prints the seconds it took, and, where the
   toolkit has ``cuobjdump``, the tensor-core (HMMA) instructions and the
   registers of each K4/K5/K6 function of the built library;
3. temporal shift kernel (K1) bit-equal to its plain PyTorch version
   (max|err| 0), fp32 and bf16, at every (T, C, stride) one forward of
   the serving model launches it with (64 windows, V=33), at shifts
   outside its staged window (U(-7, 7) with +-20.3 and +-7.4) at the
   largest stride-1 and stride-2 shapes, at C=130 with T=75 and stride 2
   (1-element lanes, odd T), on an input that starts one element into
   its storage (unaligned), and at V=144, where fewer frames fit in
   shared memory;
4. fused Shift-GCN kernel vs its plain version at every (T, C, D) of the
   forward, R = 64*T frames, fp32 and bf16;
5. serving: a full-width MediaPipe fall model (10 units, V=33, 2 classes)
   x 4 streams with seeded random weights serves three landmark
   sequences through ``run_on_landmarks``; the launch counters must show
   20 temporal-shift and 10 Shift-GCN launches per stream forward, and the
   probabilities must match the same predictor on the plain path;
6. timings at the serving batch (64 windows, T=300, fp32): each kernel
   per forward beside its bound and its share of it, its plain version
   and one library call for the same function (temporal shift: a
   depthwise conv2d; Shift-GCN: index_select + matmul), and each again
   in bf16 (the Trainer's forward runs them in bf16), K1 also at
   spread-out shifts (U(-7, 7)); the whole forward per stream, and one
   profiled forward: device busy share and device time by kernel;
7. backward kernels vs their plain versions at every launch shape of one
   training step (64 clips, T=300), fp32 and bf16: the fused temporal-shift
   backward (K2 grad_input and K3 position grad in one kernel) at the K1
   shapes, also with shifts outside its staged window, its gy_raw
   bit-equal across two launches and its one-output forms bit-equal to
   it; K5 Shift-GCN dx and K6, the weight gradients (dgate, dW, dbias),
   at the K4 shapes, K6 also at V=144, and bit-equal across two launches
   (its largest error printed also as a share of its scale);
8. one full-width train step (fp32, 64 clips x T=300) on the kernel path
   vs the plain backward (every launcher plain but K4, so both sides share
   one forward) from the same seeded state and batch: loss, every true
   gradient, the ypos steps, and a gradient on every parameter; the loss
   also vs the whole plain path, whose gradient gap is printed beside the
   gap that 2^-22 noise on the plain K4's output makes;
9. ``Trainer.start()`` on ``configs/mediapipe/train_joint.yaml`` unchanged
   in model and batch (bf16 activations, batch 64, T=300) for one epoch
   of 8 steps on synthetic data, with eval and save, batches prefetched
   one step ahead on the Trainer's worker thread; the launch counters
   must equal the stated per-step counts x 8 plus the eval forwards, and
   the saved checkpoint must reproduce the best-score pickle; prints the
   feeder's share of the epoch;
10. training timings: each backward kernel per step beside its bound, its
   plain version and a library call (the fused backward: the sum of the
   two library calls for grad_input and the position grad, also at
   spread-out shifts; K6: two ``index_select`` shears, a ``bmm`` and the
   three reductions); the train step on the kernel path vs the plain
   path, fp32 and bf16; one profiled train step;
11. K1 and K4 through their registered torch operators at the shapes of
   one streaming evaluation (one window, N=1: 300, 150 and 75 rows): K1
   bit-equal to its plain version, K4 within 2e-5 of its scale, fp32;
12. streaming: ``StreamingFallDetector`` on a fresh 4-stream predictor
   over a 900-frame landmark track at hop 150 (the offline stride): its
   finalize() report equals ``run_on_landmarks`` (window and frame
   probabilities within 1e-5, the same intervals, the events the offline
   window scores give), with 80 K1 and 40 K4 launches per evaluation;
   then hop 30, with the median and p90 of the time from ``push`` to its
   update;
13. serving artifacts: the joint stream's model exported with
   ``torch.export`` at batch 64 in both flavours (weights as inputs,
   weights baked), saved, loaded, and 130 clips scored through
   ``serve.score_clips`` (three batches, the last padded): the scores
   equal the live module within 1e-5, with 20 K1 and 10 K4 launches per
   batch; each artifact's time per batch beside the live module's;
14. four-stream training: ``Trainer.start()`` on
   ``configs/mediapipe/train_fourstream.yaml`` unchanged in model and
   batch (the joint, bone, joint-motion and bone-motion models, bf16,
   batch 64, T=300, SGD nesterov lr 0.1) with the native loader, one
   epoch of 8 steps on 512 synthetic clips and 128 validation clips: the
   train feeder gathers natively; the launch counters equal 4 x the
   per-step counts x 8 plus 4 x the eval forwards; finite per-stream
   losses; the per-stream and ensemble best pickles exist, the ensemble's
   0.6/0.6/0.4/0.4 of the streams' within 1e-5; the four-stream
   checkpoint through ``EnsemblePredictor.from_fourstream_checkpoint``
   reproduces every stream's pickle within 1e-5 and serves
   ``run_on_landmarks`` as the per-modality predictor on the same state
   dicts does; one four-stream step on copies of the four models equals
   four ``state.train_step``s on the same weights (STEP_GRAD_TOL); the
   device guard's check passes on the card and raises, without
   sleeping, on an injected failing probe.  Prints the four-stream step
   time (CUDA events) and its peak memory beside a single-stream step's,
   the epoch's clips/s and the feeder's share.

The last four lines are a JSON object with one entry per kernel, a
summary of the end-to-end figures, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_SIMT_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
# K4/K5/K6 multiply on the tensor cores with fp32 accuracy: three TF32
# products (495 TFLOP/s dense) per fp32-accurate multiply-add
TF32_3X_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # dense bf16 tensor-core rate: exact bf16 products
N_WINDOWS, T_WINDOW, V = 64, 300, 33
REPORT_KEYS = ["total_frames", "num_windows", "fall_detected",
               "max_fall_probability", "fall_intervals",
               "frame_probabilities"]
K1_SOURCE = "shift_gcn_torch/csrc/temporal_shift.cu"
K4_SOURCE = "shift_gcn_torch/csrc/shift_gcn.cu"
TSHIFT_PALLAS = "shift_gcn_tpu/ops/pallas/temporal_shift_kernel.py"
SGCN_PALLAS = "shift_gcn_tpu/ops/pallas/shift_gcn_kernel.py"
# kernel -> (source, the TPU kernel it replaces)
KERNEL_ROWS = {
    "temporal_shift": (K1_SOURCE, f"{TSHIFT_PALLAS}:88"),
    "temporal_shift_backward": (K1_SOURCE, f"{TSHIFT_PALLAS}:192"),
    "shift_gcn": (K4_SOURCE, f"{SGCN_PALLAS}:88"),
    "shift_gcn_dx": (K4_SOURCE, f"{SGCN_PALLAS}:143"),
    "shift_gcn_wgrad": (K4_SOURCE, f"{SGCN_PALLAS}:158"),
}
TRAIN_CONFIG = "configs/mediapipe/train_joint.yaml"
FOURSTREAM_CONFIG = "configs/mediapipe/train_fourstream.yaml"
STREAMS = 4
GY_RAW_TOL = 2e-5      # of sum|terms|: gy_raw vs its plain version (phases 7, 8)
WGRAD_TOL = 2e-5       # of scale: K6's outputs vs its plain version (phase 7)
STEP_GRAD_TOL = 1e-5   # of scale: a true gradient, kernel vs plain step
# biases that feed a train-mode BN normalizing over their broadcast axes:
# its mean subtraction cancels them, so their exact gradient is 0 and the
# step computes roundoff; each is held at STEP_GRAD_TOL of the scale of its
# layer's weight gradient, whose terms are of the same size
ZERO_GRAD_BIASES = {"gcn1.Linear_bias": "gcn1.Linear_weight",
                    "down.0.bias": "down.0.weight",
                    "residual.conv.bias": "residual.conv.weight"}
TRAIN_CLIPS, VAL_CLIPS = 512, 128
# launches per train step of the 10-unit model: each unit runs K1 twice
# and K4 once forward; backward the fused K2+K3 once per K1, K5 once per
# K4 (every unit's input needs its gradient: unit 1's is data_bn's
# output), K6 once per K4
PER_STEP = {"temporal_shift": 20, "temporal_shift_backward": 20,
            "shift_gcn": 10, "shift_gcn_dx": 10, "shift_gcn_wgrad": 10}
PER_EVAL_FORWARD = {"temporal_shift": 20, "shift_gcn": 10}
# live serving (phases 12, 13): a landmark track of 3 windows streamed at
# hop == the offline stride, then at a tenth of a window for the latency;
# an artifact scores ARTIFACT_CLIPS clips in batches of N_WINDOWS, the
# last one padded
STREAM_WINDOWS = 3
ARTIFACT_CLIPS = 130
# device kernels by the name they show in the profiler, first match wins
PROFILE_GROUPS = (
    ("K1 temporal shift", ("tshift_forward_kernel",)),
    ("K2+K3 fused backward", ("tshift_backward_kernel",
                              "tshift_position_final_kernel")),
    ("K4 shift_gcn", ("shift_gcn_mma_kernel<float, false",
                      "shift_gcn_mma_kernel<__nv_bfloat16, false")),
    ("K5 dx", ("shift_gcn_mma_kernel<float, true",
               "shift_gcn_mma_kernel<__nv_bfloat16, true")),
    ("K6 weight gradients", ("wgrad_partial_kernel", "wgrad_final_kernel")),
    ("cuBLAS / cuDNN", ("gemm", "xmma", "cutlass", "sm90_", "convolve")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",)),
)


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


def sig(x: float) -> float:
    """x to 4 significant digits."""
    return float(f"{x:.4g}")


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
    """(bytes time, operations time) of one launch, the operations on the
    tensor cores at the 3xTF32 rate."""
    moved = (r * V * c + r * V * d) * itemsize + (V * c + c * d + d) * 4
    flops = 2.0 * r * V * c * d
    return moved / HBM_BYTES_PER_S * 1e3, flops / TF32_3X_FLOPS * 1e3


def k4_simt_ms(r, c, d):
    """The same flops at the fp32 SIMT rate, the bound of the SIMT
    template K4 and K5 replaced; printed beside the tensor-core bound."""
    return 2.0 * r * V * c * d / FP32_SIMT_FLOPS * 1e3


def sass_report(path: str):
    """{function label: (HMMA instructions, registers)} of the K4/K5/K6
    functions in the library at ``path``, or None without ``cuobjdump``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None

    def dump(flag):
        return subprocess.run([tool, flag, path], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    def label(mangled):
        dtype = "bf16" if "bfloat16" in mangled else "fp32"
        if "wgrad_partial_kernel" in mangled:
            return f"K6 {dtype}"
        kind = "K5" if "Lb1E" in mangled else "K4"
        tile = re.search(r"Li(\d+)E", mangled)
        return f"{kind} {dtype} {tile.group(1) if tile else '?'}-col"

    def tensor_kernel(fn):
        return "shift_gcn_mma_kernel" in fn or "wgrad_partial_kernel" in fn

    report, fn = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if tensor_kernel(fn):
                report[label(fn)] = [0, None]
        elif fn and tensor_kernel(fn) and "HMMA" in line:
            report[label(fn)][0] += 1
    for fn, regs in re.findall(r"Function ([^\s:]+):\s*REG:(\d+)",
                               dump("-res-usage")):
        if tensor_kernel(fn):
            report.setdefault(label(fn), [0, None])[1] = int(regs)
    return {k: tuple(v) for k, v in sorted(report.items())}


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
def plain_path(keep=()):
    """Route the raw kernel launchers (forward and backward, the fused
    temporal-shift backward and its one-output forms) to their plain
    versions, but those named in ``keep``; the autograd Functions around
    them stay."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts

    swaps = ((ts, "temporal_shift_forward", ts.temporal_shift_reference),
             (ts, "temporal_shift_backward",
              ts.temporal_shift_backward_reference),
             (ts, "temporal_shift_grad_input",
              ts.temporal_shift_grad_input_reference),
             (ts, "temporal_shift_position_grad",
              ts.temporal_shift_position_grad_reference),
             (sk, "shift_gcn_forward", ss.shift_gcn_transform),
             (sk, "shift_gcn_dx", ss.shift_gcn_dx_reference),
             (sk, "shift_gcn_wgrad", ss.shift_gcn_wgrad_reference))
    patches = [mock.patch.object(mod, name, fn) for mod, name, fn in swaps
               if name not in keep]
    for patch in patches:
        patch.start()
    try:
        yield
    finally:
        for patch in patches:
            patch.stop()


def profile_call(fn, label: str, card: str, top: int = 10):
    """Device time of one call of ``fn`` by operator (torch.profiler) and
    the device's busy share of the call's wall time, which it returns
    (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        return None
    print(f"[profile] {label}: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%, profiler on) | {card}")
    for e in rows[:top]:
        us = self_device_us(e)
        if us == 0:
            break
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  x{e.count:<4d} {e.key[:70]}")
    groups = {}
    for e in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(
            m in e.key for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + self_device_us(e) / 1e3
    print("[profile]   by group: " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%)" for g, ms in
        sorted(groups.items(), key=lambda kv: -kv[1])))
    return busy_ms / wall_ms


def shift_positions(rng, c: int, kind: str) -> np.ndarray:
    """ypos for a check: U(-1, 1), the model's init, with an integer shift
    and two near the tap radius +-(8 - 1); or, for "far", U(-7, 7) with
    +-20.3 and +-7.4: lo at +-20 and a spread of 14 frames across a slab,
    more than a staged window holds."""
    if kind == "far":
        y = rng.uniform(-7.0, 7.0, c).astype(np.float32)
        y[:4] = (20.3, -20.3, 7.4, -7.4)
    else:
        y = rng.uniform(-1.0, 1.0, c).astype(np.float32)
        y[:4] = (1.0, -1.0, 6.9, -6.9)
    return y


def check_forward_shift(k1_shapes, gen, rng, dev) -> float:
    """Phase 3: K1 bit-equal to its plain version, fp32 and bf16 (both
    round the same two fp32 products and their sum, and a bf16 output
    once), at every forward launch shape; with shifts far outside its
    staged window at the largest stride-1 and stride-2 shapes; with
    1-element lanes and an odd T (C=130, T=75, stride 2); on an input that
    starts one element into its storage (also 1-element lanes); and at
    V=144, where fewer frames fit in shared memory.  Returns the fp32
    max |err| (0)."""
    from shift_gcn_torch.ops import temporal_shift as ts

    shapes = sorted(set(k1_shapes))
    far = [max(sh for sh in k1_shapes if sh[2] == st) for st in (1, 2)]
    odd = (T_WINDOW // 4, 130, 2)
    wide_v = [(T_WINDOW // 4, 128, st) for st in (1, 2)]
    cases = ([(shape, V, "U(-1, 1)") for shape in shapes]
             + [(shape, V, "far") for shape in far]
             + [(odd, V, "C=130"), (far[0], V, "unaligned")]
             + [(shape, 144, "V=144") for shape in wide_v])
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for (t, c, stride), v, kind in cases:
            x = torch.randn(N_WINDOWS, t, v, c, generator=gen,
                            device=dev).to(dtype)
            if kind == "unaligned":
                buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                buf[1:].copy_(x.view(-1))
                x = buf[1:].view(x.shape)
            ypos = torch.from_numpy(shift_positions(
                rng, c, "far" if kind in ("far", "unaligned", "V=144")
                else "U(-1, 1)")).to(dev)
            got = ts.temporal_shift(x, ypos, stride)
            want = ts.temporal_shift_reference(x, ypos, stride)
            torch.cuda.synchronize()
            err, _ = max_err(got, want)
            if not torch.equal(got, want):
                fail(f"temporal_shift {dtype} T={t} C={c} s={stride} V={v} "
                     f"{kind}: max|err| {err:.3g}, not bit-equal")
            worst = max(worst, err)
            del x, got, want
        errs[dtype] = worst
        print(f"[k1] temporal_shift {str(dtype)[6:]}: bit-equal to its plain "
              f"version (max|err| {worst:.3g}) at {len(shapes)} forward "
              f"shapes (T, C, s) {shapes} with ypos U(-1, 1), at {far} with "
              f"far shifts, at {odd} (1-element lanes, odd T), at {far[0]} "
              f"unaligned and at {wide_v} with V=144")
    torch.cuda.empty_cache()
    return errs[torch.float32]


# ---------------------------------------------------------------------------
# Training: backward kernels, one train step, the Trainer, timings
# ---------------------------------------------------------------------------


def train_shapes(config, t: int):
    """Per launch of one train step: the fused K2+K3 (t_in, c, stride) as
    K1's; K5 and K6 (t, c, d) as K4's."""
    return forward_shapes(config, t)


def k23_cost_ms(n, t_in, c, stride, itemsize=4):
    """The fused K2+K3: read x and the cotangent, write grad_input and C
    floats; 6 flops per input element (1 - f, two products and a sum for
    dx; b - a and a multiply-add for gy_raw)."""
    x = n * t_in * V * c
    moved = (2 * x + n * (t_in // stride) * V * c) * itemsize + 2 * c * 4
    return moved / HBM_BYTES_PER_S * 1e3, 6.0 * x / FP32_SIMT_FLOPS * 1e3


def k6_cost_ms(r, c, d, itemsize=4, flops_per_s=TF32_3X_FLOPS):
    """K6: read x, the cotangent, gate and W once, write dgate, dW and
    dbias once; 2*R*V*C*D flops at ``flops_per_s`` (fp32-accurate
    products: the 3xTF32 rate; of bf16 inputs: exact at the bf16 rate)."""
    moved = (r * V * c + r * V * d) * itemsize + (2 * (V * c + c * d) + d) * 4
    flops = 2.0 * r * V * c * d
    return moved / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3


def shift_conv_transpose_library(g, ypos, stride: int, t_in: int):
    """K2's yardstick: the transposed depthwise conv of
    ``shift_conv_library``, one ``F.conv_transpose2d`` with stride (s, 1)."""
    import torch.nn.functional as F

    n, t_out, v, c = g.shape
    w, radius = depthwise_taps(ypos, stride, g.dtype)
    gc = g.permute(0, 3, 1, 2)
    pad_end = t_in - (t_out - 1) * stride - 1

    def call():
        out = F.conv_transpose2d(gc, w, stride=(stride, 1),
                                 padding=(radius, 0),
                                 output_padding=(pad_end, 0), groups=c)
        return out.permute(0, 2, 3, 1)

    return call


def position_grad_library(x, g, ypos, stride: int):
    """K3's yardstick: ``torch.nn.grad.conv2d_weight`` of the depthwise
    conv (one call), then the difference of the two taps at lo + 1 and lo,
    over N."""
    n, t_in, v, c = x.shape
    w, radius = depthwise_taps(ypos, stride, x.dtype)
    y = ypos.float() + (0.0 if stride == 1 else 0.5)
    lo = torch.floor(y).long() + radius
    ch = torch.arange(c, device=x.device)
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

    def call():
        dw = torch.nn.grad.conv2d_weight(
            xc, w.shape, gc, stride=(stride, 1), padding=(radius, 0),
            groups=c)[:, 0, :, 0].float()
        return (dw[ch, lo + 1] - dw[ch, lo]) / n

    return call


def depthwise_taps(ypos, stride: int, dtype):
    """(C, 1, 2P+1, 1) depthwise conv taps of the shift and P."""
    c = ypos.shape[0]
    y = ypos.float() + (0.0 if stride == 1 else 0.5)
    lo = torch.floor(y)
    frac = y - lo
    lo = lo.long()
    radius = int(max(int((-lo).max()), int((lo + 1).max()), 1))
    w = torch.zeros(c, 2 * radius + 1, device=ypos.device)
    ch = torch.arange(c, device=ypos.device)
    w[ch, lo + radius] = 1.0 - frac
    w[ch, lo + radius + 1] = frac
    return w.to(dtype).view(c, 1, 2 * radius + 1, 1), radius


def check_fused_backward(x, g, ypos, stride: int, label: str):
    """The fused K2+K3 vs its plain version on one input: dx at 1e-6 (fp32)
    or 2^-8 (bf16) of scale, gy_raw within GY_RAW_TOL of the sum of its
    |terms|, the ypos steps equal on every channel clear of that bound;
    a second launch bit-equal, and the one-output launchers bit-equal to
    the fused one.  Returns (dx max|err|, gy_raw max|err|, channels at a
    tie)."""
    from shift_gcn_torch.ops import temporal_shift as ts

    t = x.shape[1]
    dx, raw = ts.temporal_shift_backward(x, g, ypos, stride)
    dx2, raw2 = ts.temporal_shift_backward(x, g, ypos, stride)
    dx_only = ts.temporal_shift_grad_input(g, ypos, stride, t)
    raw_only = ts.temporal_shift_position_grad(x, g, ypos, stride)
    want_dx, raw_ref = ts.temporal_shift_backward_reference(
        x, g, ypos, stride)
    torch.cuda.synchronize()
    err, scale = max_err(dx, want_dx)
    # fp32: identical rounding steps; bf16: one bf16 rounding
    tol = (1e-6 if x.dtype == torch.float32 else 2 ** -8) * scale
    if not err <= tol:
        fail(f"K2+K3 {label}: dx max|err| {err:.3g} > {tol:.3g}")
    # the same fp32 terms summed in another order (over input frames,
    # x[k] * (b - a)): the error is bounded by a few ulps of the sum of
    # |terms| (fp32 eps 6e-8 times the ~log depth of either order);
    # GY_RAW_TOL leaves margin
    _, x0, x1 = ts._source_frames(x, ypos, stride)
    abs_sum = ((x1 - x0).abs() * g.float().abs()).mean(0).sum((0, 1))
    bound = GY_RAW_TOL * abs_sum
    diff = (raw - raw_ref).abs()
    if not bool((diff <= bound).all()):
        fail(f"K2+K3 {label}: gy_raw off by "
             f"{float((diff / bound).max()):.3g} x its bound")
    clear = raw_ref.abs() > bound
    steps = ts.constraint_step(raw) == ts.constraint_step(raw_ref)
    if not bool(steps[clear].all()):
        fail(f"K2+K3 {label}: a ypos step differs on a channel clear of a "
             "tie")
    if not (torch.equal(raw, raw2) and torch.equal(dx, dx2)):
        fail(f"K2+K3 {label}: two launches on one input differ")
    if not (torch.equal(dx, dx_only) and torch.equal(raw, raw_only)):
        fail(f"K2+K3 {label}: a one-output launch differs from the fused "
             "one")
    return err, float(diff.max()), int((~clear).sum())


def check_wgrad(x, g, gate, w, label: str):
    """K6 vs its plain version on one input: dgate, dW and dbias each
    within WGRAD_TOL of its scale (another summation order over R, and
    3xTF32 products for fp32 inputs; bf16 inputs multiply exactly on both
    sides), and a second launch bit-equal.  Returns the largest max |err|
    of the three and the largest max |err| / scale."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss

    got = sk.shift_gcn_wgrad(x, g, gate, w)
    again = sk.shift_gcn_wgrad(x, g, gate, w)
    want = ss.shift_gcn_wgrad_reference(x, g, gate, w)
    torch.cuda.synchronize()
    worst = worst_rel = 0.0
    for name, a, b, ref in zip(("dgate", "dW", "dbias"), got, again, want):
        err, scale = max_err(a, ref)
        if not err <= WGRAD_TOL * scale:
            fail(f"K6 {label}: {name} max|err| {err:.3g} > "
                 f"{WGRAD_TOL * scale:.3g}")
        if not torch.equal(a, b):
            fail(f"K6 {label}: {name} differs between two launches")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale)
    return worst, worst_rel


def check_backward_kernels(config, gen, rng, dev):
    """Phase 7: each backward kernel vs its plain version at every launch
    shape of one train step, fp32 and bf16; the fused K2+K3 also with
    shifts far outside its staged window, with 1-element lanes and at
    V=144 (K4's largest), where fewer frames fit in shared memory; K6 also
    at V=144, where a block takes a group of the joints.  Returns the fp32
    max |err| per kernel (the fused one's over dx and gy_raw)."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss

    k1_shapes, k4_shapes = train_shapes(config, T_WINDOW)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst = {"temporal_shift_backward": 0.0, "shift_gcn_dx": 0.0,
                 "shift_gcn_wgrad": 0.0}
        gy_worst = k6_rel = 0.0
        ties = channels = 0
        cases = [(shape, "U(-1, 1)") for shape in sorted(set(k1_shapes))]
        # shifts the staged window cannot hold: lo at +-20 and a spread of
        # 14 frames across the slab, at stride 1 and 2
        far = [max(sh for sh in k1_shapes if sh[2] == st) for st in (1, 2)]
        cases += [(shape, "far") for shape in far]
        # C not a multiple of 4 and an odd T: the 1-element-lane path
        odd = (T_WINDOW // 4, 130, 2)
        cases.append((odd, "C=130"))
        wide_v = [(T_WINDOW // 4, 128, st) for st in (1, 2)]
        cases += [(shape, "V=144") for shape in wide_v]
        for (t, c, stride), kind in cases:
            v = 144 if kind == "V=144" else V
            x = torch.randn(N_WINDOWS, t, v, c, generator=gen,
                            device=dev).to(dtype)
            g = torch.randn(N_WINDOWS, t // stride, v, c, generator=gen,
                            device=dev).to(dtype)
            ypos = torch.from_numpy(shift_positions(
                rng, c, "far" if kind in ("far", "V=144") else kind)).to(dev)
            err, gy_err, tie = check_fused_backward(
                x, g, ypos, stride, f"{name} T={t} C={c} s={stride} {kind}")
            worst["temporal_shift_backward"] = max(
                worst["temporal_shift_backward"], err)
            gy_worst = max(gy_worst, gy_err)
            ties += tie
            channels += c
            del x, g
        for t, c, d in sorted(set(k4_shapes)):
            r = N_WINDOWS * t
            g = torch.randn(r, V, d, generator=gen, device=dev).to(dtype)
            gate = torch.tanh(torch.randn(V, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            got = sk.shift_gcn_dx(g, gate, w)
            want = ss.shift_gcn_dx_reference(g, gate, w)
            err, scale = max_err(got, want)
            # as K4: another summation order; bf16 may round to a neighbour
            tol = (2e-5 if dtype == torch.float32 else 2 ** -7) * scale
            if not err <= tol:
                fail(f"K5 {name} T={t} C={c} D={d}: max|err| {err:.3g} > "
                     f"{tol:.3g}")
            worst["shift_gcn_dx"] = max(worst["shift_gcn_dx"], err)
        # K6 at every train shape (unit 1's C=3 among them), and at V=144
        wide_k6 = (T_WINDOW // 4, 128, 128, 144)
        for t, c, d, v in [(*shape, V) for shape in sorted(set(k4_shapes))
                           ] + [wide_k6]:
            r = N_WINDOWS * t
            x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(r, v, d, generator=gen, device=dev).to(dtype)
            gate = torch.tanh(torch.randn(v, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            err, rel = check_wgrad(x, g, gate, w,
                                   f"{name} T={t} C={c} D={d} V={v}")
            worst["shift_gcn_wgrad"] = max(worst["shift_gcn_wgrad"], err)
            k6_rel = max(k6_rel, rel)
            del x, g
        torch.cuda.synchronize()
        print(f"[k2k3] {name}: fused backward at {len(set(k1_shapes))} train "
              f"shapes (T, C, s) {sorted(set(k1_shapes))}, at {far} with "
              f"far shifts, at {odd} and at {wide_v} with V=144: dx "
              f"max|err| "
              f"{worst['temporal_shift_backward']:.3g}, max|gy_raw err| "
              f"{gy_worst:.3g} (bound {GY_RAW_TOL:g} of sum|terms|), ypos "
              f"channels at a tie {ties} of {channels}; gy_raw and dx "
              "bit-equal across two launches and to the one-output "
              "launches")
        print(f"[k5k6] {name}: K5 at {len(set(k4_shapes))} shapes (T, C, D) "
              f"{sorted(set(k4_shapes))} max|err| "
              f"{worst['shift_gcn_dx']:.3g}; K6 at the same shapes and at "
              f"(T, C, D, V) {wide_k6}: max|err| of dgate, dW, dbias "
              f"{worst['shift_gcn_wgrad']:.3g}, at most {k6_rel:.3g} of "
              f"its scale (tol {WGRAD_TOL:g}), bit-equal across two "
              "launches")
        if dtype == torch.float32:
            # the fused kernel's row: the larger of its two outputs' errors
            errs = dict(worst, temporal_shift_backward=max(
                worst["temporal_shift_backward"], gy_worst))
        torch.cuda.empty_cache()
    return errs


def synthetic_batch(rng, n: int, t: int):
    """(N, 3, T, 33, 1) clips with a two-class signal, and labels."""
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, V, 1)).astype(np.float32) * 0.1
    data[:, 0] += (labels * 0.3)[:, None, None, None].astype(np.float32)
    return data, labels


def check_train_step(config, rng, dev, seed: int):
    """Phase 8: one fp32 train step's loss and gradients, kernel path vs
    plain path, from the same seeded state and batch."""
    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts
    from shift_gcn_torch.train.state import cross_entropy

    model = Model(config).init_weights(torch.Generator().manual_seed(seed))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    x = torch.from_numpy(data).to(dev)
    y = torch.from_numpy(labels).to(dev)

    def run():
        raws = []
        inner = ts.temporal_shift_backward

        def recorded(x_, g_, ypos_, stride_):
            dx, out = inner(x_, g_, ypos_, stride_)
            # gy_raw and the sum of |terms| its rounding scales with
            _, x0, x1 = ts._source_frames(x_, ypos_, stride_)
            raws.append((out.clone(), ((x1 - x0).abs() * g_.float().abs())
                         .mean(0).sum((0, 1))))
            return dx, out

        model.load_state_dict(start)
        model.train()
        model.zero_grad(set_to_none=True)
        # the Function gets gy_raw from the fused backward
        with mock.patch.object(ts, "temporal_shift_backward", recorded):
            loss = cross_entropy(model(x), y)
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in model.named_parameters()}
        return loss.item(), grads, raws

    def perturbed_k4(*args):
        # the plain K4 with 2^-22 relative noise, the size of K4's 3xTF32
        # difference from cuBLAS
        out = ss.shift_gcn_transform(*args)
        noise = torch.randn(out.shape, device=out.device,
                            generator=torch.Generator(device=out.device)
                            .manual_seed(seed))
        return out * (1.0 + 2.0 ** -22 * noise)

    def rel_gap(a, b):
        """Largest gap of a true gradient between two runs, of its scale."""
        return max(float((a[n] - b[n]).abs().max())
                   / max(float(b[n].abs().max()), 1e-30) for n in a
                   if not n.endswith(("xpos", "ypos", *ZERO_GRAD_BIASES)))

    loss, grads, raws = run()
    # The backward kernels against their plain versions on one forward: K4
    # runs on both sides.  The train step turns any fp32-order difference
    # in the forward into gradient differences of up to ~1e-3 of scale
    # (ReLU inputs within roundoff of 0 flip; each flip moves one term of
    # sums over ~6e5 terms): the whole plain path, and that path with
    # 2^-22 noise on K4's output, show it below.
    with plain_path(keep=("shift_gcn_forward",)):
        loss_p, grads_p, raws_p = run()
    with plain_path():
        loss_full, grads_full, _ = run()
        with mock.patch.object(sk, "shift_gcn_forward", perturbed_k4):
            _, grads_noise, _ = run()
    missing = [n for n, g in grads.items() if g is None]
    if missing:
        fail(f"no gradient on the kernel path for {missing[:5]}")
    for name, ref in (("plain backward", loss_p), ("plain", loss_full)):
        if not abs(loss - ref) <= 1e-5 * abs(ref):
            fail(f"train step loss {loss} vs {name} path {ref}")
    worst = zero_worst = 0.0
    ypos_equal = ypos_total = 0
    for name, g in grads.items():
        gp = grads_p[name]
        bias = next((b for b in ZERO_GRAD_BIASES if name.endswith(b)), None)
        if name.endswith("xpos"):
            if bool(g.any()):
                fail(f"{name}: nonzero xpos gradient")
        elif name.endswith("ypos"):
            ypos_equal += int((g == gp).sum())
            ypos_total += g.numel()
        elif bias is not None:
            weight = name[:-len(bias)] + ZERO_GRAD_BIASES[bias]
            scale = max(float(grads_p[weight].abs().max()), 1e-30)
            rel = max(float(g.abs().max()), float(gp.abs().max())) / scale
            if not rel <= STEP_GRAD_TOL:
                fail(f"{name}: gradient {rel:.3g} of its layer's weight "
                     "gradient scale, exact value 0")
            zero_worst = max(zero_worst, rel)
        else:
            # fp32 through 10 units: the backward kernels differ from the
            # plain versions only in roundoff (summation order; K5's
            # 3xTF32 splits, ~2^-22 relative); 1e-5 of each gradient's
            # largest entry
            rel = float((g - gp).abs().max()) / max(
                float(gp.abs().max()), 1e-30)
            if not rel <= STEP_GRAD_TOL:
                fail(f"{name}: gradient off by {rel:.3g} of its scale")
            worst = max(worst, rel)
    # gy_raw within phase 7's bound, 2e-5 of the sum of |terms|; the ypos
    # steps equal on every channel where |gy_raw| clears that bound
    ties = differ = 0
    gy_ratio = 0.0
    if len(raws) != len(raws_p) or len(raws) != 20:
        fail(f"{len(raws)} / {len(raws_p)} position-grad calls, expected 20")
    for (raw, abs_sum), (raw_p, _) in zip(raws, raws_p):
        bound = GY_RAW_TOL * abs_sum
        gap = (raw - raw_p).abs()
        ratio = float((gap / bound.clamp_min(1e-30)).max())
        if not bool((gap <= bound).all()):
            fail(f"gy_raw differs between the paths by {ratio:.3g} x its "
                 "bound")
        gy_ratio = max(gy_ratio, ratio)
        clear = raw_p.abs() > bound
        same = ts.constraint_step(raw) == ts.constraint_step(raw_p)
        if not bool(same[clear].all()):
            fail("a ypos step differs on a channel clear of a tie")
        ties += int((~clear).sum())
        differ += int((~same).sum())
    print(f"[step] fp32 train step, {N_WINDOWS} clips x T={T_WINDOW}: loss "
          f"{loss:.7f} vs {loss_p:.7f} plain backward, {loss_full:.7f} "
          f"plain; true gradients vs the plain backward max |diff|/scale "
          f"{worst:.3g} (tol {STEP_GRAD_TOL:g}); biases ahead of a train BN "
          f"at most {zero_worst:.3g} of their weight gradient's scale; vs "
          f"the whole plain path {rel_gap(grads, grads_full):.3g}, plain path "
          f"with 2^-22 noise on K4 vs plain "
          f"{rel_gap(grads_noise, grads_full):.3g}; gy_raw gap "
          f"at most {gy_ratio:.3g} of its bound ({GY_RAW_TOL:g} of "
          f"sum|terms|), {ties} channels inside it; ypos steps equal on "
          f"{ypos_equal} of {ypos_total} channels ({differ} differ, all "
          "inside the bound); every parameter has a gradient, xpos's is "
          "zero")
    del model, grads, grads_p, grads_full, grads_noise
    torch.cuda.empty_cache()
    return worst, gy_ratio


def training_config(config_path: str, rng, workdir: str, *extra: str):
    """The training config at ``config_path`` for one epoch, with eval and
    save, on TRAIN_CLIPS + VAL_CLIPS synthetic clips written under
    ``workdir``; returns it and the two splits' feeder arguments."""
    from shift_gcn_torch.train.config import load_config

    feeder_args = {}
    for split, n in (("train", TRAIN_CLIPS), ("val", VAL_CLIPS)):
        data, labels = synthetic_batch(rng, n, T_WINDOW)
        paths = {"data_path": os.path.join(workdir, f"{split}_data.npy"),
                 "label_path": os.path.join(workdir, f"{split}_label.pkl")}
        np.save(paths["data_path"], data)
        with open(paths["label_path"], "wb") as f:
            pickle.dump(([f"{split}{i}" for i in range(n)],
                         labels.tolist()), f)
        feeder_args[split] = paths
    cfg = load_config([
        "--config", config_path, "--num_epoch", "1", "--eval_interval", "1",
        "--save_interval", "1", "--log_interval", "4",
        "--work_dir", os.path.join(workdir, "work"),
        "--model_saved_name", os.path.join(workdir, "save"),
        "--train_feeder_args", json.dumps(feeder_args["train"]),
        "--test_feeder_args", json.dumps(feeder_args["val"]), *extra])
    if (cfg.batch_size, cfg.activation_dtype) != (N_WINDOWS, "bfloat16"):
        fail(f"{config_path} no longer trains batch {N_WINDOWS} in bf16")
    return cfg, feeder_args


def record_epochs(trainer):
    """Keep every ``train_epoch`` result of ``trainer`` in the returned
    list."""
    epochs = []
    train_epoch = trainer.train_epoch
    trainer.train_epoch = lambda e: epochs.append(train_epoch(e)) or epochs[-1]
    return epochs


def run_trainer(rng, dev, workdir: str):
    """Phase 9: ``Trainer.start()`` on the MediaPipe joint config for one
    epoch of synthetic data.  Returns the launch counts of the run and the
    epoch's statistics (``Trainer.train_epoch``)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.data.feeder import BatchIterator, Feeder
    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils.checkpoint import (
        latest_checkpoint, load_reference_checkpoint)

    cfg, feeder_args = training_config(TRAIN_CONFIG, rng, workdir)
    trainer = Trainer(cfg)
    epochs = record_epochs(trainer)
    steps = TRAIN_CLIPS // cfg.batch_size
    eval_forwards = -(-VAL_CLIPS // cfg.test_batch_size)

    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    expect = {k: PER_STEP[k] * steps + PER_EVAL_FORWARD.get(k, 0)
              * eval_forwards for k in PER_STEP}
    if launches != expect:
        fail(f"trainer launch counts {launches} != expected {expect}")
    losses = epochs[0]["losses"]
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"train losses {losses}")
    eval_dir = os.path.join(trainer.work_dir, "eval_results")
    ckpt = latest_checkpoint(trainer.save_dir)
    epoch_pkls = [p for p in os.listdir(eval_dir) if p.startswith("epoch_0_")]
    if ckpt is None or not os.path.exists(os.path.join(
            eval_dir, "best_acc.pkl")) or len(epoch_pkls) != 1:
        fail("the run left no checkpoint, best_acc.pkl or epoch pickle")
    with open(os.path.join(eval_dir, "best_acc.pkl"), "rb") as f:
        best_scores = pickle.load(f)

    # the checkpoint, in a fresh Model, reproduces the best scores
    state_dict, meta = load_reference_checkpoint(ckpt)
    model = Model(trainer.model_config)
    model.load_state_dict(state_dict, strict=True)
    test = BatchIterator(Feeder(**feeder_args["val"]), cfg.test_batch_size)
    gap = 0.0
    with torch.no_grad():
        for data, _, index, mask in test.epoch(0):
            x = torch.from_numpy(data).to(torch.bfloat16).to(dev).float()
            logits = model(x).cpu().numpy()
            for i in np.nonzero(mask > 0)[0]:
                gap = max(gap, float(np.abs(
                    logits[i] - best_scores[f"val{index[i]}"]).max()))
    if not gap <= 1e-5:
        fail(f"reloaded checkpoint scores differ by {gap:.3g}")
    print(f"[train] Trainer.start() on {TRAIN_CONFIG} (bf16, batch "
          f"{cfg.batch_size}, T={T_WINDOW}): {steps} steps + "
          f"{eval_forwards} eval batches in {wall:.1f} s, epoch "
          f"{epochs[0]['clips_per_sec']:.1f} clips/s with the feeder "
          f"{100 * epochs[0]['dataloader_share']:.1f}% of it (prefetch "
          "thread; the serial feeder took 14.7-19.2% of this epoch on an "
          "H100 80GB HBM3 at 700 W, root PERF.md section 5), losses "
          f"{[round(v, 4) for v in losses]}, best acc {best:.4f}, "
          f"checkpoint {os.path.basename(ckpt)} (epoch {meta['epoch']}, "
          f"step {meta['global_step']}) reproduces best_acc.pkl to {gap:.3g}; "
          f"launches {launches} = per step {PER_STEP} x {steps} + per eval "
          f"forward {PER_EVAL_FORWARD} x {eval_forwards}")
    del trainer, model
    torch.cuda.empty_cache()
    return launches, epochs[0]


def time_backward_kernels(config, gen, rng, dev, card: str):
    """Phase 10a: each backward kernel per train step (sum over its launch
    shapes), fp32, beside its bound, plain version and library call; the
    kernel also in bf16.  Returns {kernel: (ms, plain, bound, library,
    bytes_ms, ops_ms)} and {kernel: bf16 ms}."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts

    k1_shapes, k4_shapes = train_shapes(config, T_WINDOW)
    totals = {k: [0.0] * 6 for k in ("temporal_shift_backward",
                                     "shift_gcn_dx", "shift_gcn_wgrad")}
    bf16 = dict.fromkeys(totals, 0.0)
    k5_extra = {"simt": 0.0, "bound_bf16": 0.0}
    # the fused K2+K3: bf16 bound; fp32 and bf16 times at ypos U(-7, 7)
    k23_extra = {"bound_bf16": 0.0, "wide": 0.0, "wide_bf16": 0.0}
    # K6 on bf16 inputs: bound at the 3xTF32 rate and at the bf16 rate,
    # the library composition's time
    k6_extra = {"bound_bf16": 0.0, "bound_bf16_rate": 0.0, "library": 0.0}

    def add(kernel, count, ms, plain, lib, cost, ms_bf16):
        for i, val in enumerate((ms, plain, max(cost), lib) + cost):
            totals[kernel][i] += count * val
        bf16[kernel] += count * ms_bf16

    for t, c, stride in sorted(set(k1_shapes)):
        count = k1_shapes.count((t, c, stride))
        x = torch.randn(N_WINDOWS, t, V, c, generator=gen, device=dev)
        g = torch.randn(N_WINDOWS, t // stride, V, c, generator=gen,
                        device=dev)
        xb, gb = x.bfloat16(), g.bfloat16()
        ypos = torch.from_numpy(
            rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
        wide = torch.from_numpy(
            rng.uniform(-7, 7, c).astype(np.float32)).to(dev)
        lib2 = shift_conv_transpose_library(g, ypos, stride, t)
        lib3 = position_grad_library(x, g, ypos, stride)
        err2, _ = max_err(lib2(), ts.temporal_shift_grad_input_reference(
            g, ypos, stride, t))
        err3, scale3 = max_err(lib3(), ts.temporal_shift_position_grad_reference(
            x, g, ypos, stride))
        if not (err2 <= 1e-5 and err3 <= 1e-4 * scale3):
            fail(f"K2/K3 library yardsticks disagree ({err2:.3g}, "
                 f"{err3:.3g})")
        add("temporal_shift_backward", count,
            time_ms(lambda: ts.temporal_shift_backward(x, g, ypos, stride)),
            time_ms(lambda: ts.temporal_shift_backward_reference(
                x, g, ypos, stride)), time_ms(lib2) + time_ms(lib3),
            k23_cost_ms(N_WINDOWS, t, c, stride),
            time_ms(lambda: ts.temporal_shift_backward(
                xb, gb, ypos, stride)))
        k23_extra["bound_bf16"] += count * max(
            k23_cost_ms(N_WINDOWS, t, c, stride, itemsize=2))
        k23_extra["wide"] += count * time_ms(
            lambda: ts.temporal_shift_backward(x, g, wide, stride))
        k23_extra["wide_bf16"] += count * time_ms(
            lambda: ts.temporal_shift_backward(xb, gb, wide, stride))
        del x, g, xb, gb
    for t, c, d in sorted(set(k4_shapes)):
        count = k4_shapes.count((t, c, d))
        r = N_WINDOWS * t
        g = torch.randn(r, V, d, generator=gen, device=dev)
        gb = g.bfloat16()
        gate = torch.tanh(torch.randn(V, c, generator=gen, device=dev)) + 1
        w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
        idx_in = torch.from_numpy(
            spatial_flat_index(d, +1)).to(dev)
        idx_out = torch.from_numpy(spatial_flat_index(c, -1)).to(dev)
        wt = w.t().contiguous()

        def library():
            gz = g.view(r, V * d).index_select(1, idx_in).view(r, V, d)
            dh = torch.matmul(gz, wt) * gate
            return dh.view(r, V * c).index_select(1, idx_out).view(r, V, c)

        err, scale = max_err(library(), ss.shift_gcn_dx_reference(g, gate, w))
        if not err <= 1e-4 * scale:
            fail(f"K5 library yardstick disagrees ({err:.3g})")
        add("shift_gcn_dx", count,
            time_ms(lambda: sk.shift_gcn_dx(g, gate, w)),
            time_ms(lambda: ss.shift_gcn_dx_reference(g, gate, w)),
            time_ms(library), k4_cost_ms(r, d, c),
            time_ms(lambda: sk.shift_gcn_dx(gb, gate, w)))
        k5_extra["simt"] += count * k4_simt_ms(r, d, c)
        k5_extra["bound_bf16"] += count * max(k4_cost_ms(r, d, c, itemsize=2))
        del g, gb
    for t, c, d in sorted(set(k4_shapes)):
        count = k4_shapes.count((t, c, d))
        r = N_WINDOWS * t
        x = torch.randn(r, V, c, generator=gen, device=dev)
        g = torch.randn(r, V, d, generator=gen, device=dev)
        xb, gb = x.bfloat16(), g.bfloat16()
        gate = torch.tanh(torch.randn(V, c, generator=gen, device=dev)) + 1
        w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
        idx_c = torch.from_numpy(spatial_flat_index(c, +1)).to(dev)
        idx_d = torch.from_numpy(spatial_flat_index(d, +1)).to(dev)

        def library(xx, gg):
            # the composition K6 replaced: two index_select shears into
            # fp32, one per-joint fp32 bmm, three reductions
            sx = xx.view(r, V * c).index_select(1, idx_c).view(
                r, V, c).float()
            gz = gg.view(r, V * d).index_select(1, idx_d).view(
                r, V, d).float()
            m = torch.bmm(sx.permute(1, 2, 0), gz.permute(1, 0, 2))
            return ((m * w[None]).sum(-1), (m * gate[:, :, None]).sum(0),
                    gz.sum((0, 1)))

        for got, want in zip(library(x, g),
                             ss.shift_gcn_wgrad_reference(x, g, gate, w)):
            err, scale = max_err(got, want)
            if not err <= 1e-4 * scale:
                fail(f"K6 library yardstick disagrees ({err:.3g})")
        add("shift_gcn_wgrad", count,
            time_ms(lambda: sk.shift_gcn_wgrad(x, g, gate, w)),
            time_ms(lambda: ss.shift_gcn_wgrad_reference(x, g, gate, w)),
            time_ms(lambda: library(x, g)), k6_cost_ms(r, c, d),
            time_ms(lambda: sk.shift_gcn_wgrad(xb, gb, gate, w)))
        k6_extra["bound_bf16"] += count * max(k6_cost_ms(r, c, d, 2))
        k6_extra["bound_bf16_rate"] += count * max(
            k6_cost_ms(r, c, d, 2, BF16_FLOPS))
        k6_extra["library"] += count * time_ms(lambda: library(xb, gb))
        del x, g, xb, gb
    torch.cuda.empty_cache()
    per_step = {"temporal_shift_backward": len(k1_shapes),
                "shift_gcn_dx": len(k4_shapes),
                "shift_gcn_wgrad": len(k4_shapes)}
    extras = {
        "temporal_shift_backward":
            f", at bf16 I/O {k23_extra['bound_bf16']:.4f}; at ypos "
            f"U(-7, 7) {k23_extra['wide']:.4f} fp32, "
            f"{k23_extra['wide_bf16']:.4f} bf16",
        "shift_gcn_dx": f", at bf16 I/O {k5_extra['bound_bf16']:.4f}, "
                        f"fp32 SIMT {k5_extra['simt']:.4f}",
        "shift_gcn_wgrad":
            f", at bf16 I/O {k6_extra['bound_bf16']:.4f} (3xTF32 rate) / "
            f"{k6_extra['bound_bf16_rate']:.4f} (bf16 rate), library at "
            f"bf16 I/O {k6_extra['library']:.4f}"}
    for kernel, (ms, plain, bound, lib, bytes_ms, ops_ms) in totals.items():
        by = "operations" if ops_ms > bytes_ms else "bytes"
        extra = extras[kernel]
        print(f"[time] {kernel} per train step ({per_step[kernel]} launches, "
              f"{N_WINDOWS} clips x T={T_WINDOW}): {ms:.4f} ms fp32, "
              f"{bf16[kernel]:.4f} ms bf16 (bound {bound:.4f} by {by}"
              f"{extra}, plain {plain:.4f}, library {lib:.4f}) | {card}")
    return totals, bf16


def spatial_flat_index(channels: int, direction: int) -> np.ndarray:
    from shift_gcn_torch.ops import spatial_shift

    return spatial_shift.flat_shift_index(V, channels, direction)


def time_train_step(config, rng, dev, card: str, seed: int) -> None:
    """Phase 10b: one train step (forward, backward, SGD) at 64 clips x
    T=300, kernel path vs plain path, fp32 and bf16, then a profiled
    bf16 step on the kernel path (the Trainer's configuration).  Returns
    {dtype: (kernel ms, plain ms)} and the profiled step's busy share."""
    import dataclasses

    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step

    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    steps, busy = {}, None
    for act in (None, "bfloat16"):
        cfg = dataclasses.replace(config, activation_dtype=act)
        model = Model(cfg).init_weights(torch.Generator().manual_seed(seed))
        opt = build_optimizer(model, 0.1)

        def step():
            train_step(model, opt, batch, 0.1)

        times = {}
        for path in ("kernels", "plain", "kernels", "plain"):
            if path == "plain":
                with plain_path():
                    ms = time_ms(step, iters=3, reps=3)
            else:
                ms = time_ms(step, iters=3, reps=3)
            times.setdefault(path, []).append(ms)
        k, p = min(times["kernels"]), min(times["plain"])
        steps[act or "float32"] = (k, p)
        print(f"[time] train step {act or 'float32'}, {N_WINDOWS} clips x "
              f"T={T_WINDOW}: {k:.3f} ms kernels ({N_WINDOWS / k * 1e3:.1f} "
              f"clips/s), {p:.3f} ms plain path ({N_WINDOWS / p * 1e3:.1f} "
              f"clips/s); runs kernels {times['kernels']}, plain "
              f"{times['plain']} | {card}")
        if act == "bfloat16":
            busy = profile_call(step, f"one bf16 train step, {N_WINDOWS} "
                                "clips", card, top=16)
        del model, opt
        torch.cuda.empty_cache()
    return steps, busy


# ---------------------------------------------------------------------------
# Live serving: streaming shapes, the streaming detector, artifacts
# ---------------------------------------------------------------------------


def check_stream_shapes(config, gen, rng, dev) -> None:
    """Phase 11: K1 and K4 through their registered ops at the shapes of
    one streaming evaluation (one window, N=1: R = T, T/2, T/4 rows):
    K1 bit-equal to its plain version, K4 within 2e-5 of its scale, fp32."""
    from shift_gcn_torch.ops import library, spatial_shift
    from shift_gcn_torch.ops import temporal_shift as ts

    k1_shapes, k4_shapes = forward_shapes(config, T_WINDOW)
    k1_worst = k4_worst = 0.0
    for t, c, stride in sorted(set(k1_shapes)):
        x = torch.randn(1, t, V, c, generator=gen, device=dev)
        ypos = torch.from_numpy(shift_positions(rng, c, "U(-1, 1)")).to(dev)
        got = library.temporal_shift(x, ypos, stride)
        want = ts.temporal_shift_reference(x, ypos, stride)
        torch.cuda.synchronize()
        err, _ = max_err(got, want)
        if not torch.equal(got, want):
            fail(f"temporal_shift N=1 T={t} C={c} s={stride}: max|err| "
                 f"{err:.3g}, not bit-equal")
        k1_worst = max(k1_worst, err)
    for t, c, d in sorted(set(k4_shapes)):
        x = torch.randn(t, V, c, generator=gen, device=dev)
        gate = torch.tanh(torch.randn(V, c, generator=gen, device=dev)) + 1.0
        w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
        b = torch.randn(d, generator=gen, device=dev) * 0.1
        got = library.shift_gcn(x, gate, w, b)
        want = spatial_shift.shift_gcn_transform(x, gate, w, b)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        if not err <= 2e-5 * scale:
            fail(f"shift_gcn R={t} C={c} D={d}: max|err| {err:.3g} > "
                 f"{2e-5 * scale:.3g}")
        k4_worst = max(k4_worst, err)
    print(f"[stream-shapes] N=1: K1 bit-equal at {len(set(k1_shapes))} "
          f"shapes (T, C, s) (max|err| {k1_worst:.3g}); K4 at "
          f"{len(set(k4_shapes))} shapes (R, C, D) {sorted(set(k4_shapes))} "
          f"max|err| {k4_worst:.3g}, through the registered ops")


def hysteresis_events(probs, threshold: float):
    """The detector's events (min_consecutive 1) over a score sequence,
    and whether a fall is open at its end."""
    events, active = [], False
    for p in probs:
        event = None
        if p >= threshold and not active:
            active, event = True, "fall_start"
        elif p < threshold and active:
            active, event = False, "fall_end"
        events.append(event)
    return events, active


def spread_scores(predictor, windows: np.ndarray) -> None:
    """Shift (and, where it spreads wider than 2, shrink) every stream's
    classifier in place so that the ensemble's fall logit over these
    (pre-normalized) windows has mean 0: random weights otherwise
    saturate the softmax, and a threshold could then separate nothing.
    Never widened: that would widen the logits' roundoff with them."""
    from shift_gcn_torch.data.modalities import derive_modalities

    mods = derive_modalities(windows, predictor.graph)
    dev = next(iter(predictor._models.values())).fc.weight.device
    with torch.inference_mode():
        delta = sum(
            predictor.alpha[m] * (lambda z: z[:, 1] - z[:, 0])(model(
                torch.from_numpy(np.ascontiguousarray(mods[m])).to(dev)))
            for m, model in predictor._models.items())
        spread = float(delta.std())
        if not spread > 0:
            fail(f"streaming: the fall logit does not vary ({spread})")
        scale = min(1.0, 2.0 / spread)
        shift = -scale * float(delta.mean()) / sum(
            predictor.alpha[m] for m in predictor._models)
        for model in predictor._models.values():
            model.fc.weight.mul_(scale)
            model.fc.bias.mul_(scale)
            model.fc.bias[1] += shift


def check_streaming(predictor, rng, card: str):
    """Phase 12: a ``StreamingFallDetector`` over a landmark track of
    STREAM_WINDOWS windows at hop == the offline stride: its finalize()
    report equals ``run_on_landmarks`` (window probabilities and frame
    probabilities within 1e-5, the same intervals, the events the offline
    window scores give), with 20 K1 and 10 K4 launches per stream and
    evaluation; then the time from ``push`` to its update at a hop of a
    tenth of a window.  Returns (median ms, p90 ms)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.data.preprocess import pre_normalization
    from shift_gcn_torch.inference import pipeline, streaming

    hop, frames = T_WINDOW // 2, STREAM_WINDOWS * T_WINDOW
    streams = len(predictor._models)
    track = landmark_sequence(rng, frames)
    windows, _ = pipeline.create_sliding_windows(track, T_WINDOW, hop)
    graph = predictor.graph
    windows = pre_normalization(windows, zaxis=graph.zaxis, xaxis=graph.xaxis,
                                center_joint=list(graph.center_joint))
    spread_scores(predictor, windows)
    offline_probs = predictor.predict(windows)[:, 1]
    # a threshold inside the scores' range and clear of each of them by
    # more than the 1e-5 tolerance, so that events and intervals compare
    # exactly
    _, probe = streaming.run_stream(track, predictor, window=T_WINDOW,
                                    hop=hop)
    offline = pipeline.run_on_landmarks(track, predictor, window=T_WINDOW,
                                        stride=hop)
    values = np.unique(np.concatenate([
        offline_probs, [u.fall_prob for u in probe],
        offline["frame_probabilities"]]))
    gap = int(np.argmax(np.diff(values)))
    if not values[gap + 1] - values[gap] > 2e-5:
        fail(f"streaming: the scores {values} leave no threshold clear of "
             "them by 1e-5")
    threshold = float(values[gap] + values[gap + 1]) / 2
    offline = pipeline.run_on_landmarks(track, predictor, window=T_WINDOW,
                                        stride=hop, threshold=threshold)

    kernels.reset_launches()
    report, updates = streaming.run_stream(
        track, predictor, window=T_WINDOW, hop=hop, threshold=threshold)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the track ends on a hop, so finalize() scores no tail window
    evals = len(updates)
    expect = {name: PER_EVAL_FORWARD.get(name, 0) * streams * evals
              for name in kernels.KERNELS}
    if launches != expect:
        fail(f"streaming: launch counts {launches} != expected {expect} "
             f"({evals} evaluations x {streams} streams)")
    full = [u.fall_prob for u in updates if not u.partial]
    if len(full) != len(offline_probs):
        fail(f"streaming: {len(full)} full windows, offline "
             f"{len(offline_probs)}")
    win_err = float(np.abs(np.asarray(full) - offline_probs).max())
    frame_err = float(np.abs(np.asarray(report["frame_probabilities"])
                             - np.asarray(offline["frame_probabilities"])
                             ).max())
    if not (win_err <= 1e-5 and frame_err <= 1e-5):
        fail(f"streaming: window probabilities off by {win_err:.3g}, frame "
             f"probabilities by {frame_err:.3g} (tol 1e-5)")
    for key in ("total_frames", "num_windows", "fall_detected"):
        if report[key] != offline[key]:
            fail(f"streaming: {key} {report[key]} != offline {offline[key]}")
    spans = [(iv["start_frame"], iv["end_frame"]) for iv in
             report["fall_intervals"]]
    if spans != [(iv["start_frame"], iv["end_frame"])
                 for iv in offline["fall_intervals"]]:
        fail(f"streaming: intervals {spans} != offline "
             f"{offline['fall_intervals']}")
    partial = [u.fall_prob for u in updates if u.partial]
    want, still_open = hysteresis_events(partial + list(offline_probs),
                                         threshold)
    want += ["fall_end"] if still_open else []
    got = ([u.event for u in updates]
           + [u["event"] for u in report["final_updates"]])
    if got != want:
        fail(f"streaming: events {got} != those of the offline scores "
             f"{want}")
    print(f"[stream] {frames} frames, window {T_WINDOW}, hop {hop}, "
          f"{streams} streams: {evals} evaluations, launches {launches}, "
          f"max|p - p_offline| windows {win_err:.3g}, frames "
          f"{frame_err:.3g}, intervals {spans}, events "
          f"{[e for e in got if e]} at threshold {threshold:.6f}")

    hop = T_WINDOW // 10
    det = streaming.StreamingFallDetector(predictor, window=T_WINDOW,
                                          hop=hop)
    times = []
    kernels.reset_launches()
    for i in range(frames):
        t0 = time.perf_counter()
        upd = det.push(track[:, i])
        if upd is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    det.finalize()
    expect = {name: PER_EVAL_FORWARD.get(name, 0) * streams * len(times)
              for name in kernels.KERNELS}
    if dict(kernels.LAUNCHES) != expect:
        fail(f"streaming hop {hop}: launch counts {dict(kernels.LAUNCHES)} "
             f"!= expected {expect}")
    median = statistics.median(times)
    p90 = float(np.percentile(times, 90))
    print(f"[stream] hop {hop}: {len(times)} evaluations, push -> update "
          f"median {median:.3f} ms, p90 {p90:.3f} ms, max "
          f"{max(times):.3f} ms (host clock, {streams} batch-1 stream "
          f"forwards each) | {card}")

    # where an evaluation's time goes: the host's pre-normalization, the
    # four forwards (host clock, ending in the copy of the scores), one
    # batch-1 forward by CUDA events and its device busy share
    window = track[None, :, -T_WINDOW:]

    def prenorm():
        return pre_normalization(window.copy(), zaxis=graph.zaxis,
                                 xaxis=graph.xaxis,
                                 center_joint=list(graph.center_joint))

    def host_ms(fn, reps=15):
        spent = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            spent.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(spent)

    batch = prenorm()
    prenorm_ms = host_ms(prenorm)
    predict_ms = host_ms(lambda: predictor.predict(batch))
    model = predictor._models["joint"]
    x1 = torch.from_numpy(np.ascontiguousarray(batch)).to(
        model.fc.weight.device)
    with torch.inference_mode():
        fwd1 = time_ms(lambda: model(x1), iters=10, reps=5)
        busy = profile_call(lambda: model(x1), "one batch-1 stream forward "
                            f"(T={T_WINDOW})", card, top=5)
    print(f"[stream] an evaluation: pre-normalization {prenorm_ms:.3f} ms, "
          f"predict ({streams} streams) {predict_ms:.3f} ms (host clock); "
          f"one batch-1 stream forward {fwd1:.3f} ms (CUDA events), device "
          f"busy {'n/a' if busy is None else f'{100 * busy:.1f}%'} | {card}")
    return median, p90


def check_artifacts(state_dict, config, rng, dev, card: str):
    """Phase 13: one stream's model exported on the card at batch
    N_WINDOWS in both flavours, saved, loaded, and ARTIFACT_CLIPS clips
    scored through ``serve.score_clips`` (the last batch padded): the
    scores equal the live module's on the same batches within 1e-5, with
    20 K1 and 10 K4 launches per artifact batch; each artifact's time per
    batch beside the live module's.  Returns {flavour: (artifact ms, live
    ms)}."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.inference import export, pipeline, serve
    from shift_gcn_torch.models.shift_gcn import Model

    model = Model(config)
    model.load_state_dict(state_dict, strict=True)
    clips = np.stack([
        pipeline.create_sliding_windows(landmark_sequence(rng, T_WINDOW),
                                        T_WINDOW)[0][0]
        for _ in range(ARTIFACT_CLIPS)])
    batches = -(-ARTIFACT_CLIPS // N_WINDOWS)
    # the live module on the same zero-padded batches of N_WINDOWS: another
    # batch size may run other cuDNN / cuBLAS kernels, in another order
    padded = np.zeros((batches * N_WINDOWS,) + clips.shape[1:], np.float32)
    padded[:ARTIFACT_CLIPS] = clips
    with torch.inference_mode():
        live = np.concatenate([
            model(torch.from_numpy(padded[i:i + N_WINDOWS]).to(dev)).cpu()
            .numpy() for i in range(0, len(padded), N_WINDOWS)
        ])[:ARTIFACT_CLIPS]
    x = torch.from_numpy(clips[:N_WINDOWS]).to(dev)
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pt2_") as tmp:
        for flavour, exporter in (("inputs", export.export_eval),
                                  ("baked", export.export_eval_baked)):
            t0 = time.perf_counter()
            path = os.path.join(tmp, f"{flavour}.pt2")
            with open(path, "wb") as f:
                f.write(exporter(state_dict, config, N_WINDOWS, T_WINDOW))
            artifact = export.load_exported(path)
            export_s = time.perf_counter() - t0
            weights = None if flavour == "baked" else state_dict
            kernels.reset_launches()
            scores = serve.score_clips(artifact, clips, N_WINDOWS,
                                       weights=weights)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            expect = {name: PER_EVAL_FORWARD.get(name, 0) * batches
                      for name in kernels.KERNELS}
            if launches != expect:
                fail(f"artifact {flavour}: launch counts {launches} != "
                     f"expected {expect} ({batches} batches)")
            err = float(np.abs(scores - live).max())
            if scores.shape != live.shape or not err <= 1e-5:
                fail(f"artifact {flavour}: scores {scores.shape} off the "
                     f"live module by {err:.3g} (tol 1e-5)")
            call = artifact.module()
            args = ((x,) if weights is None else
                    ({k: v.to(dev) for k, v in weights.items()}, x))
            with torch.inference_mode():
                ms = time_ms(lambda: call(*args), iters=3, reps=5)
                live_ms = time_ms(lambda: model(x), iters=3, reps=5)
            times[flavour] = (ms, live_ms)
            print(f"[artifact] {flavour}: exported, saved and loaded in "
                  f"{export_s:.1f} s; {ARTIFACT_CLIPS} clips in {batches} "
                  f"batches of {N_WINDOWS}, max|logit - live| {err:.3g}, "
                  f"launches {launches}; {ms:.3f} ms a batch, live module "
                  f"{live_ms:.3f} ms | {card}")
    return times


# ---------------------------------------------------------------------------
# Four-stream training
# ---------------------------------------------------------------------------


def step_gap(before, after, ref) -> float:
    """Largest gap between two state_dicts after one step from the
    ``before`` weights, each parameter's as a share of the reference
    step's update of it (the update of its layer's weight for the biases
    whose exact gradient is 0); buffers (BN statistics) of their scale."""
    worst = 0.0
    for name, want in ref.items():
        gap = float((after[name].float() - want.float()).abs().max())
        if name.endswith(("shift_in", "shift_out", "num_batches_tracked")):
            if gap:
                fail(f"{name} differs after the step")
            continue
        base = name
        bias = next((b for b in ZERO_GRAD_BIASES if name.endswith(b)), None)
        if bias is not None:
            base = name[:-len(bias)] + ZERO_GRAD_BIASES[bias]
        if "running_" in name:
            scale = max(float(want.abs().max()), 1e-30)
        else:
            scale = max(float((ref[base] - before[base]).abs().max()), 1e-30)
        worst = max(worst, gap / scale)
    return worst


def run_fourstream(rng, dev, workdir: str, card: str):
    """Phase 14: four-stream training of the MediaPipe fall ensemble
    through ``Trainer.start()``, its pickles and checkpoint, the served
    ensemble, one step against four single-stream steps, and the device
    guard.  Returns the launch counts, the epoch's statistics and the
    four-stream step in ms."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.data.feeder import BatchIterator, Feeder
    from shift_gcn_torch.data.modalities import derive_modalities
    from shift_gcn_torch.graphs import get_graph
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
    from shift_gcn_torch.train import fourstream
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils import device_guard

    cfg, feeder_args = training_config(FOURSTREAM_CONFIG, rng, workdir,
                                       "--native_loader", "true")
    full = ModelConfig(num_class=2, num_point=V, num_person=1,
                       graph="mediapipe_pose", activation_dtype="bfloat16")
    trainer = Trainer(cfg)
    if not (cfg.fourstream and trainer.model_config == full
            and (cfg.base_lr, cfg.nesterov) == (0.1, True)):
        fail(f"{FOURSTREAM_CONFIG} no longer trains the four full-width "
             "streams with SGD nesterov at lr 0.1")
    if not trainer.feeders["train"].supports_native_batch():
        fail("the four-stream train feeder does not gather natively")
    epochs = record_epochs(trainer)
    steps = TRAIN_CLIPS // cfg.batch_size
    eval_forwards = -(-VAL_CLIPS // cfg.test_batch_size)

    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    expect = {k: STREAMS * (PER_STEP[k] * steps + PER_EVAL_FORWARD.get(k, 0)
                            * eval_forwards) for k in PER_STEP}
    if launches != expect:
        fail(f"four-stream launch counts {launches} != expected {expect}")
    stream_losses = np.asarray(epochs[0].get("stream_losses", []))
    if stream_losses.shape != (steps, STREAMS) or not np.isfinite(
            stream_losses).all():
        fail(f"four-stream losses {stream_losses.tolist()}")
    eval_dir = os.path.join(trainer.work_dir, "eval_results")
    pkls = {s: os.path.join(eval_dir, f"best_acc_{s}.pkl")
            for s in fourstream.STREAMS}
    pkls["ensemble"] = os.path.join(eval_dir, "best_acc.pkl")
    if not all(os.path.exists(p) for p in pkls.values()):
        fail(f"missing score pickles: {sorted(os.listdir(eval_dir))}")
    scores = {}
    for key, path in pkls.items():
        with open(path, "rb") as f:
            scores[key] = pickle.load(f)
    names = list(scores["ensemble"])
    ens_gap = max(float(np.abs(scores["ensemble"][n] - sum(
        a * scores[s][n] for a, s in zip(fourstream.ENSEMBLE_ALPHAS,
                                         fourstream.STREAMS))).max())
        for n in names)
    if not ens_gap <= 1e-5:
        fail(f"ensemble pickle off 0.6/0.6/0.4/0.4 of the streams by "
             f"{ens_gap:.3g}")

    # the checkpoint, served, reproduces every stream's pickle
    predictor = pipeline.EnsemblePredictor.from_fourstream_checkpoint(
        trainer.save_dir, model_config=trainer.model_config)
    parents = trainer.parents
    test = BatchIterator(Feeder(**feeder_args["val"]), cfg.test_batch_size)
    pkl_gap = 0.0
    with torch.no_grad():
        for data, _, index, mask in test.epoch(0):
            x = torch.from_numpy(data).to(torch.bfloat16).to(dev).float()
            derived = fourstream.derive_modalities_device(x, parents)
            for i, stream in enumerate(fourstream.STREAMS):
                logits = predictor._models[stream](derived[i]).cpu().numpy()
                for j in np.nonzero(mask > 0)[0]:
                    pkl_gap = max(pkl_gap, float(np.abs(
                        logits[j] - scores[stream][f"val{index[j]}"]).max()))
    if not pkl_gap <= 1e-5:
        fail(f"the served four-stream checkpoint misses the stream "
             f"pickles by {pkl_gap:.3g}")
    track = landmark_sequence(rng, STREAM_WINDOWS * T_WINDOW)
    per_modality = pipeline.EnsemblePredictor(
        {s: m.state_dict() for s, m in trainer.models.items()},
        model_config=trainer.model_config)
    got, want = (pipeline.run_on_landmarks(track, p, window=T_WINDOW,
                                           stride=150)
                 for p in (predictor, per_modality))
    serve_gap = float(np.abs(np.asarray(got["frame_probabilities"])
                             - np.asarray(want["frame_probabilities"])).max())
    if not (serve_gap <= 1e-5 and got["fall_intervals"]
            == want["fall_intervals"]):
        fail(f"run_on_landmarks through the four-stream checkpoint differs "
             f"from the per-modality predictor by {serve_gap:.3g}")
    del predictor, per_modality

    # one four-stream step vs four single-stream steps on the same weights
    def copies():
        models, opts = {}, {}
        for s, m in trainer.models.items():
            models[s] = Model(trainer.model_config)
            models[s].load_state_dict(m.state_dict())
            opts[s] = build_optimizer(models[s], cfg.base_lr)
            # a copy: load_state_dict keeps the momentum tensors it is
            # given, and SGD updates them in place
            opts[s].load_state_dict(copy.deepcopy(
                trainer.optimizers[s].state_dict()))
        return models, opts

    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    before = {s: {k: v.clone() for k, v in m.state_dict().items()}
              for s, m in trainer.models.items()}
    four, four_opts = copies()
    losses, _ = fourstream.train_step(four, four_opts, batch, cfg.base_lr,
                                      parents)
    single, single_opts = copies()
    mods = derive_modalities(data, get_graph(full.graph))
    ref_losses = [train_step(single[s], single_opts[s], {
        "data": torch.from_numpy(np.ascontiguousarray(mods[s])).to(dev),
        "label": batch["label"]}, cfg.base_lr)[0] for s in fourstream.STREAMS]
    loss_gap = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(losses, ref_losses))
    gap = max(step_gap(before[s], four[s].state_dict(),
                       single[s].state_dict()) for s in fourstream.STREAMS)
    equal = sum(torch.equal(v, single[s].state_dict()[k])
                for s in fourstream.STREAMS
                for k, v in four[s].state_dict().items())
    total = sum(len(m.state_dict()) for m in four.values())
    if not (loss_gap <= 1e-5 and gap <= STEP_GRAD_TOL):
        fail(f"four-stream step vs four single-stream steps: loss "
             f"{loss_gap:.3g}, weights {gap:.3g} of their update's scale")

    # the step's time and its peak memory beside a single-stream step's
    step_ms = time_ms(lambda: fourstream.train_step(
        four, four_opts, batch, cfg.base_lr, parents), iters=2, reps=3)
    peaks = {}
    for label, fn in (("four", lambda: fourstream.train_step(
            four, four_opts, batch, cfg.base_lr, parents)),
                      ("single", lambda: train_step(
            single["joint"], single_opts["joint"], batch, cfg.base_lr))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    # the device guard: healthy here; a failing probe raises, no sleep
    if not device_guard.device_healthy(dev):
        fail("device_guard.device_healthy() is false on the card")
    waits = []
    try:
        device_guard.check(healthy_fn=lambda: False, sleep_fn=waits.append)
        fail("device_guard.check() passed a failing probe")
    except device_guard.DeviceUnhealthyError:
        pass
    if len(waits) != 3:
        fail(f"device_guard.check() waited {waits}")

    stats = epochs[0]
    print(f"[fourstream] Trainer.start() on {FOURSTREAM_CONFIG} (4 streams, "
          f"bf16, batch {cfg.batch_size}, T={T_WINDOW}, native loader): "
          f"{steps} steps + {eval_forwards} eval batches in {wall:.1f} s, "
          f"epoch {stats['clips_per_sec']:.1f} clips/s with the feeder "
          f"{100 * stats['dataloader_share']:.1f}% of it; step "
          f"{step_ms:.3f} ms ({N_WINDOWS / step_ms * 1e3:.1f} clips/s, "
          f"{STREAMS * N_WINDOWS / step_ms * 1e3:.1f} stream-clips/s), peak "
          f"memory {peaks['four']:.2f} GiB vs {peaks['single']:.2f} GiB "
          f"single-stream; per-stream losses "
          f"{np.round(stream_losses, 4).tolist()}, best ensemble acc "
          f"{best:.4f}; ensemble pickle within {ens_gap:.3g} of "
          f"0.6/0.6/0.4/0.4 of the streams, served checkpoint within "
          f"{pkl_gap:.3g} of the stream pickles and {serve_gap:.3g} of the "
          f"per-modality predictor; one step vs four single-stream steps: "
          f"loss {loss_gap:.3g}, weights {gap:.3g} of the update's scale "
          f"({equal} of {total} tensors bit-equal); device guard healthy, "
          f"a failing probe raised after {len(waits)} checks; launches "
          f"{launches} = 4 x (per step {PER_STEP} x {steps} + per eval "
          f"forward {PER_EVAL_FORWARD} x {eval_forwards}) | {card}")
    del trainer, four, single, four_opts, single_opts
    torch.cuda.empty_cache()
    return launches, stats, step_ms


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
    print(f"[build] {len(kernels.SOURCES)} sources, "
          f"{len(kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    sass = sass_report(str(kernels.build_all()["shift_gcn"]))
    if sass is None:
        print("[build] no cuobjdump: the K4/K5/K6 HMMA count is not read")
    else:
        if len(sass) != 10 or any(h == 0 for h, _ in sass.values()):
            fail(f"K4/K5/K6 functions without tensor-core instructions: "
                 f"{sass}")
        print("[build] K4/K5/K6 functions, HMMA instructions / registers: "
              + ", ".join(f"{k} {h}/{r}" for k, (h, r) in sass.items()))

    # 3./4. each kernel vs its plain version at the forward's launches --
    config = ModelConfig(num_class=2, num_point=V, num_person=1,
                         graph="mediapipe_pose")
    k1_shapes, k4_shapes = forward_shapes(config, T_WINDOW)
    k1_err = check_forward_shift(k1_shapes, gen, rng, dev)

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
            # fp32: the kernel's 3xTF32 tensor-core products (each operand
            # split into two TF32 parts, the small*small term dropped, ~2^-22
            # relative) summed in another order than cuBLAS's fp32; bf16:
            # the two fp32 sums may round to neighbouring bf16 values
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
    expect = {name: PER_EVAL_FORWARD.get(name, 0) * forwards
              for name in kernels.KERNELS}
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
    # fp32 end to end; the only differences are K4's 3xTF32 rounding and
    # summation order
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
    # per stream forward in bf16: kernel ms, bound at bf16 I/O
    fwd_bf16 = {"temporal_shift": [0.0, 0.0], "shift_gcn": [0.0, 0.0]}
    k4_simt = 0.0
    k1_wide = [0.0, 0.0]  # K1 per stream forward at ypos U(-7, 7): fp32, bf16
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
        xb = x.bfloat16()
        ms16 = time_ms(lambda: temporal_shift.temporal_shift(xb, ypos,
                                                             stride))
        # spread-out shifts: more taps than a staged window holds
        wide = torch.from_numpy(
            rng.uniform(-7, 7, c).astype(np.float32)).to(dev)
        wide_ms = (time_ms(lambda: temporal_shift.temporal_shift(
                       x, wide, stride)),
                   time_ms(lambda: temporal_shift.temporal_shift(
                       xb, wide, stride)))
        bound16 = max(k1_cost_ms(N_WINDOWS, t, c, stride, itemsize=2))
        cost = k1_cost_ms(N_WINDOWS, t, c, stride)
        bound = max(cost)
        for i, val in ((0, ms), (1, plain), (2, bound), (3, lib),
                       (4, cost[0]), (5, cost[1])):
            totals["temporal_shift"][i] += count * val
        fwd_bf16["temporal_shift"][0] += count * ms16
        fwd_bf16["temporal_shift"][1] += count * bound16
        for i in range(2):
            k1_wide[i] += count * wide_ms[i]
        print(f"[time] temporal_shift T={t} C={c} s={stride} x{count}: "
              f"{ms:.4f} ms, {100 * bound / ms:.0f}% of bound {bound:.4f} "
              f"(plain {plain:.4f}, depthwise conv2d {lib:.4f}); bf16 "
              f"{ms16:.4f} ms, {100 * bound16 / ms16:.0f}% of bound "
              f"{bound16:.4f}; ypos U(-7, 7) {wide_ms[0]:.4f} fp32, "
              f"{wide_ms[1]:.4f} bf16 | {card}")
        del x, xb
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
        xb = x.bfloat16()
        ms16 = time_ms(lambda: shift_gcn_kernel.fused_shift_gcn(xb, gate, w,
                                                                b))
        bound16 = max(k4_cost_ms(rr, c, d, itemsize=2))
        cost = k4_cost_ms(rr, c, d)
        bound = max(cost)
        for i, val in ((0, ms), (1, plain), (2, bound), (3, lib),
                       (4, cost[0]), (5, cost[1])):
            totals["shift_gcn"][i] += count * val
        fwd_bf16["shift_gcn"][0] += count * ms16
        fwd_bf16["shift_gcn"][1] += count * bound16
        simt = k4_simt_ms(rr, c, d)
        k4_simt += count * simt
        by = "operations" if cost[1] > cost[0] else "bytes"
        print(f"[time] shift_gcn T={t} C={c} D={d} x{count}: {ms:.4f} ms "
              f"(bound {bound:.4f} by {by}, fp32 SIMT {simt:.4f}, plain "
              f"{plain:.4f}, index_select+matmul {lib:.4f}); bf16 "
              f"{ms16:.4f} ms (bound {bound16:.4f}) | {card}")
        del x, xb
    for name, (ms, _, bound, lib, _, _) in totals.items():
        ms16, bound16 = fwd_bf16[name]
        extra = (f", fp32 SIMT {k4_simt:.4f}" if name == "shift_gcn" else
                 f"; ypos U(-7, 7) {k1_wide[0]:.4f} ms fp32, "
                 f"{k1_wide[1]:.4f} ms bf16")
        print(f"[time] {name} per stream forward: {ms:.4f} ms fp32, "
              f"{100 * bound / ms:.0f}% of bound {bound:.4f} (library "
              f"{lib:.4f}), {ms16:.4f} ms bf16, {100 * bound16 / ms16:.0f}% "
              f"of bound {bound16:.4f}{extra} | {card}")

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
    with torch.inference_mode():
        profile_call(lambda: model(batch),
                     f"one forward, {N_WINDOWS} windows", card)

    del model, batch, predictor, state_dicts
    torch.cuda.empty_cache()

    # 7.-10. training ------------------------------------------------------
    train_errs = check_backward_kernels(config, gen, rng, dev)
    grad_gap, gy_ratio = check_train_step(config, rng, dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        train_launches, epoch = run_trainer(rng, dev, workdir)
    train_totals, train_bf16 = time_backward_kernels(config, gen, rng, dev,
                                                     card)
    steps, busy = time_train_step(config, rng, dev, card, args.seed)

    # 11.-13. live serving -------------------------------------------------
    check_stream_shapes(config, gen, rng, dev)
    serve_dicts = {m: state_dict_from_arrays(*random_arrays(config, rng))
                   for m in pipeline.MODALITY_ORDER}
    stream_p50, stream_p90 = check_streaming(
        pipeline.EnsemblePredictor(serve_dicts, model_config=config), rng,
        card)
    artifact_ms = check_artifacts(serve_dicts["joint"], config, rng, dev,
                                  card)

    # 14. four-stream training ----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _, epoch4, step4_ms = run_fourstream(rng, dev, workdir, card)

    entries = []
    rows = [(name, totals[name], launches[name], err) for name, err in
            (("temporal_shift", k1_err), ("shift_gcn", k4_err))]
    rows += [(name, train_totals[name], train_launches[name],
              train_errs[name]) for name in train_totals]
    for name, (ms, plain, bound, lib, bytes_ms, ops_ms), count, err in rows:
        source, replaces = KERNEL_ROWS[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": sig(err), "ms": sig(ms), "plain_ms": sig(plain),
            "bound_ms": sig(bound),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": sig(lib)})
    print("[note] kernel ms / plain_ms / bound_ms / library_ms, fp32: "
          "temporal_shift and shift_gcn per stream forward at "
          f"{N_WINDOWS} windows x T={T_WINDOW}, launches from the serving "
          "run; the three backward kernels (the fused K2+K3, K5, K6) per "
          f"train step at {N_WINDOWS} clips x T={T_WINDOW}, launches from "
          "the Trainer run, the fused kernel's library_ms the sum of two "
          "calls, K6's that of index_select x2 + bmm + three reductions; "
          "summary: phases 6, 8, 9, 10, 12, 13 and 14")
    # compact, so that the kernels, the summary and the card fit in the
    # last 2 kB of the output
    print(json.dumps({"kernels": entries}, separators=(",", ":")))
    (k32, p32), (k16, p16) = steps["float32"], steps["bfloat16"]
    print(f"[summary] ms kernel/plain: fwd {fwd:.4g}/{fwd_plain:.4g}, step "
          f"fp32 {k32:.4g}/{p32:.4g}, bf16 {k16:.4g}/{p16:.4g}; busy "
          f"{'n/a' if busy is None else f'{100 * busy:.1f}%'}; trainer "
          f"{epoch['clips_per_sec']:.1f} clips/s, feeder "
          f"{100 * epoch['dataloader_share']:.1f}%; K1 U(-7,7) "
          f"{k1_wide[0]:.4g}/{k1_wide[1]:.4g}; bf16 K1,K4 "
          f"{fwd_bf16['temporal_shift'][0]:.4g} "
          f"{fwd_bf16['shift_gcn'][0]:.4g}, K2+K3,K5,K6 "
          + " ".join(f"{train_bf16[k]:.4g}" for k in train_totals)
          + f"; grads {grad_gap:.2g}, gy_raw {gy_ratio:.2g}; stream "
          f"p50/p90 {stream_p50:.4g}/{stream_p90:.4g}; pt2 in/baked/live "
          f"{artifact_ms['inputs'][0]:.4g}/{artifact_ms['baked'][0]:.4g}/"
          f"{artifact_ms['inputs'][1]:.4g}; 4-stream step {step4_ms:.4g}, "
          f"epoch {epoch4['clips_per_sec']:.1f} clips/s, feeder "
          f"{100 * epoch4['dataloader_share']:.1f}%")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
