"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--k6-parent SHIFT_GCN_CU]
                          [--bn-only | --agcn-only]

Phases, in order; any failure exits non-zero:

1. card: prints ``nvidia-smi`` name / power limit and the torch device name;
2. build: compiles every kernel of ``shift_gcn_torch/csrc`` (one nvcc per
   source, in parallel) and prints the seconds it took, and, where the
   toolkit has ``cuobjdump``, the tensor-core (HMMA) instructions and the
   registers of each K4/K5/K6 function of the built library (K4 and K5
   with whole-frame and wide tiles, K6 for one joint group and for
   joint groups);
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
   of 8 steps on synthetic data, with eval and save, batches built on
   the train iterator's producer thread and staged one step ahead on the
   Trainer's worker thread; the launch counters
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
   the epoch's clips/s and the feeder's share;
15. lowering knobs on the full-width MediaPipe model, 64 clips x T=300,
   the kernels against the plain path on the same weights and batch:
   ``exact_xpos`` with xpos U(-0.9, 0.9) in fp32 (the eval forward within
   1e-4 of the logits' scale with 20 K1 / 10 K4 launches, and phase 8's
   train-step check); ``max_shift: 16`` with ypos U(-15, 15) (the forward
   in fp32 within 1e-4 and in bf16 within 3e-2, phase 8's step in fp32,
   a bf16 step within the bf16 envelope of
   tests/test_torch_train.py::test_bf16_step_within_envelope; a state
   dict with |ypos| = 12 loads under 16 and is refused under the default
   8); and one ``Trainer`` step each of ``configs/mediapipe/
   train_joint.yaml`` with ``lowering: {bn_lp: true}``, with
   ``{bn_lp_eval: false}``, and with fp32 activations and
   ``compute_dtype: bfloat16``, within that envelope of the plain path,
   with an eval forward;
16. NTU-60: ``Trainer.start()`` on ``configs/nturgbd-cross-subject/
   train_joint.yaml`` unchanged in model and batch (60 classes, V=25,
   M=2, batch 64, T=300, fp32; the largest batch that fits if 64 does
   not, printed) for one epoch of 4 steps on synthetic clips with eval
   and save: the launch counts equal 4 x the per-step counts plus one
   eval forward; K1 bit-equal, K4/K5 within 2e-5 of scale, the fused
   K2+K3 and K6 within phase 7's gates at every launch shape of the
   model (128 skeleton rows a batch); prints the step and forward times
   (CUDA events) and the step's peak memory;
17. the other families, each through ``Trainer.start()`` for 4 steps
   with eval and save, launching none of the port's Shift-GCN kernels
   (ST-GCN's train-mode BNs launch theirs), and held
   from its seeded init against the same module on the CPU and on the
   CPU in float64, with the same weights and clips (``card_vs_cpu``:
   logits within 1e-4 of scale of the CPU's; each gradient's relative
   L2 gap to float64 within GRAD_RATIO x the CPU fp32's plus
   GRAD_FLOOR; ``index_add_`` adds in no fixed order on the card):
   ST-GCN with ``configs/stgcn_edges.yaml``'s
   model_args (MediaPipe, V=33, M=1, 2 classes, channels 64..256,
   temporal kernel 9, adaptive B) at batch 64 x T=300, the CPU on 8 of
   the clips, and one step with ``adaptive_embed: 16``; ring-GNN with
   ``configs/synthetic_ring.yaml``'s (V=256, C=8, hidden 32/32) at its
   batch of 16 node-feature clips made in-process.  Both configs run
   here without their parallel-mode keys (``mesh_shape``,
   ``edge_partition``, ``edge_strategy``), in one process; phase 20
   runs them with those keys.  Prints the step times;
18. data and sequence parallelism on this card: (a) ``Trainer.start()``
   on ``configs/mediapipe/train_joint.yaml`` unchanged for 2 steps with
   eval, in an NCCL group of one rank, bit-equal in losses and every
   parameter to the run without a group; each kernel against its plain
   version, fp32 and bf16, at the launch shapes of a rank: 32 rows at
   T=300 for (b), and 32 rows of (c)'s time ranks, K1 and the fused
   K2+K3 on each shift's halo-extended block (odd at stride 2); (b) one
   fp32 step of the full-width model at 64 clips x T=300 in 2 gloo data
   ranks sharing the card (the group made by the ranks, ``run_ranks``
   starting this script once per rank) against the one-process step:
   the loss within 1e-5 relative, every true gradient, the input's
   gradient and every raw position gradient within PARALLEL_GRAD_TOL of
   its scale (stated before the first run: fp32-order changes flip
   ReLUs), ypos steps flipped only where the reference's raw gradient is
   within that share of 0, each rank's launches one step's; (c)
   ``configs/mediapipe/train_seqpar.yaml`` unchanged in model, batch 64,
   padding to 304 and bf16, at mesh [2, 2] (the one cut: 4 gloo ranks on
   this card), ``Trainer.start()`` for 2 steps with eval and save: every
   rank's launches the stated per-step counts x 2 plus an eval forward,
   losses and parameters equal across ranks, one checkpoint; then one
   fp32 step on each rank's rows and frames against the unsharded T=304
   step, as (b), and the same step with each of PLANTED_FAULTS (the
   reverse halo exchange dropped; sync BN's backward unaveraged), which
   the gates must catch.  Prints step times (ranks sharing one card, not
   a scaling figure), peak memory per rank and each fault's readings;
19. tensor parallelism on this card: (a) K4 and K5 within 2e-5 of scale
   (2^-7 in bf16) and K6 within phase 7's gates at every (shape, d0) a
   rank of [1, 2] (64 rows) and of [2, 2] (32 rows) launches in a train
   step at T=300, fp32 and bf16, the first unit's C=3 included, with
   each kernel's time a step at the last rank's slice beside its bound;
   (b) ``configs/mediapipe/train_joint.yaml`` unchanged in model, batch
   64 and bf16 through ``Trainer.start()`` at mesh [1, 2] in 2 gloo
   ranks sharing the card, 2 steps with eval and save: each rank's
   launches the per-step counts x 2 plus an eval forward, equal losses,
   each rank holding its slices; the full-layout checkpoint evaluated in
   this process alone within TP_SCORE_GATE of the run's scores, every
   prediction equal; then one fp32 step at 64 clips x T=300 on each rank
   against the one-process step, with 18b's gates; (c) that step at
   [2, 2] in 4 gloo ranks, and again with each of TP_FAULTS (K4 at
   d0 = 0 on every rank; the sharded gradients summed over the world),
   which the gates must catch.  Prints the step times (gathers through
   host memory: not a scaling figure) and peak memory per rank;
20. the edge partition on this card, its ranks sharing it over gloo and
   launching none of the port's Shift-GCN kernels: (a)
   ``Trainer.start()`` on ``configs/stgcn_edges.yaml`` unchanged in model
   (full-width ST-GCN, fp32) and batch (16, T=300), its mesh [2, 4] cut
   on the data axis to [1, 4] (``gather``, 4 ranks), 2 steps with eval
   and save: equal finite losses on every rank, one checkpoint, which
   evaluated in this process alone (the edge partition off) scores
   within EDGE_SCORE_GATE of the run's scores with every prediction
   equal; (b) one fp32 step of that model and batch from the seeded init
   at [1, 4] and [2, 2] against the one-process step: the loss within
   EDGE_LOSS_TOL relative, each gradient by phase 17's rule against the
   one-process float64 step on the CPU (GRAD_RATIO x the one-process
   fp32 step's relative L2 gap + GRAD_FLOOR; the biases a train-mode BN
   cancels within 5e-4 of their weight gradient's scale); (c)
   ``configs/synthetic_ring.yaml`` unchanged through ``Trainer.start()``
   at its mesh [1, 8] (``ring``, 8 ranks, node shards of 32), 4 steps
   with eval and save, its checkpoint scored in one process as (a), and
   one fp32 step against the one-process step, logits and gradients
   within RING_TOL of scale;
   (d) the steps again with each of EDGE_FAULTS planted (the partial
   sums' all-reduce with an identity backward; the ring's cotangents
   sent the forward's way), which the gates must catch.  Prints the
   step times and peak memory per rank (ranks sharing one card, not a
   scaling figure);
21. per-unit recomputation (``remat``) and the Trainer's trace and NaN
   check: (a) one step of ``configs/mediapipe/train_joint.yaml``'s model
   (64 clips x T=300) in fp32 and in bf16 and (b) one NTU-60 fp32 step
   (batch 64), each from one seeded state and batch without and with
   ``remat``: the loss and every parameter, BN buffer and momentum
   buffer after SGD bit-equal but those of NONREPEATING (cuDNN's
   stride-2 backward-filter, which adds in no fixed order: within
   STEP_GRAD_TOL of scale), and every one bit-equal again under
   ``cudnn.deterministic``; the launches PER_STEP and REMAT_STEP (K1
   40 and K4 20 a step), the peak memory with remat at most half the
   peak without; each step's peak memory and time printed beside
   REMAT_PREDICTION; (c) ``Trainer.start()`` on ``train_joint.yaml``
   with ``remat``, ``profile_dir`` and ``profile_steps: 2`` for one
   epoch of 4 steps with eval and save: the launches, one trace file of
   two ``ProfilerStep`` spans naming the five kernels' ``__global__``
   functions (no more than the two steps' 80 K1 launches), each one's
   device time printed, one log line; (d) ``debug_nans: true``: the run trains, and a batch with one
   planted NaN raises ``FloatingPointError`` naming ``data_bn``; (e)
   inside phase 18c's gloo ranks, the fp32 [2, 2] step again with
   ``remat``: loss and every gradient bit-equal to the same rank's step
   without it (NONREPEATING's within STEP_GRAD_TOL of scale),
   REMAT_STEP launches;
22. custom topologies and any joint count: (a) a 543-joint topology
   (MediaPipe Holistic's landmark count) and a 256-joint one, seeded
   trees, registered through ``graphs.register_graph`` and resolved by
   name; (b) at V = 145, 256 and 543, past K4/K5's 144-row frame tile,
   every kernel against its plain version at each launch shape of the
   default backbone with 8 clips, fp32 and bf16: K1 bit-equal and the
   fused K2+K3 within phase 7's gates at shifts far outside any staged
   window, K4 and K5 within phase 4's gates and K6 within phase 7's at
   d0 = 0 and d0 = D, K6 bit-equal across two launches, with phases 3
   and 7's odd and unaligned cases, and K6's shared memory as the
   library reckons it equal to ``wgrad_layout``'s; (c) one fp32 train
   step at V=543 (4 clips) on the kernel path against the plain
   backward, as phase 8; (d)
   ``Trainer.start()`` on ``configs/mediapipe/train_joint.yaml`` with
   its graph replaced by the registered 543-joint one, the default
   backbone, bf16, at the largest batch of WIDE_BATCHES whose step fits,
   4 steps with eval and save, the launches the per-step counts x 4 plus
   an eval forward, the step's time and the peak memory printed; (e)
   each kernel's time at V=543 over a step's launches at that batch,
   beside its bound, plain version and library call, and K6 also on
   bf16 inputs, with the bytes its blocks stage from L2 and, given
   ``--k6-parent`` (an earlier commit's csrc/shift_gcn.cu), beside that
   build's K6; (f) K4, K5 and K6 at V = 25 and 33 bit-equal to the
   parent commit's build, through the digests in V144_DIGESTS;
23. phase 9's ``Trainer.start()`` again on the same clips with
   ``use_mmap: false`` in both feeder arguments: the feeders hold the
   clips in memory, the epoch's batches come through ``BatchIterator``'s
   producer thread, the launches are phase 9's counts, and the 8 per-step
   losses and the best scores are phase 9's bit for bit; prints both
   runs' feeder shares;
24. the shift-op demo and the accuracy runbook: (a)
   ``scripts/torch_demo_shift_op.py``'s ``run_demo`` (ones(1, 8, 4, 5),
   C=5 fp32) at strides 1 and 2 in this process: the output bit-equal to
   the same function on the CPU (the plain versions), grad_ypos equal
   element for element (its 1e-4 tie steps included), grad_xpos exactly
   zero, grad_input within 1e-6 of scale, one K1 and one fused K2+K3
   launch a stride; (b) ``scripts/torch_reproduce_accuracy.sh`` in
   synthetic mode at production shape (64 + 64 clips of 3x300x33x1,
   ``configs/mediapipe/train_*.yaml`` unchanged: full width, batch 64,
   bf16; one epoch; data and work dirs in the phase's temporary
   directory), its process group killed once the joint stream's final
   ``.pt`` and the bone stream's log exist, then run again: the rerun
   skips both data stages, the joint stream resumes past its end with
   no epoch trained, four best-score pickles and the table, each
   stream's log naming ``cuda``; prints the phase's and each run's
   seconds;
25. train-mode BN (``csrc/batchnorm.cu``) at every BN call of one train
   step of the fall model (bf16 activations, data_bn fp32) and of NTU-60
   (fp32), 64 clips x T=300: the forward's mean and inv within BN_TOL
   of the plain version's, y bit-equal to the plain normalize given the
   kernels' statistics and within BN_TOL of scale (2^-7 in bf16) of the
   plain forward, the running statistics and the count, with lp also at
   the bf16 shapes; the backward's dw and db within BN_TOL of the sum of
   their terms' magnitudes and dx within BN_TOL of scale (2^-7 in bf16),
   from the same statistics; every output bit-equal across two
   launches; one train step of each model launching one BN forward and
   one backward per train-mode BN; and the step's BN calls timed
   forward and backward beside their bytes bound, the plain versions
   and ``F.batch_norm`` (forward and backward).  ``--bn-only`` runs
   phases 1, 2 and 25 alone;
26. 2s-AGCN's joint stream (``configs/nturgbd-cross-subject/
   train_joint_agcn.yaml``: the ``agcn2s`` family at the published
   widths, fp32) through the Trainer for 2 steps of 64 synthetic clips x
   T=300, launches counted from zero: 10 adjacency forwards and 10
   backwards a step (``csrc/adaptive.cu``), one BN forward and backward
   per train-mode BN, 10 9-tap conv forwards, input gradients and
   weight gradients a step (``csrc/agcn_tconv.cu``), no other kernel of
   the port's; the adjacency kernels against their plain versions at
   every unit's launch shape (G, P and de within ADJ_TOL of their
   largest value, P's columns summing to 1 over the source joints,
   bit-equal across two launches); their times over a step's launches
   beside their bytes bound and the plain versions; a bare train step's
   time, peak memory and busy share; no cuDNN convolution in a profiled
   forward and backward; the 9-tap conv kernels against their plain
   versions in float64 at every unit's launch shape (y, dx, dW and db
   within twice cuDNN fp32's gap or TCONV_FLOOR of their largest value,
   bit-equal across two launches), and their times over a step's
   launches beside the 3xTF32 bound, the plain versions and cuDNN's fp32
   forward and backward.
   ``--agcn-only`` runs phases 1, 2 and 26 alone.

The last four lines are a JSON object with one entry per kernel (and,
in each, its figures at V=543 from phase 22), a summary of the
end-to-end figures, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script fails.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
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
NTU60_CONFIG = "configs/nturgbd-cross-subject/train_joint.yaml"
STGCN_CONFIG = "configs/stgcn_edges.yaml"
RING_CONFIG = "configs/synthetic_ring.yaml"
BN_SOURCE = "shift_gcn_torch/csrc/batchnorm.cu"
BN_KERNELS = ("batch_norm_train", "batch_norm_train_backward")
# fp32: the kernels' sums against torch's, in another order: mean within
# BN_TOL of E|x|, inv of itself (var ~ 4 against E[x^2] ~ 4.25 for the
# N(0.5, 2) inputs: as well conditioned as the sums), dw and db of the sum
# of their terms' magnitudes, y and dx of their scale, the running
# statistics of theirs.  bf16 outputs: one rounding of the same fp32
# value may land on the neighbouring bf16 (2^-7 of scale).
BN_TOL = 1e-5
# the models phase 25 takes its BN shapes and launch counts from: the
# fall model as its Trainer runs it (bf16 activations), NTU-60 (fp32)
BN_MODELS = (("fall", TRAIN_CONFIG), ("NTU-60", NTU60_CONFIG))
# 2s-AGCN's joint stream and its adjacency kernels (phase 26)
AGCN_CONFIG = "configs/nturgbd-cross-subject/train_joint_agcn.yaml"
AGCN_SOURCE = "shift_gcn_torch/csrc/adaptive.cu"
AGCN_KERNELS = ("agcn_adjacency", "agcn_adjacency_backward")
AGCN_STEPS = 2   # Trainer steps of phase 26
# fp32: the kernels' sums over d*T products (forward) and V products
# (backward) in another order than the plain versions' matmuls: a few ulps
# of the largest value, amplified by the softmax's exponent
ADJ_TOL = 2e-5
# 2s-AGCN's 9-tap temporal conv kernels (phase 26)
TCONV_SOURCE = "shift_gcn_torch/csrc/agcn_tconv.cu"
TCONV_KERNELS = ("agcn_tconv", "agcn_tconv_input_grad",
                 "agcn_tconv_weight_grad")
# fp32: the kernels' 3xTF32 products summed in another order than
# cuDNN's fp32 convolution: each output within twice cuDNN's own gap to the
# float64 plain version, or this share of its largest value where cuDNN's
# gap is smaller
TCONV_FLOOR = 2e-5
# cuDNN's convolution kernels, by the names the profiler shows
CUDNN_CONV = ("cudnn", "dgrad_engine", "wgrad_alg0_engine", "implicit_gemm",
              "fprop_", "convolve")


# the edge-partition keys phase 17 drops from its configs (phase 20 keeps
# them)
MESH_KEYS = ("mesh_shape", "edge_partition", "edge_strategy")
NTU_STEPS = FAMILY_STEPS = 4   # train steps of phases 16 and 17
RING_BATCH = 16                # RING_CONFIG's batch_size
# phase 17: a card gradient's relative L2 gap to the float64 run may be
# GRAD_RATIO x the CPU fp32 run's plus GRAD_FLOOR (cuDNN's FFT
# convolutions on the card measured up to ~3x the CPU's gap, PERF.md)
GRAD_RATIO, GRAD_FLOOR = 4, 1e-3
STREAMS = 4
# ST-GCN's biases that feed a train-mode BN, and the weight whose gradient
# scale holds their roundoff (phases 17 and 20)
STGCN_ZERO_GRAD = (("gcn_bias", "gcn_weight"), ("tcn.bias", "tcn.weight"),
                   ("down.bias", "down.weight"))
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
# output), K6 once per K4; and one train-mode BN forward and backward per
# BN: data_bn, three a unit, a down BN in units 1, 5 and 8 and a residual
# BN in units 5 and 8; no 2s-AGCN adjacency or 9-tap conv
PER_STEP = {"temporal_shift": 20, "temporal_shift_backward": 20,
            "shift_gcn": 10, "shift_gcn_dx": 10, "shift_gcn_wgrad": 10,
            "batch_norm_train": 36, "batch_norm_train_backward": 36,
            "agcn_adjacency": 0, "agcn_adjacency_backward": 0,
            "agcn_tconv": 0, "agcn_tconv_input_grad": 0,
            "agcn_tconv_weight_grad": 0}
PER_EVAL_FORWARD = {"temporal_shift": 20, "shift_gcn": 10}
# a train step with ``remat`` (phase 21): each unit's forward runs again
# in the backward, K1, K4 and its 35 BNs (all but data_bn) with it; the
# backward kernels as PER_STEP.  The recomputation's early stop ends it at
# a unit's last saved tensor, the output of its final ReLU, after both K1
# launches, K4 and every BN: it trims no launch
REMAT_STEP = dict(PER_STEP, temporal_shift=40, shift_gcn=20,
                  batch_norm_train=71)
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
    ("train-mode BN", ("bnorm_",)),
    ("2s-AGCN 9-tap conv", ("agcn_tconv_",)),
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


def k1_cost_ms(n, t_in, c, stride, itemsize=4, v=V):
    """(bytes time, operations time) of one launch: each input read once,
    each output written once; 3 fp32 flops per output."""
    out = n * (t_in // stride) * v * c
    moved = (n * t_in * v * c + out) * itemsize + c * 4
    return moved / HBM_BYTES_PER_S * 1e3, 3.0 * out / FP32_SIMT_FLOPS * 1e3


def k4_cost_ms(r, c, d, itemsize=4, v=V):
    """(bytes time, operations time) of one launch, the operations on the
    tensor cores at the 3xTF32 rate."""
    moved = (r * v * c + r * v * d) * itemsize + (v * c + c * d + d) * 4
    flops = 2.0 * r * v * c * d
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
            # the template's bool argument: kStrips (joint groups)
            strips = " strips" if re.search(r"Lb1E", mangled) else ""
            return f"K6 {dtype}{strips}"
        # the template's bool arguments: kDx (K5), then kWide
        flags = re.findall(r"Lb([01])E", mangled)
        kind = "K5" if flags[:1] == ["1"] else "K4"
        wide = " wide" if flags[1:2] == ["1"] else ""
        tile = re.search(r"Li(\d+)E", mangled)
        return f"{kind} {dtype} {tile.group(1) if tile else '?'}-col{wide}"

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
    temporal-shift backward and its one-output forms, train-mode BN's) to
    their plain versions, but those named in ``keep``; the autograd
    Functions around them stay."""
    from shift_gcn_torch.ops import batchnorm as bn
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
             (sk, "shift_gcn_wgrad", ss.shift_gcn_wgrad_reference),
             (bn, "batch_norm_train_forward",
              bn.batch_norm_train_forward_reference),
             (bn, "batch_norm_train_backward",
              bn.batch_norm_train_backward_reference))
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


def k23_cost_ms(n, t_in, c, stride, itemsize=4, v=V):
    """The fused K2+K3: read x and the cotangent, write grad_input and C
    floats; 6 flops per input element (1 - f, two products and a sum for
    dx; b - a and a multiply-add for gy_raw)."""
    x = n * t_in * v * c
    moved = (2 * x + n * (t_in // stride) * v * c) * itemsize + 2 * c * 4
    return moved / HBM_BYTES_PER_S * 1e3, 6.0 * x / FP32_SIMT_FLOPS * 1e3


def k6_cost_ms(r, c, d, itemsize=4, flops_per_s=TF32_3X_FLOPS, v=V):
    """K6: read x, the cotangent, gate and W once, write dgate, dW and
    dbias once; 2*R*V*C*D flops at ``flops_per_s`` (fp32-accurate
    products: the 3xTF32 rate; of bf16 inputs: exact at the bf16 rate)."""
    moved = (r * v * c + r * v * d) * itemsize + (2 * (v * c + c * d) + d) * 4
    flops = 2.0 * r * v * c * d
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


def check_wgrad(x, g, gate, w, label: str, d0: int = 0):
    """K6 vs its plain version on one input (w the output channels from
    ``d0``): dgate, dW and dbias each within WGRAD_TOL of its scale
    (another summation order over R, and 3xTF32 products for fp32 inputs;
    bf16 inputs multiply exactly on both sides), and a second launch
    bit-equal.  Returns the largest max |err| of the three and the
    largest max |err| / scale."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss

    got = sk.shift_gcn_wgrad(x, g, gate, w, d0)
    again = sk.shift_gcn_wgrad(x, g, gate, w, d0)
    want = ss.shift_gcn_wgrad_reference(x, g, gate, w, d0)
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
    V=144 (K4's largest whole-frame tile), where fewer frames fit in
    shared memory; K6 also at V=144, where a block takes a group of the
    joints (phase 22 goes past it).  Returns the fp32
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


def synthetic_batch(rng, n: int, t: int, v: int = V):
    """(N, 3, T, V, 1) clips with a two-class signal, and labels."""
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, v, 1)).astype(np.float32) * 0.1
    data[:, 0] += (labels * 0.3)[:, None, None, None].astype(np.float32)
    return data, labels


def check_train_step(config, rng, dev, seed: int, prepare=None,
                     label: str = "fp32", clips: int = N_WINDOWS):
    """Phase 8: one fp32 train step's loss and gradients, kernel path vs
    plain path, from the same seeded state and a batch of ``clips``;
    ``prepare(model)`` edits the seeded state first (phase 15: the shift
    positions)."""
    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts
    from shift_gcn_torch.train.state import cross_entropy

    model = Model(config).init_weights(torch.Generator().manual_seed(seed))
    if prepare is not None:
        with torch.no_grad():
            prepare(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    data, labels = synthetic_batch(rng, clips, T_WINDOW, config.num_point)
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
    # and the train-mode BN forward run on both sides.  The train step
    # turns any fp32-order difference in the forward into gradient
    # differences of up to ~1e-3 of scale (ReLU inputs within roundoff of 0
    # flip; each flip moves one term of sums over ~6e5 terms): the whole
    # plain path, and that path with 2^-22 noise on K4's output, show it
    # below.
    with plain_path(keep=("shift_gcn_forward", "batch_norm_train_forward")):
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
    print(f"[step] {label} train step, {clips} clips x T={T_WINDOW}: loss "
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


def write_split(workdir: str, split: str, data: np.ndarray,
                labels: np.ndarray) -> dict:
    """Write one split's clips and labels under ``workdir``; returns its
    feeder arguments."""
    paths = {"data_path": os.path.join(workdir, f"{split}_data.npy"),
             "label_path": os.path.join(workdir, f"{split}_label.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"{split}{i}" for i in range(len(labels))],
                     np.asarray(labels).tolist()), f)
    return paths


def one_epoch_config(config_path: str, workdir: str, feeder_args: dict,
                     *extra: str):
    """The training config at ``config_path`` for one epoch, with eval and
    save, on the splits of ``feeder_args``, CLI overrides ``extra``."""
    from shift_gcn_torch.train.config import load_config

    return load_config([
        "--config", config_path, "--num_epoch", "1", "--eval_interval", "1",
        "--save_interval", "1", "--log_interval", "4",
        "--work_dir", os.path.join(workdir, "work"),
        "--model_saved_name", os.path.join(workdir, "save"),
        "--train_feeder_args", json.dumps(feeder_args["train"]),
        "--test_feeder_args", json.dumps(feeder_args["val"]), *extra])


def training_config(config_path: str, rng, workdir: str, *extra: str):
    """The training config at ``config_path`` for one epoch, with eval and
    save, on TRAIN_CLIPS + VAL_CLIPS synthetic clips written under
    ``workdir``; returns it and the two splits' feeder arguments."""
    feeder_args = {split: write_split(workdir, split,
                                      *synthetic_batch(rng, n, T_WINDOW))
                   for split, n in (("train", TRAIN_CLIPS),
                                    ("val", VAL_CLIPS))}
    cfg = one_epoch_config(config_path, workdir, feeder_args, *extra)
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


def epoch_launches(cfg):
    """The launches of ``Trainer.start()`` for one epoch of ``cfg`` on
    TRAIN_CLIPS + VAL_CLIPS clips, with eval: (per kernel, train steps,
    eval forwards)."""
    steps = TRAIN_CLIPS // cfg.batch_size
    eval_forwards = -(-VAL_CLIPS // cfg.test_batch_size)
    return ({k: PER_STEP[k] * steps + PER_EVAL_FORWARD.get(k, 0)
             * eval_forwards for k in PER_STEP}, steps, eval_forwards)


def read_split(paths: dict):
    """The clips and labels of a split that ``write_split`` wrote."""
    with open(paths["label_path"], "rb") as f:
        _, labels = pickle.load(f)
    return np.load(paths["data_path"]), np.asarray(labels)


def run_trainer(rng, dev, workdir: str):
    """Phase 9: ``Trainer.start()`` on the MediaPipe joint config for one
    epoch of synthetic data.  Returns the launch counts of the run, the
    epoch's statistics (``Trainer.train_epoch``) and what phase 23 runs
    again: the two splits' (clips, labels) and the best scores."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.data.feeder import BatchIterator, Feeder
    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils.checkpoint import (
        latest_checkpoint, load_reference_checkpoint)

    cfg, feeder_args = training_config(TRAIN_CONFIG, rng, workdir)
    trainer = Trainer(cfg)
    epochs = record_epochs(trainer)
    expect, steps, eval_forwards = epoch_launches(cfg)

    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

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
    replay = {"splits": {split: read_split(paths)
                         for split, paths in feeder_args.items()},
              "scores": best_scores}
    del trainer, model
    torch.cuda.empty_cache()
    return launches, epochs[0], replay


def run_in_memory(replay, first, dev, workdir: str, card: str):
    """Phase 23: phase 9's ``Trainer.start()`` again, on its clips
    (``replay``, from ``run_trainer``) written anew under ``workdir``,
    with ``use_mmap: false`` in both feeder arguments (``first``: phase
    9's epoch statistics).  The feeders must hold the clips in memory,
    the launches must be phase 9's counts, and the per-step losses and
    the best scores phase 9's bit for bit: the same seeded init, the same
    batches from the iterator's producer thread, and a bf16 step repeats
    its bits on the card (phase 21).  Returns the epoch's statistics."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.trainer import Trainer

    feeder_args = {split: dict(write_split(workdir, split, *arrays),
                               use_mmap=False)
                   for split, arrays in replay["splits"].items()}
    cfg = one_epoch_config(TRAIN_CONFIG, workdir, feeder_args)
    trainer = Trainer(cfg)
    mapped = [k for k, f in trainer.feeders.items()
              if isinstance(f.data, np.memmap)]
    if mapped:
        fail(f"23: the {mapped} feeders memory-map their clips under "
             "use_mmap: false")
    epochs = record_epochs(trainer)
    expect, steps, eval_forwards = epoch_launches(cfg)

    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches != expect:
        fail(f"23: trainer launch counts {launches} != expected {expect}")
    losses, want = epochs[0]["losses"], first["losses"]
    if len(losses) != steps or losses != want:
        fail(f"23: losses {losses} with the clips in memory != phase 9's "
             f"{want}")
    with open(os.path.join(trainer.work_dir, "eval_results",
                           "best_acc.pkl"), "rb") as f:
        scores = pickle.load(f)
    if scores.keys() != replay["scores"].keys() or any(
            not np.array_equal(v, replay["scores"][k])
            for k, v in scores.items()):
        fail("23: the best scores with the clips in memory are not phase "
             "9's")
    print(f"[memory] 23: Trainer.start() on {TRAIN_CONFIG} (bf16, batch "
          f"{cfg.batch_size}, T={T_WINDOW}) on phase 9's clips with "
          f"use_mmap: false: {steps} steps + {eval_forwards} eval batches "
          f"in {wall:.1f} s, best acc {best:.4f}, the {steps} losses and "
          f"the {len(scores)} best scores bit-equal to phase 9's; "
          f"launches {launches}; epoch "
          f"{epochs[0]['clips_per_sec']:.1f} clips/s with the feeder "
          f"{100 * epochs[0]['dataloader_share']:.2f}% of it, phase 9 "
          f"(memory-mapped) {first['clips_per_sec']:.1f} clips/s and "
          f"{100 * first['dataloader_share']:.2f}% | {card}")
    del trainer
    torch.cuda.empty_cache()
    return epochs[0]


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
    from shift_gcn_torch.ops.lowering import Lowering
    from shift_gcn_torch.train import fourstream
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils import device_guard

    cfg, feeder_args = training_config(FOURSTREAM_CONFIG, rng, workdir,
                                       "--native_loader", "true")
    full = ModelConfig(num_class=2, num_point=V, num_person=1,
                       graph="mediapipe_pose", activation_dtype="bfloat16",
                       lowering=Lowering())
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


# ---------------------------------------------------------------------------
# Lowering knobs (phase 15)
# ---------------------------------------------------------------------------


def shift_arrays(config, rng, xpos_bound=None, ypos_bound=None):
    """``random_arrays`` with every xpos drawn from U(-xpos_bound,
    xpos_bound) and every ypos from U(-ypos_bound, ypos_bound) where
    given, as a state_dict."""
    from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

    params, state = random_arrays(config, rng)
    for block in params.values():
        for shift in (block["tcn1"]["shift_in"], block["tcn1"]["shift_out"]
                      ) if "tcn1" in block else ():
            c = shift["ypos"].shape[0]
            if xpos_bound is not None:
                shift["xpos"] = rng.uniform(-xpos_bound, xpos_bound, c
                                            ).astype(np.float32)
            if ypos_bound is not None:
                shift["ypos"] = rng.uniform(-ypos_bound, ypos_bound, c
                                            ).astype(np.float32)
    return state_dict_from_arrays(params, state)


def check_knob_forward(model, x, label: str, tol: float) -> float:
    """One eval forward on the kernel path (20 K1 / 10 K4 launches) against
    the plain path on the same model and batch: logits within ``tol`` of
    their scale.  Returns the gap as a share of the scale."""
    from shift_gcn_torch import kernels

    model.eval()
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expect = {k: PER_EVAL_FORWARD.get(k, 0) for k in kernels.KERNELS}
    if launches != expect:
        fail(f"{label} forward: launch counts {launches} != {expect}")
    with torch.no_grad(), plain_path():
        want = model(x)
    err, scale = max_err(got, want)
    if not (torch.isfinite(got).all() and err <= tol * scale):
        fail(f"{label} forward: logits off the plain path by {err:.3g} > "
             f"{tol:g} of scale {scale:.3g}")
    return err / scale


def check_step_envelope(model, optimizer, step, batch, label: str):
    """One train step on the kernel path (the per-step launch counts) and
    one on the plain path from the same weights and optimizer state, held
    to the bf16 envelope of tests/test_torch_train.py::
    test_bf16_step_within_envelope: loss within 1e-2 relative, the
    concatenated true gradient at cosine >= 0.98 and within 0.25 relative
    L2, ypos steps equal on >= 90% of channels, xpos's zero.  Returns
    (loss gap, cosine, relative L2, ypos share equal)."""
    from shift_gcn_torch import kernels

    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt_start = copy.deepcopy(optimizer.state_dict())

    def run():
        model.load_state_dict(start)
        optimizer.load_state_dict(copy.deepcopy(opt_start))
        loss, _ = step(batch)
        torch.cuda.synchronize()
        return float(loss), {n: p.grad.detach().float().clone()
                             for n, p in model.named_parameters()}

    kernels.reset_launches()
    loss, grads = run()
    launches = dict(kernels.LAUNCHES)
    if launches != PER_STEP:
        fail(f"{label} step: launch counts {launches} != {PER_STEP}")
    with plain_path():
        loss_p, grads_p = run()
    names = [n for n in grads if not n.endswith(("xpos", "ypos"))]
    got = torch.cat([grads[n].reshape(-1) for n in names])
    want = torch.cat([grads_p[n].reshape(-1) for n in names])
    cos = float(got @ want / (got.norm() * want.norm()))
    rel = float((got - want).norm() / want.norm())
    ypos = [n for n in grads if n.endswith("ypos")]
    agree = sum(int((grads[n] == grads_p[n]).sum()) for n in ypos) / sum(
        grads[n].numel() for n in ypos)
    loss_gap = abs(loss - loss_p) / abs(loss_p)
    if any(bool(grads[n].any()) for n in grads if n.endswith("xpos")):
        fail(f"{label} step: nonzero xpos gradient")
    if not (loss_gap <= 1e-2 and cos >= 0.98 and rel <= 0.25
            and agree >= 0.9):
        fail(f"{label} step outside the bf16 envelope: loss {loss_gap:.3g}, "
             f"cosine {cos:.6f}, relative L2 {rel:.3g}, ypos equal "
             f"{agree:.3f}")
    model.load_state_dict(start)
    optimizer.load_state_dict(opt_start)
    return loss_gap, cos, rel, agree


def run_lowering_knobs(config, rng, dev, workdir: str, seed: int,
                       card: str):
    """Phase 15: the lowering knobs that change numerics on the full-width
    MediaPipe model at 64 clips x T=300, the kernels against the plain
    path on the same weights and batch."""
    import dataclasses

    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.ops.batchnorm import BatchNorm
    from shift_gcn_torch.ops.lowering import Lowering, as_dict
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step
    from shift_gcn_torch.train.trainer import Trainer

    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    x = torch.from_numpy(data).to(dev)
    batch = {"data": x, "label": torch.from_numpy(labels).to(dev)}
    out = {}

    # exact_xpos, fp32: xpos U(-0.9, 0.9)
    cfg_x = dataclasses.replace(config, lowering=Lowering(exact_xpos=True))
    model = Model(cfg_x)
    model.load_state_dict(shift_arrays(cfg_x, rng, xpos_bound=0.9))
    out["xpos_fwd"] = check_knob_forward(model, x, "exact_xpos fp32", 1e-4)

    def wide_xpos(m):
        for name, p in m.named_parameters():
            if name.endswith("xpos"):
                p.copy_((torch.rand(p.shape, generator=torch.Generator()
                                    .manual_seed(seed)) * 1.8 - 0.9))

    out["xpos_step"] = check_train_step(cfg_x, rng, dev, seed,
                                        prepare=wide_xpos,
                                        label="exact_xpos fp32")[0]
    del model

    # max_shift 16, ypos U(-15, 15): fp32 and bf16
    cfg_m = dataclasses.replace(config, lowering=Lowering(max_shift=16),
                                shift_init_scale=15.0)
    weights = shift_arrays(cfg_m, rng, ypos_bound=15.0)
    model = Model(cfg_m)
    model.load_state_dict(weights)
    out["far_fwd"] = check_knob_forward(model, x, "max_shift 16 fp32", 1e-4)
    model16 = Model(dataclasses.replace(cfg_m, activation_dtype="bfloat16"))
    model16.load_state_dict(weights)
    out["far_fwd16"] = check_knob_forward(model16, x, "max_shift 16 bf16",
                                          3e-2)
    out["far_step"] = check_train_step(cfg_m, rng, dev, seed,
                                       label="max_shift 16 fp32")[0]
    model16.init_weights(torch.Generator().manual_seed(seed))
    opt = build_optimizer(model16, 0.1)
    out["far_step16"] = check_step_envelope(
        model16, opt, lambda b: train_step(model16, opt, b, 0.1), batch,
        "max_shift 16 bf16")
    # a state dict with |ypos| = 12 (the others U(-1, 1)) loads under 16
    # and is refused under 8
    at12 = shift_arrays(config, rng)
    at12["l5.tcn1.shift_out.ypos"][:2] = torch.tensor([12.0, -12.0])
    model.load_state_dict(at12)
    try:
        Model(config).load_state_dict(at12)
        fail("a state dict with |ypos| = 12 loaded under max_shift 8")
    except ValueError as err:
        if "max_shift=8" not in str(err):
            raise
    del model, model16, opt

    # the Trainer's bf16 config with bn_lp, with bn_lp_eval off, and with
    # fp32 activations and compute_dtype bfloat16: one step each, and an
    # eval forward
    feeder_args = {split: write_split(workdir, split,
                                      *synthetic_batch(rng, n, T_WINDOW))
                   for split, n in (("train", N_WINDOWS),
                                    ("val", N_WINDOWS))}
    cases = (("bn_lp", ("--lowering", "{bn_lp: true}")),
             ("bn_lp_eval off", ("--lowering", "{bn_lp_eval: false}")),
             ("fp32 + compute_dtype bf16",
              ("--activation_dtype", "float32", "--compute_dtype",
               "bfloat16")))
    for i, (label, extra) in enumerate(cases):
        cfg = one_epoch_config(TRAIN_CONFIG, os.path.join(workdir, str(i)),
                               feeder_args, *extra)
        trainer = Trainer(cfg)
        model = trainer.model
        low = trainer.model_config.lowering
        fp32_act = cfg.activation_dtype == "float32"
        wired = (low.bn_lp == (label == "bn_lp")
                 and low.bn_lp_eval == (label != "bn_lp_eval off")
                 and cfg.lowering == as_dict(low)
                 and (trainer.model_config.dtype == torch.bfloat16)
                 == fp32_act
                 and all((m.lp_train, m.lp_eval) == (low.bn_lp,
                                                     low.bn_lp_eval)
                         for m in model.modules()
                         if isinstance(m, BatchNorm)))
        if not wired:
            fail(f"{label}: the Trainer did not wire {extra}")
        tbatch = trainer._put_batch(data, labels)
        envelope = check_step_envelope(
            model, trainer.optimizer,
            lambda b: trainer._train_step(b, cfg.base_lr), tbatch, label)
        fwd = check_knob_forward(model, tbatch["data"], label,
                                 1e-4 if fp32_act else 3e-2)
        out[label] = envelope + (fwd,)
        del trainer, model
    torch.cuda.empty_cache()
    print(f"[knobs] exact_xpos (xpos U(-0.9, 0.9)) fp32: forward "
          f"{out['xpos_fwd']:.3g} of scale off the plain path (tol 1e-4), "
          f"step gradients {out['xpos_step']:.3g} of scale off the plain "
          f"backward (tol {STEP_GRAD_TOL:g}); max_shift 16 (ypos U(-15, 15)):"
          f" forward fp32 {out['far_fwd']:.3g} (tol 1e-4), bf16 "
          f"{out['far_fwd16']:.3g} (tol 3e-2), step fp32 "
          f"{out['far_step']:.3g} (tol {STEP_GRAD_TOL:g}), bf16 step vs "
          "plain (loss gap, cosine, rel L2, ypos equal) "
          f"{tuple(sig(v) for v in out['far_step16'])}; |ypos| 12 loads "
          "under 16, refused under 8; 20 K1 / 10 K4 launches a forward | "
          f"{card}")
    for label, _ in cases:
        loss_gap, cos, rel, agree, fwd = out[label]
        print(f"[knobs] Trainer step, {TRAIN_CONFIG} with {label}: vs the "
              f"plain path loss {loss_gap:.3g}, gradient cosine {cos:.7f}, "
              f"rel L2 {rel:.3g}, ypos equal {agree:.3f} (envelope 1e-2, "
              f"0.98, 0.25, 0.9); eval forward {fwd:.3g} of scale | {card}")
    return out


# ---------------------------------------------------------------------------
# NTU-60 (phase 16)
# ---------------------------------------------------------------------------


def ntu_clips(rng, n: int, t: int, v: int, m: int, classes: int):
    """(N, 3, T, V, M) clips whose class moves the mean of channel 0, and
    labels."""
    labels = rng.integers(0, classes, n)
    data = rng.standard_normal((n, 3, t, v, m)).astype(np.float32) * 0.1
    data[:, 0] += (labels / classes * 0.6)[:, None, None, None].astype(
        np.float32)
    return data, labels


def check_kernels_at(config, n: int, gen, rng, dev, label: str,
                     shapes=None, dtypes=(torch.float32,)):
    """K1 bit-equal, K4 and K5 within 2e-5 of scale (2^-7 in bf16), the
    fused K2+K3 and K6 within phase 7's gates, in each of ``dtypes``, at
    every launch shape of one train step of ``config`` with ``n``
    skeleton rows a batch, or at ``shapes`` (K1's (T, C, stride), K4's
    (T, C, D)).  Returns the number of shapes checked."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts

    v = config.num_point
    k1_shapes, k4_shapes = shapes or forward_shapes(config, T_WINDOW)
    for dtype in dtypes:
        name = f"{label} {str(dtype)[6:]}"
        for t, c, stride in sorted(set(k1_shapes)):
            x = torch.randn(n, t, v, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(n, t // stride, v, c, generator=gen,
                            device=dev).to(dtype)
            ypos = torch.from_numpy(shift_positions(rng, c, "U(-1, 1)")).to(
                dev)
            got = ts.temporal_shift(x, ypos, stride)
            want = ts.temporal_shift_reference(x, ypos, stride)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} K1 T={t} C={c} s={stride}: not bit-equal "
                     f"(max|err| {max_err(got, want)[0]:.3g})")
            check_fused_backward(x, g, ypos, stride,
                                 f"{name} T={t} C={c} s={stride}")
            del x, g, got, want
        # as phases 4 and 7: another summation order; bf16 may round to a
        # neighbour
        tol = 2e-5 if dtype == torch.float32 else 2 ** -7
        for t, c, d in sorted(set(k4_shapes)):
            r = n * t
            x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(r, v, d, generator=gen, device=dev).to(dtype)
            gate = torch.tanh(torch.randn(v, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            b = torch.randn(d, generator=gen, device=dev) * 0.1
            for kernel, got, want in (
                    ("K4", sk.fused_shift_gcn(x, gate, w, b),
                     ss.shift_gcn_transform(x, gate, w, b)),
                    ("K5", sk.shift_gcn_dx(g, gate, w),
                     ss.shift_gcn_dx_reference(g, gate, w))):
                err, scale = max_err(got, want)
                if not err <= tol * scale:
                    fail(f"{name} {kernel} T={t} C={c} D={d}: max|err| "
                         f"{err:.3g} > {tol * scale:.3g}")
            check_wgrad(x, g, gate, w, f"{name} T={t} C={c} D={d}")
            del x, g
        torch.cuda.empty_cache()
    return len(set(k1_shapes)) + len(set(k4_shapes))


def step_cost(model, batch, lr: float, dev, label: str, card: str):
    """(train step ms, eval forward ms, the step's peak memory in GiB, the
    profiled step's device busy share) of ``model`` on ``batch``, by CUDA
    events and one profiled step; the weights are restored."""
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step

    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    train_step(model, opt, batch, lr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_ms = time_ms(lambda: train_step(model, opt, batch, lr), iters=2,
                      reps=3)
    busy = profile_call(lambda: train_step(model, opt, batch, lr), label,
                        card, top=12)
    model.eval()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(batch["data"]), iters=3, reps=3)
    model.load_state_dict(start)
    del opt
    return step_ms, fwd_ms, peak, busy


def run_ntu(rng, gen, dev, workdir: str, card: str):
    """Phase 16: ``Trainer.start()`` on NTU60_CONFIG (60 classes, V=25,
    M=2, batch 64, T=300, fp32) for one epoch of NTU_STEPS steps on
    synthetic clips, with eval and save; the kernels at every launch shape
    of the model; the step and forward times and the step's peak memory.
    Returns (launches, step ms, forward ms, peak GiB, batch)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import (
        Model, config_from_reference_args)
    from shift_gcn_torch.train.config import load_config
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils.checkpoint import latest_checkpoint

    base = load_config(["--config", NTU60_CONFIG])
    config = config_from_reference_args(base.model_args)
    if not ((config.num_class, config.num_point, config.num_person,
             config.graph, base.batch_size) == (60, 25, 2, "ntu_rgb_d", 64)
            and base.activation_dtype is None):
        fail(f"{NTU60_CONFIG} no longer trains NTU-60 (60 classes, V=25, "
             "M=2) at batch 64 in fp32")
    v, m = config.num_point, config.num_person
    # the largest batch that fits, from the config's 64 down
    batch_size = base.batch_size
    while True:
        model = Model(config).init_weights(torch.Generator().manual_seed(0))
        data, labels = ntu_clips(rng, batch_size, T_WINDOW, v, m, 60)
        batch = {"data": torch.from_numpy(data).to(dev),
                 "label": torch.from_numpy(labels).to(dev)}
        try:
            cost = step_cost(model, batch, base.base_lr, dev,
                             f"one NTU-60 fp32 train step, batch {batch_size}",
                             card)
        except torch.cuda.OutOfMemoryError:
            cost = None
        if cost is not None:
            step_ms, fwd_ms, peak, busy = cost
            break
        # the exception and its frames are gone here, so is their memory
        del model, batch
        torch.cuda.empty_cache()
        print(f"[ntu] batch {batch_size} does not fit in the card's "
              f"memory | {card}")
        if batch_size == 1:
            fail("NTU-60 does not train at batch 1")
        batch_size //= 2
    del model, batch
    torch.cuda.empty_cache()

    feeder_args = {
        split: write_split(workdir, split, *ntu_clips(
            rng, n, T_WINDOW, v, m, 60))
        for split, n in (("train", NTU_STEPS * batch_size),
                         ("val", batch_size))}
    cfg = one_epoch_config(NTU60_CONFIG, workdir, feeder_args,
                           "--batch_size", str(batch_size),
                           "--test_batch_size", str(batch_size))
    trainer = Trainer(cfg)
    epochs = record_epochs(trainer)
    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    expect = {k: PER_STEP[k] * NTU_STEPS + PER_EVAL_FORWARD.get(k, 0)
              for k in PER_STEP}
    if launches != expect:
        fail(f"NTU-60 launch counts {launches} != expected {expect}")
    losses = epochs[0]["losses"]
    if len(losses) != NTU_STEPS or not np.isfinite(losses).all():
        fail(f"NTU-60 train losses {losses}")
    eval_dir = os.path.join(trainer.work_dir, "eval_results")
    ckpt = latest_checkpoint(trainer.save_dir)
    if ckpt is None or not os.path.exists(os.path.join(eval_dir,
                                                       "best_acc.pkl")):
        fail("the NTU-60 run left no checkpoint or best_acc.pkl")
    with open(os.path.join(eval_dir, "best_acc.pkl"), "rb") as f:
        scores = pickle.load(f)
    if len(scores) != batch_size or any(
            s.shape != (60,) or not np.isfinite(s).all()
            for s in scores.values()):
        fail("NTU-60 scores are not finite 60-class rows per clip")
    del trainer
    torch.cuda.empty_cache()
    shapes = check_kernels_at(config, batch_size * m, gen, rng, dev,
                              "NTU-60")
    print(f"[ntu] Trainer.start() on {NTU60_CONFIG} (60 classes, V={v}, "
          f"M={m}, fp32, batch {batch_size}"
          f"{'' if batch_size == base.batch_size else ' (64 does not fit)'},"
          f" T={T_WINDOW}): {NTU_STEPS} steps + 1 eval batch in {wall:.1f} s,"
          f" losses {[round(x, 4) for x in losses]}, best acc {best:.4f}, "
          f"checkpoint {os.path.basename(ckpt)}; launches {launches} = per "
          f"step {PER_STEP} x {NTU_STEPS} + per eval forward "
          f"{PER_EVAL_FORWARD}; K1 bit-equal, K4/K5 within 2e-5, K2+K3 and "
          f"K6 within phase 7's gates at {shapes} launch shapes of "
          f"{batch_size * m} skeleton rows; step {step_ms:.3f} ms "
          f"({batch_size / step_ms * 1e3:.1f} clips/s), eval forward "
          f"{fwd_ms:.3f} ms, step peak memory {peak:.2f} GiB, device busy "
          f"{'n/a' if busy is None else f'{100 * busy:.1f}%'} of the "
          f"profiled step | {card}")
    return launches, step_ms, fwd_ms, peak, batch_size


# ---------------------------------------------------------------------------
# The other families (phase 17)
# ---------------------------------------------------------------------------


def config_without_mesh(config_path: str, workdir: str) -> str:
    """A copy of the YAML at ``config_path`` without MESH_KEYS (the
    parallel modes), written under ``workdir``; returns its path."""
    import yaml

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    for key in MESH_KEYS:
        cfg.pop(key, None)
    path = os.path.join(workdir, os.path.basename(config_path))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def card_vs_cpu(model, build, x, label: str, zero_grad_biases=()) -> dict:
    """``model``'s weights on the card, on the CPU, and on the CPU in
    float64, one forward and backward each on the same clips ``x``, with
    the BNs on their running statistics (eval) and on batch statistics
    (train).  The labels run through the classes in turn, so that the
    loss is not saturated (a batch of one class at large logits has a
    loss of 0 in fp32 and gradients below its resolution):

    - logits on the card within 1e-4 of their scale of the CPU's, in
      both modes;
    - gradients: each true gradient's relative L2 gap to the float64
      run, ||g - g64|| / ||g64||, on the card no more than GRAD_RATIO
      times the CPU fp32 run's gap for the same parameter plus
      GRAD_FLOOR: the card's fp32 arithmetic as accurate as the CPU's.
      Summed in fp32, some of ST-GCN's gradients are only so accurate:
      the adjacency B's, those behind a batch-statistics BN, and theta /
      phi behind a saturated attention softmax sum terms that cancel, so
      that the CPU's own fp32 run can be far from float64 (0.61 of the
      norm for one phi under batch statistics, at the full width on 8
      clips), and a fixed bound between card and CPU would hold roundoff
      to a limit that neither side meets.  The largest gaps are printed
      with their parameters;
    - a bias in ``zero_grad_biases`` ((suffix, weight): under batch
      statistics its exact gradient is 0, each side gives roundoff)
      within 5e-4 of its weight gradient's scale, as
      tests/test_torch_stgcn.py holds it.

    Returns {mode: (logits gap, (card gradients' largest gap to float64,
    its parameter), the CPU's, zero-gradient biases)}.  ``index_add_`` (ring-GNN) adds
    in no fixed order on the card: roundoff only."""
    from shift_gcn_torch.train.state import cross_entropy

    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    cpu = torch.device("cpu")
    labels = np.arange(len(x)) % model.config.num_class

    def run(device, dtype, train: bool):
        copy_ = build(model.config, device=cpu)
        copy_.load_state_dict(state, strict=True)
        copy_ = copy_.to(device=device, dtype=dtype).train(train)
        logits = copy_(torch.from_numpy(x).to(device=device, dtype=dtype))
        cross_entropy(logits, torch.from_numpy(labels).to(device)
                      ).backward()
        return logits.detach().cpu().double(), {
            n: p.grad.detach().cpu().double()
            for n, p in copy_.named_parameters()}

    def weight_of(name):
        return next((name[:-len(b)] + w for b, w in zero_grad_biases
                     if name.endswith(b)), None)

    out = {}
    for train in (False, True):
        mode = "train" if train else "eval"
        (card_logits, card), (cpu_logits, cpu32), (_, ref) = (
            run(device, dtype, train) for device, dtype in (
                (model.fc.weight.device, torch.float32),
                (cpu, torch.float32), (cpu, torch.float64)))
        err, _ = max_err(card_logits, cpu_logits)
        scale = float(cpu_logits.abs().max())
        if not err <= 1e-4 * scale:
            fail(f"{label}: {mode}-mode logits on the card off the CPU's by "
                 f"{err:.3g} > 1e-4 of {scale:.3g}")
        true = [n for n in ref if not (train and weight_of(n))]

        def off(g, n):
            return float((g[n] - ref[n]).norm()) / max(float(ref[n].norm()),
                                                       1e-30)

        for name in true:
            if not off(card, name) <= (GRAD_RATIO * off(cpu32, name)
                                       + GRAD_FLOOR):
                fail(f"{label}: {mode}-mode gradient {name} off float64 by "
                     f"{off(card, name):.3g} on the card, more than "
                     f"{GRAD_RATIO}x the CPU's {off(cpu32, name):.3g} + "
                     f"{GRAD_FLOOR:g}")
        gaps = [max((off(g, n), n) for n in true) for g in (card, cpu32)]
        bias_gap = 0.0
        for name in ref:
            weight = weight_of(name) if train else None
            if weight is None:
                continue
            wscale = float(ref[weight].abs().max())
            worst = max(float(card[name].abs().max()),
                        float(cpu32[name].abs().max())) / wscale
            if not worst <= 5e-4:
                fail(f"{label}: zero-gradient bias {name} at {worst:.3g} of "
                     "its weight gradient's scale > 5e-4")
            bias_gap = max(bias_gap, worst)
        out[mode] = (err / scale, gaps[0], gaps[1], bias_gap)
    return out


def gap_text(gaps) -> str:
    return "; ".join(
        f"{mode}: logits {g[0]:.3g} of scale off the CPU's (tol 1e-4), "
        f"gradients' relative L2 off float64 at most {g[1][0]:.3g} card "
        f"({g[1][1]}), {g[2][0]:.3g} CPU ({g[2][1]}) (tol {GRAD_RATIO}x "
        f"the CPU's + {GRAD_FLOOR:g} a parameter)" + (
            f", zero-gradient biases {g[3]:.3g} of their weight's (tol "
            "5e-4)" if mode == "train" else "")
        for mode, g in gaps.items())


def train_family(config_path: str, data, labels, val, workdir: str,
                 batch_size: int, *extra: str):
    """``Trainer.start()`` on ``config_path`` without its mesh keys for one
    epoch on (data, labels), eval on ``val``, with save; every port kernel
    launched no time.  Returns the trainer, its epoch statistics, the wall
    time and the best accuracy."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils.checkpoint import latest_checkpoint

    feeder_args = {"train": write_split(workdir, "train", data, labels),
                   "val": write_split(workdir, "val", *val)}
    cfg = one_epoch_config(config_without_mesh(config_path, workdir),
                           workdir, feeder_args, "--batch_size",
                           str(batch_size), "--test_batch_size",
                           str(batch_size), *extra)
    trainer = Trainer(cfg)
    epochs = record_epochs(trainer)
    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(kernels.LAUNCHES[k] for k in kernels.LAUNCHES
           if k not in BN_KERNELS):
        fail(f"{config_path}: the family launched the port's Shift-GCN "
             f"kernels {kernels.LAUNCHES}")
    losses = epochs[0]["losses"]
    if (len(losses) != len(labels) // batch_size
            or not np.isfinite(losses).all()):
        fail(f"{config_path}: train losses {losses}")
    if latest_checkpoint(trainer.save_dir) is None or not os.path.exists(
            os.path.join(trainer.work_dir, "eval_results", "best_acc.pkl")):
        fail(f"{config_path}: no checkpoint or best_acc.pkl")
    return trainer, epochs[0], wall, best


def run_families(rng, dev, workdir: str, card: str):
    """Phase 17: ST-GCN (STGCN_CONFIG's model_args: MediaPipe, adaptive B,
    channels 64..256, temporal kernel 9) and ring-GNN (RING_CONFIG's:
    V=256, C=8, hidden 32/32) trained through ``Trainer.start()`` without
    their mesh keys, each family's seeded init against the same module on
    the CPU; ST-GCN also with adaptive_embed 16.  Returns {label: step
    ms}."""
    import dataclasses

    from shift_gcn_torch.models import ring_gnn, stgcn
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step

    times = {}
    zero_grad = STGCN_ZERO_GRAD
    # ST-GCN: 4 steps of 64 clips x T=300, eval on 64
    os.makedirs(os.path.join(workdir, "stgcn"))
    trainer, epoch, wall, best = train_family(
        STGCN_CONFIG, *synthetic_batch(rng, FAMILY_STEPS * N_WINDOWS,
                                       T_WINDOW),
        synthetic_batch(rng, N_WINDOWS, T_WINDOW),
        os.path.join(workdir, "stgcn"), N_WINDOWS)
    want = stgcn.STGCNConfig(num_class=2, num_point=V, num_person=1,
                             graph="mediapipe_pose")
    if not (isinstance(trainer.model, stgcn.Model)
            and trainer.model_config == want):
        fail(f"{STGCN_CONFIG} no longer builds the full-width ST-GCN "
             f"{want}: {trainer.model_config}")
    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    model = trainer.model
    opt = build_optimizer(model, 0.1)
    times["stgcn"] = time_ms(lambda: train_step(model, opt, batch, 0.1),
                             iters=2, reps=3)
    profile_call(lambda: train_step(model, opt, batch, 0.1),
                 f"one ST-GCN train step, batch {N_WINDOWS}", card, top=12)
    # against the CPU from the seeded init (4 steps on the separable
    # synthetic clips saturate the trained model: its gradients are ~1e-12),
    # on 8 of the clips (the full batch would take minutes on the host)
    gaps = card_vs_cpu(stgcn.Model(want).init_weights(
        torch.Generator().manual_seed(0)), stgcn.Model, data[:8], "ST-GCN",
        zero_grad)
    print(f"[families] ST-GCN, Trainer.start() on {STGCN_CONFIG} without "
          f"{list(MESH_KEYS)} (V={V}, M=1, channels {want.channels}, "
          f"temporal kernel {want.temporal_kernel}, adaptive B, batch "
          f"{N_WINDOWS}, T={T_WINDOW}): {FAMILY_STEPS} steps + 1 eval batch "
          f"in {wall:.1f} s, losses {[round(v, 4) for v in epoch['losses']]},"
          f" best acc {best:.4f}; no port kernel launched; card vs CPU "
          f"(seeded init) on 8 clips: {gap_text(gaps)}; step "
          f"{times['stgcn']:.3f} ms "
          f"({N_WINDOWS / times['stgcn'] * 1e3:.1f} clips/s) | {card}")
    del trainer, model, opt

    embed_cfg = dataclasses.replace(want, adaptive_embed=16)
    model = stgcn.Model(embed_cfg).init_weights(
        torch.Generator().manual_seed(1))
    opt = build_optimizer(model, 0.1)
    loss, _ = train_step(model, opt, batch, 0.1)
    if not np.isfinite(float(loss)):
        fail(f"ST-GCN adaptive_embed 16: loss {float(loss)}")
    times["stgcn_embed16"] = time_ms(
        lambda: train_step(model, opt, batch, 0.1), iters=2, reps=3)
    # from the seeded init too: the timed steps leave weights that the
    # card's unordered sums make differ from run to run
    gaps = card_vs_cpu(stgcn.Model(embed_cfg).init_weights(
        torch.Generator().manual_seed(1)), stgcn.Model, data[:8],
        "ST-GCN adaptive_embed 16", zero_grad)
    print(f"[families] ST-GCN adaptive_embed 16: step "
          f"{times['stgcn_embed16']:.3f} ms at batch {N_WINDOWS}; card vs "
          f"CPU (seeded init) on 8 clips: {gap_text(gaps)} | {card}")
    del model, opt, batch
    torch.cuda.empty_cache()

    # ring-GNN: node-feature clips (N, 8, 1, 256, 1), its YAML's batch
    ring_cfg = ring_gnn.RingGNNConfig()

    def ring_clips(n):
        labels = rng.integers(0, 2, n)
        data = rng.standard_normal((n, ring_cfg.in_channels, 1,
                                    ring_cfg.num_nodes, 1)).astype(
            np.float32)
        data[:, 0] += (labels * 1.5 - 0.75)[:, None, None, None]
        return data, labels

    os.makedirs(os.path.join(workdir, "ring"))
    trainer, epoch, wall, best = train_family(
        RING_CONFIG, *ring_clips(FAMILY_STEPS * RING_BATCH),
        ring_clips(RING_BATCH), os.path.join(workdir, "ring"), RING_BATCH)
    if not (isinstance(trainer.model, ring_gnn.Model)
            and trainer.model_config == ring_cfg):
        fail(f"{RING_CONFIG} no longer builds {ring_cfg}: "
             f"{trainer.model_config}")
    data, labels = ring_clips(RING_BATCH)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    model = trainer.model
    opt = build_optimizer(model, 0.05)
    times["ring_gnn"] = time_ms(lambda: train_step(model, opt, batch, 0.05),
                                iters=10, reps=5)
    profile_call(lambda: train_step(model, opt, batch, 0.05),
                 f"one ring-GNN train step, batch {RING_BATCH}", card, top=8)
    # index_add_ on the card adds with atomics in no fixed order: fp32
    # roundoff apart from the CPU's sum, within 1e-4; from the seeded init
    gaps = card_vs_cpu(ring_gnn.Model(ring_cfg).init_weights(
        torch.Generator().manual_seed(0)), ring_gnn.Model, data, "ring-GNN")
    print(f"[families] ring-GNN, Trainer.start() on {RING_CONFIG} without "
          f"{list(MESH_KEYS)} (V={ring_cfg.num_nodes}, C="
          f"{ring_cfg.in_channels}, hidden {ring_cfg.hidden}, batch "
          f"{RING_BATCH}): {FAMILY_STEPS} steps + 1 eval batch in "
          f"{wall:.1f} s, losses {[round(v, 4) for v in epoch['losses']]}, "
          f"best acc {best:.4f}; no port kernel launched; card vs CPU "
          f"(seeded init, index_add_ in no fixed order on the card): "
          f"{gap_text(gaps)}; step {times['ring_gnn']:.4f} ms | {card}")
    del trainer, model, opt
    torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# Data and sequence parallelism (phase 18)
# ---------------------------------------------------------------------------

SEQPAR_CONFIG = "configs/mediapipe/train_seqpar.yaml"
# phase 18c's one cut: the config's mesh [4, 2] needs 8 ranks; [2, 2] keeps
# both axes with 4 gloo ranks sharing this card
SEQPAR_MESH = (2, 2)
T_PAD = 304          # SEQPAR_CONFIG's pad_to_frames
PARALLEL_STEPS = 2   # Trainer steps of phases 18a and 18c
PARALLEL_LR = 0.1
# A true gradient of a rank's fp32 step (every parameter's, the input's
# frame by frame, each shift's raw position gradient) may differ from the
# one-process step by this share of its scale; stated for the parameters
# before the first run on the card, and kept for the other two.  The
# ranks sum BN's statistics and the gradients in another fp32 order,
# which flips ReLUs whose inputs lie within roundoff of 0; phase 8 prints
# the gap such an order change makes (up to ~6e-3 of scale).  On the card
# the sound steps read up to 1.04e-2 and the faults planted in 18c
# (PLANTED_FAULTS), which must read above it, 7.6e-2 at the least.
PARALLEL_GRAD_TOL = 3e-2
# 18c reruns its fp32 step with one cross-rank backward rule broken on
# every rank (``planted``): the gates above must catch each
PLANTED_FAULTS = ("reverse_halo", "bn_backward")
RANK_LINE = "[rank]"


def parallel_settings(dev, seed: int) -> dict:
    """What a rank process of phase 18 is told: this module's sizes."""
    return {"device": str(dev), "seed": seed, "batch": N_WINDOWS,
            "t": T_WINDOW, "t_pad": T_PAD, "steps": PARALLEL_STEPS,
            "mesh": list(SEQPAR_MESH), "faults": list(PLANTED_FAULTS)}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parse_rank_lines(text: str, world: int):
    """The ranks' one-line JSON summaries (``[rank] {...}``) in rank
    order; fails unless every rank printed one."""
    found = {}
    for line in text.splitlines():
        if line.startswith(RANK_LINE + " "):
            item = json.loads(line[len(RANK_LINE) + 1:])
            found[int(item["rank"])] = item
    if sorted(found) != list(range(world)):
        fail(f"rank lines from ranks {sorted(found)}, expected {world}")
    return [found[r] for r in sorted(found)]


def run_ranks(job: str, world: int, workdir: str, settings: dict,
              timeout: float = 900):
    """Run ``job`` in ``world`` rank processes of this script (gloo, the
    group made by each rank; the card shared).  A rank that fails or
    outlives ``timeout`` fails the phase after every rank is stopped.
    Returns the ranks' summary lines and pickled results, in rank order."""
    port = free_port()
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{job}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-job", job,
             "--rank", str(rank), "--world", str(world), "--port",
             str(port), "--workdir", workdir, "--settings",
             json.dumps(settings)], stdout=log, stderr=subprocess.STDOUT),
            log))
    deadline = time.time() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _ in procs):
            for rank, (proc, _) in enumerate(procs):
                if proc.poll() not in (None, 0):
                    failed = f"rank {rank} exited with {proc.returncode}"
            if time.time() > deadline:
                failed = f"the ranks outlived {timeout:.0f} s"
            time.sleep(0.2)
        if failed is None:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
            failed = f"ranks {bad} failed" if bad else None
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    logs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"{job}_rank{rank}.log")) as f:
            logs.append(f.read())
    if failed:
        fail(f"phase 18 {job}: {failed}\n" + "\n".join(
            f"--- rank {r}:\n" + "\n".join(text.splitlines()[-15:])
            for r, text in enumerate(logs)))
    results = []
    for rank in range(world):
        with open(os.path.join(workdir, f"{job}_{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return parse_rank_lines("\n".join(logs), world), results


def elapsed_ms(fn, dev, reps: int = 2) -> float:
    """Mean ms of ``reps`` calls after one warm-up: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextmanager
def planted(fault: str):
    """One cross-rank backward rule broken in this rank process, every
    rank planting the same so that the collectives still pair:
    "reverse_halo" drops the reverse halo exchange (each rank keeps its
    own rows of the extended block's grad_input), "bn_backward" leaves
    sync BN's statistics cotangents unaveraged over the ranks (the train
    BN backward's mean(dy) and mean(dy * xhat) kept each rank's own)."""
    from shift_gcn_torch.ops import batchnorm
    from shift_gcn_torch.parallel import halo

    backward = batchnorm.batch_norm_train_backward

    def unaveraged(*args, group=None, **kwargs):
        return backward(*args, group=None, **kwargs)

    patch = {
        "reverse_halo": lambda: mock.patch.object(
            halo, "halo_return",
            lambda dx, lo, hi, mesh: dx[:, lo:dx.shape[1] - hi].clone()),
        "bn_backward": lambda: mock.patch.object(
            batchnorm, "batch_norm_train_backward", unaveraged),
    }[fault]()
    with patch:
        yield


def parallel_step(settings: dict, t: int, mesh=None, shard_time=False,
                  timed: bool = True, remat: bool = False):
    """One fp32 step of the full-width MediaPipe model from the seeded init
    on the seeded batch of ``settings["batch"]`` clips, padded with empty
    frames to ``t``: on this rank's part under ``mesh``, else whole; each
    unit recomputed in the backward with ``remat``.
    Returns the loss; the gradients: the parameters' (a tensor-parallel
    rank's slices gathered over the model ranks), the input's ("input",
    this rank's rows and frames; under tensor parallelism the model
    ranks' parts summed) and each shift's raw position gradient as its
    constraint step took it ("gy_raw:<ypos name>", reduced over the
    ranks); the step's launches; its ms (two more steps, None unless
    ``timed``) and the peak memory in GiB."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
    from shift_gcn_torch.ops import temporal_shift as ts
    from shift_gcn_torch.parallel import seqpar
    from shift_gcn_torch.train import state
    from shift_gcn_torch.train.optim import build_optimizer

    dev = torch.device(settings["device"])
    data, labels = synthetic_batch(np.random.default_rng(
        settings["seed"] + 18), settings["batch"], settings["t"])
    data = np.concatenate([data, np.zeros(
        data.shape[:2] + (t - data.shape[2],) + data.shape[3:],
        np.float32)], axis=2)
    config = ModelConfig(num_class=2, num_point=V, num_person=1,
                         graph="mediapipe_pose", remat=remat)
    model = Model(config, device=dev).init_weights(
        torch.Generator().manual_seed(settings["seed"]))
    if mesh is not None:
        seqpar.attach(model, mesh, shard_time)
    opt = build_optimizer(model, PARALLEL_LR)
    batch = {"data": torch.from_numpy(data).to(dev).requires_grad_(),
             "label": torch.from_numpy(labels).long().to(dev)}

    def step():
        if mesh is None:
            return state.train_step(model, opt, batch, PARALLEL_LR)
        return seqpar.train_step(model, opt, batch, PARALLEL_LR, mesh,
                                 shard_time)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    raws = []
    constraint = ts.constraint_step

    def recorded(gy_raw):
        raws.append(gy_raw.detach().cpu().numpy())
        return constraint(gy_raw)

    with mock.patch.object(ts, "constraint_step", recorded):
        loss = float(step()[0])
    launches = dict(kernels.LAUNCHES)
    # copies: on the CPU .numpy() shares the storage the timed steps
    # below accumulate into
    grads = {n: p.grad.cpu().numpy().copy()
             for n, p in model.named_parameters()}
    grad_in = batch["data"].grad
    if mesh is not None and mesh.tensor_parallel:
        from shift_gcn_torch.parallel import comm, tensor

        for n, p in model.named_parameters():
            axis = tensor.sharded_axis(n)
            if axis is not None:
                grads[n] = torch.cat(comm.all_gather(
                    p.grad, mesh.model_group), axis).cpu().numpy()
        grad_in = comm.all_reduce_sum_(grad_in.clone(), mesh.model_group)
    grads["input"] = (grad_in if mesh is None else mesh.local(
        grad_in, shard_time)).cpu().numpy().copy()
    # the backward takes the shifts in the reverse of the forward's order
    ypos = [n for n in grads if n.endswith("ypos")]
    for name, raw in zip(ypos, reversed(raws)):
        if not np.array_equal(constraint(torch.from_numpy(raw)).numpy(),
                              grads[name]):
            fail(f"gy_raw of {name}: not the raw gradient of its step")
        grads[f"gy_raw:{name}"] = raw
    if len(raws) != len(ypos):
        fail(f"{len(raws)} constraint steps for {len(ypos)} shifts")
    ms = elapsed_ms(step, dev) if timed else None
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    del model, opt, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return loss, grads, launches, ms, peak


def step_readings(loss: float, grads, ref_loss: float, ref_grads,
                  mesh, shard_time: bool) -> dict:
    """A rank's fp32 step (``mesh`` its place) against the one-process
    step: the loss's relative gap; the largest max|diff| / scale of a
    true gradient (ZERO_GRAD_BIASES against their weight gradient's
    scale), of the input's gradient on this rank's rows and frames (the
    largest L2 norm of a frame's gap over the mean frame norm, and its
    frame; and the largest element gap over the largest element; the
    rank's gradient is D times the global batch mean's: every rank
    back-propagates its shard's mean) and of a raw position gradient (D
    times the reference's as well: each rank's is a mean over its rows
    of a gradient that carries 1 / its rows); whether an xpos gradient
    is nonzero; and the ypos steps that differ, with those of them where
    the reference's raw gradient is not within PARALLEL_GRAD_TOL of its
    scale of 0 (no tie)."""
    out = {"loss": abs(loss - ref_loss) / abs(ref_loss), "grad": 0.0,
           "grad_at": None, "gy_raw": 0.0, "xpos": False, "flips": 0,
           "untied": 0, "steps": 0}

    def rel(got, want, scale_of=None):
        scale = float(np.abs(want if scale_of is None else scale_of).max())
        return float(np.abs(got - want).max()) / max(scale, 1e-30)

    # the input's gradient frame by frame: a ReLU flip moves single
    # elements of it (the largest element gap of a sound step read up to
    # 5.5e-2 of the largest element on the card), a fault of the halos a
    # whole frame
    want_in = mesh.local(ref_grads["input"], shard_time)
    diff = grads["input"] / mesh.data - want_in
    frames = np.sqrt((diff ** 2).sum((0, 1, 3, 4)))
    out["input"] = float(frames.max() / np.sqrt(
        (want_in ** 2).sum((0, 1, 3, 4))).mean())
    out["input_frame"] = int(frames.argmax())
    out["input_element"] = rel(diff + want_in, want_in)
    for name, want in ref_grads.items():
        got = grads[name]
        bias = next((b for b in ZERO_GRAD_BIASES if name.endswith(b)), None)
        if name == "input":
            continue
        if name.startswith("gy_raw:"):
            # D times the reference's too: the constraint reads its sign
            out["gy_raw"] = max(out["gy_raw"], rel(got / mesh.data, want))
        elif name.endswith("xpos"):
            out["xpos"] |= bool(got.any())
        elif name.endswith("ypos"):
            raw = ref_grads[f"gy_raw:{name}"]
            flipped = got != want
            out["flips"] += int(flipped.sum())
            out["untied"] += int((flipped & (np.abs(raw) > PARALLEL_GRAD_TOL
                                             * np.abs(raw).max())).sum())
            out["steps"] += got.size
        else:
            r = rel(got, want, ref_grads[name[:-len(bias)]
                                         + ZERO_GRAD_BIASES[bias]]
                    if bias else None)
            if r > out["grad"]:
                out["grad"], out["grad_at"] = r, name
    return out


def broken_gates(r: dict) -> list:
    """The gates a step's readings break."""
    broken = []
    if not r["loss"] <= 1e-5:
        broken.append(f"loss off by {r['loss']:.3g} relative (gate 1e-5)")
    for key, what in (("grad", f"gradient of {r['grad_at']}"),
                      ("input", "input's gradient (by frame)"),
                      ("gy_raw", "raw position gradient")):
        if not r[key] <= PARALLEL_GRAD_TOL:
            broken.append(f"{what} off by {r[key]:.3g} of its scale "
                          f"(gate {PARALLEL_GRAD_TOL:g})")
    if r["xpos"]:
        broken.append("a nonzero xpos gradient")
    if r["untied"]:
        broken.append(f"{r['untied']} ypos steps flipped off a tie")
    return broken


def readings_text(r: dict) -> str:
    return (f"loss gap {r['loss']:.3g} relative, max |diff|/scale: true "
            f"gradients {r['grad']:.3g} (at {r['grad_at']}), input by "
            f"frame {r['input']:.3g} (local frame {r['input_frame']}; by "
            f"element {r['input_element']:.3g}, not gated), raw position "
            f"gradients {r['gy_raw']:.3g} (gate {PARALLEL_GRAD_TOL:g}); "
            "ypos steps equal on "
            f"{r['steps'] - r['flips']} of {r['steps']}, "
            f"{r['flips'] - r['untied']} flips at a tie, {r['untied']} "
            "off one")


def compare_step(label: str, loss: float, grads, ref_loss: float,
                 ref_grads, mesh, shard_time: bool) -> str:
    """Fails unless a rank's fp32 step passes every gate against the
    one-process step; returns its readings as text."""
    r = step_readings(loss, grads, ref_loss, ref_grads, mesh, shard_time)
    broken = broken_gates(r)
    if broken:
        fail(f"{label}: " + "; ".join(broken))
    return readings_text(r)


def seqpar_trainer_config(settings: dict, workdir: str):
    """SEQPAR_CONFIG unchanged in model, batch and bf16, its feeders on
    the splits under ``workdir`` (padded to ``t_pad``), at the phase's
    mesh, for one epoch of PARALLEL_STEPS steps with eval and save."""
    import yaml

    from shift_gcn_torch.train.config import load_config

    with open(SEQPAR_CONFIG) as f:
        raw = yaml.safe_load(f)
    feeders = {}
    for split, key in (("train", "train_feeder_args"),
                       ("val", "test_feeder_args")):
        feeders[key] = dict(raw[key], pad_to_frames=settings["t_pad"],
                            data_path=os.path.join(workdir,
                                                   f"{split}_data.npy"),
                            label_path=os.path.join(workdir,
                                                    f"{split}_label.pkl"))
    return load_config([
        "--config", SEQPAR_CONFIG, "--num_epoch", "1", "--eval_interval",
        "1", "--save_interval", "1", "--log_interval", "1",
        "--batch_size", str(settings["batch"]), "--test_batch_size",
        str(settings["batch"]), "--mesh_shape", *map(str, settings["mesh"]),
        "--work_dir", os.path.join(workdir, "work"),
        "--model_saved_name", os.path.join(workdir, "save"),
        "--train_feeder_args", json.dumps(feeders["train_feeder_args"]),
        "--test_feeder_args", json.dumps(feeders["test_feeder_args"])])


def rank_dp(settings: dict, workdir: str):
    """Phase 18b on one rank: the fp32 step on this rank's rows."""
    import torch.distributed as dist

    from shift_gcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dist.get_world_size(), 1])
    loss, grads, launches, ms, peak = parallel_step(settings,
                                                    settings["t"], mesh)
    return ({"loss": loss, "launches": launches, "step_ms": ms,
             "peak_gib": peak}, {"grads": grads})


def rank_seqpar(settings: dict, workdir: str):
    """Phase 18c on one rank: ``Trainer.start()`` on SEQPAR_CONFIG, then
    the fp32 step on this rank's rows and frames."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.trainer import Trainer

    dev = torch.device(settings["device"])
    trainer = Trainer(seqpar_trainer_config(settings, workdir), device=dev)
    epochs = record_epochs(trainer)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trainer_peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    if dev.type == "cuda" else 0.0)
    mesh = trainer.mesh
    model_state = {k: v.cpu().numpy()
                   for k, v in trainer.model.state_dict().items()}
    summary = {"losses": epochs[0]["losses"], "launches": launches,
               "best_acc": best, "wall_s": wall,
               "trainer_peak_gib": trainer_peak,
               "mesh": [mesh.data, mesh.model, mesh.hosts],
               "activation_dtype": trainer.cfg.activation_dtype}
    del trainer
    loss, grads, step_launches, ms, peak = parallel_step(
        settings, settings["t_pad"], mesh, shard_time=True)
    summary.update(loss=loss, step_launches=step_launches, step_ms=ms,
                   peak_gib=peak)
    arrays = {"state": model_state, "grads": grads}
    # 21e: the same step with each unit recomputed in the backward, its
    # halo exchanges and sync-BN all-reduces issued again there
    (summary["loss:remat"], arrays["grads:remat"],
     summary["launches:remat"]) = parallel_step(
        settings, settings["t_pad"], mesh, shard_time=True, timed=False,
        remat=True)[:3]
    for fault in settings.get("faults", ()):
        with planted(fault):
            summary[f"loss:{fault}"], arrays[f"grads:{fault}"] = \
                parallel_step(settings, settings["t_pad"], mesh,
                              shard_time=True, timed=False)[:2]
    return summary, arrays


def rank_main(args) -> None:
    """A rank process of phase 18: joins the gloo group on its card (or
    the CPU), runs its job, pickles its arrays and prints its summary."""
    import torch.distributed as dist

    from shift_gcn_torch import kernels

    settings = json.loads(args.settings)
    dev = torch.device(settings["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kernels.build_all()
    else:
        # the CPU rehearsal: as the CPU tests, without oneDNN's convolution
        # backward, and one thread a rank (a rank spinning in its thread
        # pool starves the others it waits for)
        torch.backends.mkldnn.enabled = False
        torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world)
    try:
        summary, arrays = RANK_JOBS[args.rank_job](settings, args.workdir)
        with open(os.path.join(args.workdir,
                               f"{args.rank_job}_{args.rank}.pkl"),
                  "wb") as f:
            pickle.dump(arrays, f)
        print(RANK_LINE + " " + json.dumps(dict(summary, rank=args.rank)),
              flush=True)
    finally:
        dist.destroy_process_group()


def run_world_of_one(rng, dev, workdir: str):
    """Phase 18a: ``Trainer.start()`` on TRAIN_CONFIG for PARALLEL_STEPS
    steps, once without a process group and once in a group of one rank
    (NCCL on the card), from the same seed: losses and parameters
    bit-equal.  Returns the group's backend and launch counts."""
    import torch.distributed as dist

    from shift_gcn_torch import kernels
    from shift_gcn_torch.parallel import launch
    from shift_gcn_torch.train.trainer import Trainer

    clips = PARALLEL_STEPS * N_WINDOWS
    os.makedirs(workdir)
    feeder_args = {split: write_split(workdir, split,
                                      *synthetic_batch(rng, n, T_WINDOW))
                   for split, n in (("train", clips), ("val", N_WINDOWS))}
    runs = []
    for grouped in (False, True):
        cfg = one_epoch_config(TRAIN_CONFIG, os.path.join(
            workdir, str(grouped)), feeder_args, "--batch_size",
            str(N_WINDOWS), "--test_batch_size", str(N_WINDOWS))
        backend = None
        if grouped:
            launch.init_distributed(dev.type, {
                "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())})
            backend = dist.get_backend()
        try:
            trainer = Trainer(cfg, device=dev)
            if grouped and trainer.mesh is None:
                fail("the Trainer in a group of one rank made no mesh")
            epochs = record_epochs(trainer)
            kernels.reset_launches()
            trainer.start()
            launches = dict(kernels.LAUNCHES)
            runs.append((epochs[0]["losses"], {
                k: v.cpu().clone() for k, v in
                trainer.model.state_dict().items()}))
            del trainer
        finally:
            if grouped:
                dist.destroy_process_group()
    (loss1, state1), (loss2, state2) = runs
    differ = [k for k in state1 if not torch.equal(state1[k], state2[k])]
    if loss1 != loss2 or differ:
        fail(f"a group of one rank is not bit-equal to no group: losses "
             f"{loss1} vs {loss2}, parameters differ at {differ[:5]}")
    expect = {k: PER_STEP[k] * PARALLEL_STEPS + PER_EVAL_FORWARD.get(k, 0)
              for k in PER_STEP}
    if launches != expect:
        fail(f"phase 18a launch counts {launches} != expected {expect}")
    return backend, launches, loss1


def seqpar_shapes(config, t: int, m: int, max_shift: int):
    """Per launch of one forward of a rank among ``m`` time ranks of
    T=``t`` clips: K1 (T, C, stride) on each shift's halo-extended block
    (its stride's low halo, the local frames, max_shift + 1 above: odd
    at stride 2), K4 (T, C, D) on the local frames."""
    from shift_gcn_torch.parallel import halo

    k1, k4 = [], []
    t_l = t // m
    for spec in config.blocks:
        k4.append((t_l, spec.in_channels, spec.out_channels))
        for stride in (1, spec.stride):
            lo, hi = halo.halo_sizes(max_shift, stride)
            k1.append((lo + t_l + hi, spec.out_channels, stride))
        t_l //= spec.stride
    return k1, k4


def check_rank_kernels(rng, dev) -> str:
    """Each kernel against its plain version, fp32 and bf16, at the
    launch shapes of a rank of 18b (N / 2 rows, T=T_WINDOW) and of
    SEQPAR_CONFIG at SEQPAR_MESH (N / D rows, T_PAD over M time ranks,
    the shifts on their halo-extended blocks).  Returns the text."""
    from shift_gcn_torch.models.shift_gcn import ModelConfig
    from shift_gcn_torch.ops import lowering as lowering_lib
    from shift_gcn_torch.train.config import load_config

    cfg = load_config(["--config", SEQPAR_CONFIG])
    max_shift = lowering_lib.resolve(lowering_lib.from_dict({
        **(cfg.model_args.get("lowering") or {}),
        **(cfg.lowering or {})})).max_shift
    config = ModelConfig(num_class=2, num_point=V, num_person=1,
                         graph="mediapipe_pose")
    gen = torch.Generator(device=dev).manual_seed(18)
    dtypes = (torch.float32, torch.bfloat16)
    dp = check_kernels_at(config, N_WINDOWS // 2, gen, rng, dev,
                          "18 [2, 1] rank", dtypes=dtypes)
    shapes = seqpar_shapes(config, T_PAD, SEQPAR_MESH[1], max_shift)
    sp = check_kernels_at(config, N_WINDOWS // SEQPAR_MESH[0], gen, rng,
                          dev, f"18 {list(SEQPAR_MESH)} rank", shapes,
                          dtypes)
    return (f"K1 bit-equal, K4/K5 within 2e-5 (bf16 2^-7) of scale, the "
            f"fused K2+K3 and K6 within phase 7's gates, fp32 and bf16, at "
            f"{dp} launch shapes of a [2, 1] rank ({N_WINDOWS // 2} rows, "
            f"T={T_WINDOW}) and {sp} of a {list(SEQPAR_MESH)} rank "
            f"({N_WINDOWS // SEQPAR_MESH[0]} rows, T={T_PAD} over "
            f"{SEQPAR_MESH[1]} time ranks, max_shift {max_shift}): K1 on "
            f"the halo-extended blocks (T, C, s) {sorted(set(shapes[0]))}, "
            f"K4 at (T, C, D) {sorted(set(shapes[1]))}")


def run_parallel(rng, dev, workdir: str, card: str, seed: int) -> dict:
    """Phase 18: data and sequence parallelism on this card (18a a group
    of one NCCL rank, the kernels at the ranks' launch shapes, 18b [2, 1]
    and 18c SEQPAR_MESH in gloo ranks that share it, with PLANTED_FAULTS
    read against 18c's gates).  Returns the figures for the summary."""
    import yaml

    from shift_gcn_torch.parallel.mesh import Mesh

    # the configs as phase 18 drives them: batch 64, bf16, T padded to 304
    # for sequence parallelism
    for path, pad in ((TRAIN_CONFIG, None), (SEQPAR_CONFIG, 304)):
        with open(path) as f:
            raw = yaml.safe_load(f)
        if (raw["batch_size"], raw["activation_dtype"],
                raw["train_feeder_args"].get("pad_to_frames")) != (
                    64, "bfloat16", pad):
            fail(f"{path} no longer trains batch 64 in bf16 with "
                 f"pad_to_frames {pad}")
    settings = parallel_settings(dev, seed)
    backend, launches_a, losses_a = run_world_of_one(
        rng, dev, os.path.join(workdir, "a"))
    print(f"[parallel] 18a: Trainer.start() on {TRAIN_CONFIG} (bf16, batch "
          f"{N_WINDOWS}, T={T_WINDOW}), {PARALLEL_STEPS} steps + eval, in a "
          f"{backend} group of one rank: losses {losses_a} and every "
          f"parameter bit-equal to the run without a group; launches "
          f"{launches_a} | {card}")
    print(f"[parallel] kernels: {check_rank_kernels(rng, dev)} | {card}")

    # 18b: the fp32 step, one process, then 2 data ranks on this card
    ref_loss, ref_grads, _, ref_ms_dp, ref_peak = parallel_step(
        settings, T_WINDOW)
    os.makedirs(os.path.join(workdir, "b"))
    dp_lines, results = run_ranks("dp", 2, os.path.join(workdir, "b"),
                                  settings)
    texts = []
    for line, res in zip(dp_lines, results):
        if line["launches"] != PER_STEP:
            fail(f"18b rank {line['rank']} launches {line['launches']} != "
                 f"{PER_STEP}")
        texts.append(compare_step(
            f"18b rank {line['rank']}", line["loss"], res["grads"],
            ref_loss, ref_grads, Mesh(2, 1, line["rank"]), False))
    print(f"[parallel] 18b: one fp32 step, {N_WINDOWS} clips x T={T_WINDOW},"
          f" [2, 1] data ranks (gloo, sharing this card) vs one process: "
          f"rank 0 {texts[0]}; rank 1 {texts[1]}; ranks' launches "
          f"{[l['launches'] for l in dp_lines]}; step ms per rank "
          f"{[round(l['step_ms'], 3) for l in dp_lines]} (ranks sharing one "
          f"card, not a scaling figure) vs {ref_ms_dp:.3f} one process; "
          f"peak GiB per rank "
          f"{[round(l['peak_gib'], 3) for l in dp_lines]} vs "
          f"{ref_peak:.3f} | {card}")

    # 18c: SEQPAR_CONFIG through the Trainer, then the fp32 step, sound
    # and with each planted fault
    ref_loss, ref_grads, _, ref_ms, ref_peak = parallel_step(settings, T_PAD)
    world = SEQPAR_MESH[0] * SEQPAR_MESH[1]
    cdir = os.path.join(workdir, "c")
    os.makedirs(cdir)
    clips = PARALLEL_STEPS * N_WINDOWS
    for split, n in (("train", clips), ("val", N_WINDOWS)):
        write_split(cdir, split, *synthetic_batch(rng, n, T_WINDOW))
    lines, results = run_ranks("seqpar", world, cdir, settings)
    expect = {k: PER_STEP[k] * PARALLEL_STEPS + PER_EVAL_FORWARD.get(k, 0)
              for k in PER_STEP}
    texts = []
    caught = {fault: [] for fault in PLANTED_FAULTS}
    for line, res in zip(lines, results):
        rank = line["rank"]
        if (line["activation_dtype"] != "bfloat16"
                or line["mesh"] != [*SEQPAR_MESH, 1]):
            fail(f"18c rank {rank}: not bf16 on {SEQPAR_MESH}: {line}")
        if line["launches"] != expect or line["step_launches"] != PER_STEP:
            fail(f"18c rank {rank} launches {line['launches']} / step "
                 f"{line['step_launches']} != {expect} / {PER_STEP}")
        if (line["losses"] != lines[0]["losses"]
                or len(line["losses"]) != PARALLEL_STEPS
                or not np.isfinite(line["losses"]).all()):
            fail(f"18c rank {rank} losses {line['losses']}")
        for key, value in res["state"].items():
            if not np.array_equal(value, results[0]["state"][key]):
                fail(f"18c rank {rank}: {key} differs from rank 0's")
        mesh = Mesh(*SEQPAR_MESH, rank)
        texts.append(compare_step(f"18c rank {rank}", line["loss"],
                                  res["grads"], ref_loss, ref_grads, mesh,
                                  True))
        for fault in PLANTED_FAULTS:
            r = step_readings(line[f"loss:{fault}"], res[f"grads:{fault}"],
                              ref_loss, ref_grads, mesh, True)
            caught[fault].append((r, broken_gates(r)))
    saved = os.listdir(os.path.join(cdir, "save",
                                    "mediapipe_ShiftGCN_joint_seqpar"))
    with open(os.path.join(cdir, "work", "mediapipe_ShiftGCN_joint_seqpar",
                           "eval_results", "best_acc.pkl"), "rb") as f:
        scored = len(pickle.load(f))
    if len(saved) != 1 or scored != N_WINDOWS:
        fail(f"18c: checkpoints {saved}, {scored} clips scored")
    print(f"[parallel] 18c: Trainer.start() on {SEQPAR_CONFIG} (bf16, batch "
          f"{N_WINDOWS}, T={T_WINDOW} padded to {T_PAD}) at mesh "
          f"{list(SEQPAR_MESH)} (the one cut: [4, 2] needs 8 ranks), "
          f"{world} gloo ranks sharing this card, {PARALLEL_STEPS} steps + "
          f"eval + save: losses {lines[0]['losses']} and parameters equal "
          f"on every rank, checkpoint {saved[0]}, {scored} clips scored; "
          f"launches per rank {[l['launches'] for l in lines]}; wall s "
          f"{[round(l['wall_s'], 1) for l in lines]}, peak GiB per rank "
          f"{[round(l['trainer_peak_gib'], 3) for l in lines]} | {card}")
    print(f"[parallel] 18c: one fp32 step, {N_WINDOWS} clips x T={T_PAD}, "
          f"each rank on its rows and frames vs the unsharded step: "
          + "; ".join(f"rank {r} {text}" for r, text in enumerate(texts))
          + f"; step ms per rank {[round(l['step_ms'], 3) for l in lines]} "
          f"(ranks sharing one card, not a scaling figure) vs {ref_ms:.3f} "
          f"one process; peak GiB per rank "
          f"{[round(l['peak_gib'], 3) for l in lines]} vs {ref_peak:.3f} | "
          f"{card}")
    for fault, per_rank in caught.items():
        if not any(broken for _, broken in per_rank):
            fail(f"18c: the planted fault {fault} passed every gate: "
                 + "; ".join(readings_text(r) for r, _ in per_rank))
        worst = max(per_rank, key=lambda item: len(item[1]))
        print(f"[parallel] 18c planted fault {fault}: caught on ranks "
              f"{[r for r, (_, b) in enumerate(per_rank) if b]} of {world};"
              f" {readings_text(worst[0])}; broken: "
              f"{'; '.join(worst[1])} | {card}")
    # 21e, read here and printed with phase 21
    loose = 0.0
    for line, res in zip(lines, results):
        differ = []
        for name, want in res["grads"].items():
            got = res["grads:remat"][name]
            if np.array_equal(got, want):
                continue
            gap = nonrepeating_gap(name, torch.from_numpy(got),
                                   torch.from_numpy(want),
                                   np.abs(want).max())
            if gap is None or not gap <= STEP_GRAD_TOL:
                differ.append(name)
            else:
                loose = max(loose, gap)
        if line["loss:remat"] != line["loss"] or differ:
            fail(f"21e rank {line['rank']}: the step with remat is not "
                 f"the step without it: loss {line['loss:remat']} vs "
                 f"{line['loss']}, gradients differing {differ[:5]}")
        if line["launches:remat"] != REMAT_STEP:
            fail(f"21e rank {line['rank']} launches "
                 f"{line['launches:remat']} != {REMAT_STEP}")
    remat = (f"21e: one fp32 step, {N_WINDOWS} clips x T={T_PAD}, at mesh "
             f"{list(SEQPAR_MESH)} in phase 18c's {world} gloo ranks with "
             f"remat: on every rank the loss, every parameter's gradient "
             f"(cuDNN's stride-2 backward-filter within {loose:.3g} of "
             f"scale), the input's gradient and every raw position "
             f"gradient bit-equal to the same rank's step without it "
             f"(losses {[line['loss'] for line in lines]}); launches per "
             f"rank {lines[0]['launches:remat']} | {card}")
    return {"dp_ms": [line["step_ms"] for line in dp_lines],
            "seqpar_ms": [line["step_ms"] for line in lines],
            "one_ms": (ref_ms, ref_ms_dp), "remat": remat}


# ---------------------------------------------------------------------------
# Tensor parallelism (phase 19)
# ---------------------------------------------------------------------------

TP_MESHES = ((1, 2), (2, 2))
TP_STEPS = 2   # Trainer steps of phase 19b
# 19c reruns its fp32 step with one tensor-parallel rule broken on every
# rank (``tp_planted``): "k4_offset" launches K4 (and so K5 and K6) at
# d0 = 0 whatever the rank's slice; "sharded_sum" sums the sharded
# gradients over the world, the model ranks' different slices added,
# where they belong to the data ranks alone.  The gates of phase 18
# (PARALLEL_GRAD_TOL) must catch each.
TP_FAULTS = ("k4_offset", "sharded_sum")
# the one-process evaluation of 19b's checkpoint against the scores the
# [1, 2] run wrote: bf16 activations, and the 1x1's matmul on a slice may
# take another cuBLAS order (scripts/torch_multigpu_smoke.sh's gate)
TP_SCORE_GATE = 1e-2


@contextmanager
def tp_planted(fault: str):
    """One of TP_FAULTS planted in this rank process (every rank the
    same, so that the collectives still pair)."""
    import types

    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.parallel import mesh as mesh_lib

    real = sk.fused_shift_gcn
    patch = {
        "k4_offset": lambda: mock.patch.object(
            sk, "fused_shift_gcn",
            lambda x, gate, w, bias, d0=0: real(x, gate, w, bias)),
        "sharded_sum": lambda: mock.patch.object(
            mesh_lib, "tensor",
            types.SimpleNamespace(sharded_axis=lambda name: None)),
    }[fault]()
    with patch:
        yield


def check_tp_kernels(config, gen, dev, card: str) -> str:
    """K4 and K5 within 2e-5 of scale (2^-7 in bf16) and K6 within phase
    7's gates of their plain versions at every (shape, d0) a rank of
    TP_MESHES launches in one train step (N / D rows at T=T_WINDOW, each
    layer's output channels over M: d0 = 0 and d0 = D / M), fp32 and
    bf16, the first unit's C=3 included; each kernel's time a step at the
    last rank's slice (d0 != 0) beside its bound.  Returns the text."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss

    v = config.num_point
    _, k4_shapes = forward_shapes(config, T_WINDOW)
    checked, texts = 0, []
    for data, model in TP_MESHES:
        n = N_WINDOWS // data
        # per step of the last rank: kernel -> [fp32 ms, bf16 ms, fp32
        # bound, bf16 bound]
        times = {k: [0.0] * 4 for k in ("shift_gcn", "shift_gcn_dx",
                                         "shift_gcn_wgrad")}
        for i, dtype in enumerate((torch.float32, torch.bfloat16)):
            tol = 2e-5 if dtype == torch.float32 else 2 ** -7
            size = 4 if dtype == torch.float32 else 2
            for t, c, d in sorted(set(k4_shapes)):
                count = k4_shapes.count((t, c, d))
                width, r = d // model, n * t
                x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
                g = torch.randn(r, v, width, generator=gen,
                                device=dev).to(dtype)
                gate = torch.tanh(torch.randn(v, c, generator=gen,
                                              device=dev)) + 1.0
                w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
                b = torch.randn(d, generator=gen, device=dev) * 0.1
                for m in range(model):
                    d0 = m * width
                    ws = w[:, d0:d0 + width].contiguous()
                    bs = b[d0:d0 + width].contiguous()
                    label = (f"19 [{data}, {model}] rank m={m} "
                             f"{str(dtype)[6:]} T={t} C={c} D={d} d0={d0}")
                    for kernel, got, want in (
                            ("K4", sk.fused_shift_gcn(x, gate, ws, bs, d0),
                             ss.shift_gcn_transform(x, gate, ws, bs, d0)),
                            ("K5", sk.shift_gcn_dx(g, gate, ws, d0),
                             ss.shift_gcn_dx_reference(g, gate, ws, d0))):
                        err, scale = max_err(got, want)
                        if not err <= tol * scale:
                            fail(f"{label} {kernel}: max|err| {err:.3g} > "
                                 f"{tol * scale:.3g}")
                    check_wgrad(x, g, gate, ws, label, d0)
                    checked += 1
                bound = max(k4_cost_ms(r, c, width, itemsize=size))
                k6_bound = max(k6_cost_ms(
                    r, c, width, itemsize=size,
                    flops_per_s=TF32_3X_FLOPS if size == 4 else BF16_FLOPS))
                for kernel, fn, kb in (
                        ("shift_gcn", lambda: sk.fused_shift_gcn(
                            x, gate, ws, bs, d0), bound),
                        ("shift_gcn_dx", lambda: sk.shift_gcn_dx(
                            g, gate, ws, d0), bound),
                        ("shift_gcn_wgrad", lambda: sk.shift_gcn_wgrad(
                            x, g, gate, ws, d0), k6_bound)):
                    times[kernel][i] += count * time_ms(fn, iters=5, reps=3)
                    times[kernel][2 + i] += count * kb
                del x, g
            torch.cuda.empty_cache()
        texts.append(f"[{data}, {model}] rank m={model - 1} ({n} rows, "
                     f"d0 = D/{model}) per step, fp32 / bf16 ms (bound): "
                     + ", ".join(
                         f"{k} {a:.4f} ({c_:.4f}) / {b_:.4f} ({d_:.4f})"
                         for k, (a, b_, c_, d_) in times.items()))
    return (f"K4/K5 within 2e-5 (bf16 2^-7) of scale and K6 within phase "
            f"7's gates, fp32 and bf16, at {checked} (shape, d0) launches "
            f"of the ranks of {[list(m) for m in TP_MESHES]} (T={T_WINDOW},"
            f" C=3 first unit included); " + "; ".join(texts)
            + f" | {card}")


def tp_feeders(workdir: str) -> dict:
    return {split: {"data_path": os.path.join(workdir, f"{split}_data.npy"),
                    "label_path": os.path.join(workdir,
                                               f"{split}_label.pkl")}
            for split in ("train", "val")}


def rank_tp(settings: dict, workdir: str):
    """Phase 19b on one rank: ``Trainer.start()`` on TRAIN_CONFIG at mesh
    [1, 2] for TP_STEPS steps with eval and save, then the fp32 step on
    the tensor-parallel mesh."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.trainer import Trainer

    dev = torch.device(settings["device"])
    cfg = one_epoch_config(
        TRAIN_CONFIG, workdir, tp_feeders(workdir), "--batch_size",
        str(settings["batch"]), "--test_batch_size", str(settings["batch"]),
        "--mesh_shape", "1", "2")
    trainer = Trainer(cfg, device=dev)
    epochs = record_epochs(trainer)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    mesh = trainer.mesh
    summary = {"losses": epochs[0]["losses"],
               "clips_per_sec": epochs[0]["clips_per_sec"],
               "launches": dict(kernels.LAUNCHES), "wall_s": wall,
               "mesh": [mesh.data, mesh.model, int(mesh.tensor_parallel)],
               "activation_dtype": trainer.cfg.activation_dtype,
               "shapes": {k: list(p.shape) for k, p in
                          trainer.model.named_parameters()
                          if k.endswith(("Linear_weight",
                                         "temporal_linear.weight"))}}
    del trainer
    loss, grads, step_launches, ms, peak = parallel_step(
        settings, settings["t"], mesh)
    summary.update(loss=loss, step_launches=step_launches, step_ms=ms,
                   peak_gib=peak)
    return summary, {"grads": grads}


def rank_tp22(settings: dict, workdir: str):
    """Phase 19c on one rank: the fp32 step at mesh [2, 2], sound and with
    each of TP_FAULTS."""
    from shift_gcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh([2, 2], tensor_parallel=True)
    loss, grads, launches, ms, peak = parallel_step(settings, settings["t"],
                                                    mesh)
    summary = {"loss": loss, "step_launches": launches, "step_ms": ms,
               "peak_gib": peak}
    arrays = {"grads": grads}
    for fault in settings["faults"]:
        with tp_planted(fault):
            summary[f"loss:{fault}"], arrays[f"grads:{fault}"] = \
                parallel_step(settings, settings["t"], mesh,
                              timed=False)[:2]
    return summary, arrays


def scores_file(workdir: str, name: str) -> dict:
    """The one epoch_0_*.pkl score file a run wrote."""
    folder = os.path.join(workdir, "work", name, "eval_results")
    found = [f for f in os.listdir(folder) if f.startswith("epoch_0_")]
    if len(found) != 1:
        fail(f"19: score files {found} in {folder}")
    with open(os.path.join(folder, found[0]), "rb") as f:
        got = pickle.load(f)
    return np.stack([got[k] for k in sorted(got)])


def run_tensor_parallel(rng, dev, workdir: str, card: str,
                        seed: int) -> dict:
    """Phase 19: tensor parallelism on this card (19a the kernels at every
    rank's (shape, d0); 19b [1, 2] and 19c [2, 2] in gloo ranks sharing
    it, with TP_FAULTS read against 19c's gates).  Returns the figures
    for the summary."""
    from shift_gcn_torch.models.shift_gcn import ModelConfig
    from shift_gcn_torch.parallel.mesh import Mesh
    from shift_gcn_torch.train.trainer import Trainer

    config = ModelConfig(num_class=2, num_point=V, num_person=1,
                         graph="mediapipe_pose")
    gen = torch.Generator(device=dev).manual_seed(19)
    print(f"[tp] 19a kernels: {check_tp_kernels(config, gen, dev, card)}")

    settings = {"device": str(dev), "seed": seed, "batch": N_WINDOWS,
                "t": T_WINDOW, "faults": list(TP_FAULTS)}
    ref_loss, ref_grads, _, ref_ms, ref_peak = parallel_step(settings,
                                                             T_WINDOW)
    # 19b: TRAIN_CONFIG through the Trainer at [1, 2], then the fp32 step
    bdir = os.path.join(workdir, "b")
    os.makedirs(bdir)
    for split, n in (("train", TP_STEPS * N_WINDOWS), ("val", N_WINDOWS)):
        write_split(bdir, split, *synthetic_batch(rng, n, T_WINDOW))
    lines, results = run_ranks("tp", 2, bdir, settings, timeout=600)
    expect = {k: PER_STEP[k] * TP_STEPS + PER_EVAL_FORWARD.get(k, 0)
              for k in PER_STEP}
    texts = []
    for line, res in zip(lines, results):
        rank = line["rank"]
        if (line["activation_dtype"] != "bfloat16"
                or line["mesh"] != [1, 2, 1]):
            fail(f"19b rank {rank}: not bf16 on a [1, 2] tensor-parallel "
                 f"mesh: {line}")
        if line["shapes"]["l1.gcn1.Linear_weight"] != [3, 32] or line[
                "shapes"]["l10.tcn1.temporal_linear.weight"] != [
                    128, 256, 1, 1]:
            fail(f"19b rank {rank}: not its slices: {line['shapes']}")
        if line["launches"] != expect or line["step_launches"] != PER_STEP:
            fail(f"19b rank {rank} launches {line['launches']} / step "
                 f"{line['step_launches']} != {expect} / {PER_STEP}")
        if (line["losses"] != lines[0]["losses"]
                or len(line["losses"]) != TP_STEPS
                or not np.isfinite(line["losses"]).all()):
            fail(f"19b rank {rank} losses {line['losses']}")
        texts.append(compare_step(f"19b rank {rank}", line["loss"],
                                  res["grads"], ref_loss, ref_grads,
                                  Mesh(1, 2, rank), False))
    name = "mediapipe_ShiftGCN_joint"
    saved = sorted(os.listdir(os.path.join(bdir, "save", name)))
    if len(saved) != 1:
        fail(f"19b: checkpoints {saved}")
    # the full-layout checkpoint, evaluated in this process alone
    odir = os.path.join(workdir, "one")
    cfg = one_epoch_config(
        TRAIN_CONFIG, odir, tp_feeders(bdir), "--phase", "test", "--weights",
        os.path.join(bdir, "save", name, saved[0]), "--batch_size",
        str(N_WINDOWS), "--test_batch_size", str(N_WINDOWS))
    Trainer(cfg, device=dev).start()
    got, want = scores_file(bdir, name), scores_file(odir, name)
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    same = int((got.argmax(1) == want.argmax(1)).sum())
    if not gap <= TP_SCORE_GATE or same != len(got):
        fail(f"19b: the [1, 2] run's scores vs its checkpoint evaluated in "
             f"one process: max |diff| {gap:.3g} of scale (gate "
             f"{TP_SCORE_GATE:g}), predictions equal on {same} of "
             f"{len(got)}")
    print(f"[tp] 19b: Trainer.start() on {TRAIN_CONFIG} (bf16, batch "
          f"{N_WINDOWS}, T={T_WINDOW}) at mesh [1, 2], 2 gloo ranks sharing "
          f"this card, {TP_STEPS} steps + eval + save: losses "
          f"{lines[0]['losses']} on both ranks, each holding its slices "
          f"(l1 Linear_weight {lines[0]['shapes']['l1.gcn1.Linear_weight']}"
          f"), launches per rank {[l['launches'] for l in lines]}, epoch "
          f"clips/s {[round(l['clips_per_sec'], 2) for l in lines]}, wall s "
          f"{[round(l['wall_s'], 1) for l in lines]}; checkpoint "
          f"{saved[0]} (full layout) evaluated in one process: scores "
          f"within {gap:.3g} of scale, predictions equal on {same} of "
          f"{len(got)} | {card}")
    print(f"[tp] 19b: one fp32 step, {N_WINDOWS} clips x T={T_WINDOW}, at "
          f"[1, 2] vs one process: "
          + "; ".join(f"rank {r} {text}" for r, text in enumerate(texts))
          + f"; step ms per rank {[round(l['step_ms'], 3) for l in lines]} "
          f"(ranks sharing one card, gathers through host memory: not a "
          f"scaling figure) vs {ref_ms:.3f} one process; peak GiB per rank "
          f"{[round(l['peak_gib'], 3) for l in lines]} vs {ref_peak:.3f} | "
          f"{card}")

    # 19c: the fp32 step at [2, 2], sound and with each planted fault
    cdir = os.path.join(workdir, "c")
    os.makedirs(cdir)
    lines22, results22 = run_ranks("tp22", 4, cdir, settings, timeout=600)
    texts22 = []
    caught = {fault: [] for fault in TP_FAULTS}
    for line, res in zip(lines22, results22):
        rank = line["rank"]
        if line["step_launches"] != PER_STEP:
            fail(f"19c rank {rank} launches {line['step_launches']} != "
                 f"{PER_STEP}")
        mesh = Mesh(2, 2, rank)
        texts22.append(compare_step(f"19c rank {rank}", line["loss"],
                                    res["grads"], ref_loss, ref_grads, mesh,
                                    False))
        for fault in TP_FAULTS:
            r = step_readings(line[f"loss:{fault}"], res[f"grads:{fault}"],
                              ref_loss, ref_grads, mesh, False)
            caught[fault].append((r, broken_gates(r)))
    print(f"[tp] 19c: one fp32 step, {N_WINDOWS} clips x T={T_WINDOW}, at "
          f"[2, 2] (4 gloo ranks sharing this card) vs one process: "
          + "; ".join(f"rank {r} {text}" for r, text in enumerate(texts22))
          + f"; step ms per rank "
          f"{[round(l['step_ms'], 3) for l in lines22]} (not a scaling "
          f"figure) vs {ref_ms:.3f} one process; peak GiB per rank "
          f"{[round(l['peak_gib'], 3) for l in lines22]} vs "
          f"{ref_peak:.3f} | {card}")
    for fault, per_rank in caught.items():
        if not any(broken for _, broken in per_rank):
            fail(f"19c: the planted fault {fault} passed every gate: "
                 + "; ".join(readings_text(r) for r, _ in per_rank))
        worst = max(per_rank, key=lambda item: len(item[1]))
        print(f"[tp] 19c planted fault {fault}: caught on ranks "
              f"{[r for r, (_, b) in enumerate(per_rank) if b]} of 4; "
              f"{readings_text(worst[0])}; broken: {'; '.join(worst[1])} | "
              f"{card}")
    return {"tp12_ms": [line["step_ms"] for line in lines],
            "tp22_ms": [line["step_ms"] for line in lines22],
            "one_ms": ref_ms}


# ---------------------------------------------------------------------------
# The edge partition (phase 20)
# ---------------------------------------------------------------------------

# 20a's one cut: STGCN_CONFIG's mesh [2, 4] on the data axis only, the edge
# axis as shipped; 20b's steps at both layouts of 4 ranks; 20c at
# RING_CONFIG's own [1, 8]
EDGE_MESH = (1, 4)
EDGE_STEP_MESHES = ((1, 4), (2, 2))
RING_MESH = (1, 8)
EDGE_STEPS = 2        # Trainer steps of 20a
RING_STEPS = 4        # Trainer steps of 20c
EDGE_BATCH = 16       # STGCN_CONFIG's (and RING_CONFIG's) batch_size
# 20d reruns a step with one adjoint broken on every rank (``edge_planted``):
# "edge_adjoint" makes the backward of the partial sums' all-reduce the
# identity (each partial gets its own rank's 1/M share of the cotangent);
# "ring_reverse" sends the ring's cotangents the way its forward sent the
# features, to the left.  The gates of 20b / 20c must catch each.
EDGE_FAULTS = ("edge_adjoint", "ring_reverse")
# a ring-GNN logit or gradient against one process: another fp32 order
# of the same sums, no BN (tests/test_torch_ring_gnn.py's tolerance); the
# checkpoints scored in one process likewise
RING_TOL = EDGE_SCORE_GATE = 1e-5
EDGE_LOSS_TOL = 1e-5  # relative: a rank's loss against one process


@contextmanager
def edge_planted(fault: str):
    """One of EDGE_FAULTS planted in this rank process (every rank the
    same, so that the collectives still pair)."""
    import types

    from shift_gcn_torch.parallel import comm, edge_partition

    class IdentityBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            return comm.all_reduce_sum_(x.clone(), group)

        @staticmethod
        def backward(ctx, g):
            return g, None

    found = {
        "edge_adjoint": types.SimpleNamespace(
            all_reduce_sum=IdentityBackward.apply, rotate=comm.rotate),
        "ring_reverse": types.SimpleNamespace(
            all_reduce_sum=comm.all_reduce_sum,
            rotate=lambda t, group, shift: comm.rotate(t, group, -1)),
    }[fault]
    with mock.patch.object(edge_partition, "comm", found):
        yield


def edge_batch(settings: dict, family: str):
    """The seeded global batch of a phase 20 step: ST-GCN clips
    (EDGE_BATCH, 3, T, 33, 1) or ring-GNN node clips (EDGE_BATCH, 8, 1,
    256, 1), and labels running through the classes."""
    rng = np.random.default_rng(settings["seed"] + 20)
    if family == "stgcn":
        data, _ = synthetic_batch(rng, settings["batch"], settings["t"])
    else:
        data = rng.standard_normal((settings["batch"], 8, 1, 256, 1)
                                   ).astype(np.float32)
    return data, np.arange(settings["batch"]) % 2


def edge_model_args(settings: dict, family: str) -> dict:
    """``model_args`` of STGCN_CONFIG / RING_CONFIG, with the settings'
    overrides (none on the card: the full width)."""
    import yaml

    with open(STGCN_CONFIG if family == "stgcn" else RING_CONFIG) as f:
        return dict(yaml.safe_load(f)["model_args"],
                    **settings.get("model_args", {}).get(family, {}))


def edge_model(settings: dict, family: str, dev, dtype=torch.float32):
    """The family's model of ``edge_model_args`` from the seeded init."""
    from shift_gcn_torch.models import ring_gnn, stgcn

    module = stgcn if family == "stgcn" else ring_gnn
    model = module.Model(module.config_from_args(edge_model_args(
        settings, family)), device="cpu")
    model.init_weights(torch.Generator().manual_seed(settings["seed"]))
    return model.to(device=dev, dtype=dtype)


def edge_step(settings: dict, family: str, mesh=None, strategy=None,
              dtype=torch.float32, timed: bool = True):
    """One SGD step of ``family``'s model from the seeded init on the
    seeded global batch: under ``mesh`` this rank's (edge_partition's
    train step), else whole in ``dtype``.  Returns the loss, the logits
    of the train-mode forward (this rank's rows), the gradients, the
    step's ms (two more steps, None unless ``timed``) and peak GiB."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.parallel import edge_partition
    from shift_gcn_torch.train import state
    from shift_gcn_torch.train.optim import build_optimizer

    dev = torch.device(settings["device"])
    model = edge_model(settings, family, dev, dtype)
    if mesh is not None:
        edge_partition.attach(model, mesh, strategy)
    opt = build_optimizer(model, PARALLEL_LR)
    data, labels = edge_batch(settings, family)
    batch = {"data": torch.from_numpy(data).to(dev, dtype),
             "label": torch.from_numpy(labels).to(dev)}
    logits = []
    hook = model.register_forward_hook(
        lambda _m, _i, out: logits.append(out.detach().cpu().double()))

    def step():
        if mesh is None:
            return state.train_step(model, opt, batch, PARALLEL_LR)
        return edge_partition.train_step(model, opt, batch, PARALLEL_LR,
                                         mesh)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    loss = float(step()[0])
    hook.remove()
    if any(kernels.LAUNCHES[k] for k in kernels.LAUNCHES
           if k not in BN_KERNELS):
        fail(f"20: {family} launched the port's Shift-GCN kernels "
             f"{kernels.LAUNCHES}")
    grads = {n: p.grad.detach().cpu().double().numpy().copy()
             for n, p in model.named_parameters()}
    ms = elapsed_ms(step, dev) if timed else None
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    del model, opt, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return loss, logits[0].numpy(), grads, ms, peak


def edge_trainer(settings: dict, workdir: str, family: str, mesh):
    """``Trainer.start()`` on the family's config at ``mesh`` for one
    epoch with eval and save on the splits under ``workdir`` (this
    rank's part of a gloo group, or one process when ``mesh`` is None:
    then ``phase: test`` on ``settings["weights"]``, the edge-partition
    keys off).  Returns its summary."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.trainer import Trainer

    dev = torch.device(settings["device"])
    path = STGCN_CONFIG if family == "stgcn" else RING_CONFIG
    extra = ["--batch_size", str(settings["batch"]), "--test_batch_size",
             str(settings["batch"])]
    if family in settings.get("model_args", {}):
        extra += ["--model_args", json.dumps(edge_model_args(settings,
                                                             family))]
    if mesh is None:
        extra += ["--mesh_shape", "--edge_partition", "false", "--phase",
                  "test", "--weights", settings["weights"]]
    else:
        extra += ["--mesh_shape", *map(str, mesh)]
    cfg = one_epoch_config(path, workdir, tp_feeders(settings["data"]),
                           "--Experiment_name", family, *extra)
    trainer = Trainer(cfg, device=dev)
    epochs = record_epochs(trainer)
    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if any(kernels.LAUNCHES[k] for k in kernels.LAUNCHES
           if k not in BN_KERNELS):
        fail(f"20: the {family} Trainer launched the port's Shift-GCN "
             f"kernels {kernels.LAUNCHES}")
    tmesh = trainer.mesh
    return {"losses": epochs[0]["losses"] if epochs else [],
            "clips_per_sec": epochs[0]["clips_per_sec"] if epochs else None,
            "best_acc": best, "wall_s": wall,
            "mesh": None if tmesh is None else [
                tmesh.data, tmesh.model, int(tmesh.tensor_parallel)],
            "config": [trainer.cfg.edge_partition, trainer.cfg.edge_strategy,
                       repr(trainer.model_config)],
            "saved": (sorted(os.listdir(trainer.save_dir))
                      if os.path.isdir(trainer.save_dir) else [])}


def rank_edge(settings: dict, workdir: str):
    """Phase 20a/b/d on one of 4 ranks: ``Trainer.start()`` on STGCN_CONFIG
    at EDGE_MESH, the fp32 step at each of EDGE_STEP_MESHES, and the step
    at EDGE_MESH again with "edge_adjoint" planted."""
    from shift_gcn_torch.parallel.mesh import make_mesh

    summary = {"trainer": edge_trainer(settings, workdir, "stgcn",
                                       EDGE_MESH)}
    arrays = {}
    meshes = {tuple(shape): make_mesh(list(shape))
              for shape in EDGE_STEP_MESHES}
    for shape, mesh in meshes.items():
        key = "x".join(map(str, shape))
        loss, logits, grads, ms, peak = edge_step(settings, "stgcn", mesh,
                                                  "gather")
        summary[key] = {"loss": loss, "step_ms": ms, "peak_gib": peak}
        arrays[key] = {"grads": grads}
    with edge_planted("edge_adjoint"):
        loss, _, grads, _, _ = edge_step(settings, "stgcn",
                                         meshes[EDGE_MESH], "gather",
                                         timed=False)
    summary["edge_adjoint"] = {"loss": loss}
    arrays["edge_adjoint"] = {"grads": grads}
    return summary, arrays


def rank_ring(settings: dict, workdir: str):
    """Phase 20c/d on one of 8 ranks: ``Trainer.start()`` on RING_CONFIG at
    its mesh, the fp32 step there, and again with "ring_reverse"
    planted."""
    summary = {"trainer": edge_trainer(settings, workdir, "ring",
                                       RING_MESH)}
    from shift_gcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh(list(RING_MESH))
    loss, logits, grads, ms, peak = edge_step(settings, "ring", mesh, "ring")
    summary["step"] = {"loss": loss, "step_ms": ms, "peak_gib": peak}
    arrays = {"step": {"grads": grads, "logits": logits}}
    with edge_planted("ring_reverse"):
        loss, logits, grads, _, _ = edge_step(settings, "ring", mesh, "ring",
                                              timed=False)
    summary["ring_reverse"] = {"loss": loss}
    arrays["ring_reverse"] = {"grads": grads, "logits": logits}
    return summary, arrays


def edge_gates(loss: float, grads, ref: dict, family: str) -> dict:
    """A rank's fp32 step against the one-process step (``ref``: loss,
    grads; for ST-GCN also ``grads64``, the float64 step's): the loss's
    relative gap (gate EDGE_LOSS_TOL); ST-GCN's gradients by phase 17's
    rule (each true gradient's relative L2 gap to float64 within
    GRAD_RATIO x the one-process fp32 step's plus GRAD_FLOOR; the
    biases a train-mode BN cancels within 5e-4 of their weight
    gradient's scale), the ring-GNN's within RING_TOL of scale of the
    one process's.  Returns the readings with the gates broken."""
    out = {"loss": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "worst": 0.0, "at": None, "broken": []}
    if not out["loss"] <= EDGE_LOSS_TOL:
        out["broken"].append(f"loss off by {out['loss']:.3g} relative "
                             f"(gate {EDGE_LOSS_TOL:g})")

    def l2(g, want):
        return float(np.linalg.norm(g - want)) / max(
            float(np.linalg.norm(want)), 1e-30)

    for name, want in ref["grads"].items():
        got = grads[name]
        if family == "ring":
            r = float(np.abs(got - want).max()) / max(
                float(np.abs(want).max()), 1e-30)
            gate = RING_TOL
        else:
            weight = next((name[:-len(b)] + w for b, w in STGCN_ZERO_GRAD
                           if name.endswith(b)), None)
            if weight is not None:
                r = float(np.abs(got).max()) / float(
                    np.abs(ref["grads64"][weight]).max())
                gate = 5e-4
            else:
                r = l2(got, ref["grads64"][name])
                gate = GRAD_RATIO * l2(want, ref["grads64"][name]) + \
                    GRAD_FLOOR
        if r > out["worst"]:
            out["worst"], out["at"] = r, name
        if not r <= gate:
            out["broken"].append(f"gradient {name} at {r:.3g} (gate "
                                 f"{gate:.3g})")
    return out


def edge_text(r: dict) -> str:
    return (f"loss {r['loss']:.3g} relative, worst gradient {r['worst']:.3g}"
            f" ({r['at']})")


def check_edge_run(label: str, line: dict, mesh, family: str,
                   want_config: str, steps: int):
    """A rank's Trainer summary: its mesh and edge strategy, the model
    config, finite losses equal to rank 0's, one checkpoint."""
    run = line["trainer"]
    strategy = "gather" if family == "stgcn" else "ring"
    if (run["mesh"] != [mesh[0], mesh[1], 0]
            or run["config"] != [True, strategy, want_config]):
        fail(f"{label}: mesh {run['mesh']} / config {run['config']}, "
             f"expected {list(mesh)} {strategy} {want_config}")
    if (len(run["losses"]) != steps
            or not np.isfinite(run["losses"]).all()):
        fail(f"{label}: losses {run['losses']}")
    if len(run["saved"]) != 1:
        fail(f"{label}: checkpoints {run['saved']}")


def score_checkpoint(settings: dict, rundir: str, workdir: str,
                     family: str) -> tuple:
    """The run's checkpoint evaluated in this process alone (the edge
    partition off), its scores against the run's: (max |diff| / scale,
    predictions equal, clips); fails outside EDGE_SCORE_GATE or on a
    changed prediction."""
    save = os.path.join(rundir, "save", family)
    name = sorted(os.listdir(save))[0]
    edge_trainer(dict(settings, data=rundir,
                      weights=os.path.join(save, name)), workdir, family,
                 None)
    got, want = scores_file(rundir, family), scores_file(workdir, family)
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    same = int((got.argmax(1) == want.argmax(1)).sum())
    if not gap <= EDGE_SCORE_GATE or same != len(got):
        fail(f"20 {family}: the run's scores vs its checkpoint {name} "
             f"evaluated in one process: max |diff| {gap:.3g} of scale "
             f"(gate {EDGE_SCORE_GATE:g}), predictions equal on {same} of "
             f"{len(got)}")
    return name, gap, same, len(got)


def run_edge_partition(rng, dev, workdir: str, card: str, seed: int,
                       settings: dict = None) -> dict:
    """Phase 20: the edge partition on this card, ranks sharing it over
    gloo (20a ST-GCN's Trainer at EDGE_MESH, 20b its fp32 steps at
    EDGE_STEP_MESHES, 20c the ring-GNN's Trainer and step at RING_MESH,
    20d EDGE_FAULTS against those gates).  Returns the figures for the
    summary."""
    settings = settings or {"device": str(dev), "seed": seed,
                            "batch": EDGE_BATCH, "t": T_WINDOW}
    # the one-process references, fp32 and (ST-GCN) float64
    loss32, _, grads32, one_ms, one_peak = edge_step(settings, "stgcn")
    # float64 on the CPU: the card's train-mode BN takes fp32, bf16, fp16
    grads64 = edge_step(dict(settings, device="cpu"), "stgcn",
                        dtype=torch.float64, timed=False)[2]
    ref = {"loss": loss32, "grads": grads32, "grads64": grads64}
    want_config = repr(edge_model(settings, "stgcn", "cpu").config)

    # 20a, 20b and "edge_adjoint": 4 ranks
    adir = os.path.join(workdir, "a")
    os.makedirs(adir)
    for split, n in (("train", EDGE_STEPS * settings["batch"]),
                     ("val", settings["batch"])):
        write_split(adir, split, *synthetic_batch(rng, n, settings["t"]))
    world = EDGE_MESH[0] * EDGE_MESH[1]
    lines, results = run_ranks("edge", world, adir, dict(settings,
                                                         data=adir),
                               timeout=900)
    texts = {k: [] for k in ("1x4", "2x2")}
    faults = []
    for line, res in zip(lines, results):
        rank = line["rank"]
        check_edge_run(f"20a rank {rank}", line, EDGE_MESH, "stgcn",
                       want_config, EDGE_STEPS)
        if line["trainer"]["losses"] != lines[0]["trainer"]["losses"]:
            fail(f"20a rank {rank}: losses {line['trainer']['losses']} != "
                 f"rank 0's")
        for key in texts:
            r = edge_gates(line[key]["loss"], res[key]["grads"], ref,
                           "stgcn")
            if r["broken"]:
                fail(f"20b {key} rank {rank}: " + "; ".join(r["broken"]))
            texts[key].append(edge_text(r))
        faults.append(edge_gates(line["edge_adjoint"]["loss"],
                                 res["edge_adjoint"]["grads"], ref, "stgcn"))
    odir = os.path.join(workdir, "a_one")
    os.makedirs(odir)
    name, gap, same, clips = score_checkpoint(settings, adir, odir, "stgcn")
    run = lines[0]["trainer"]
    print(f"[edge] 20a: Trainer.start() on {STGCN_CONFIG} (full-width "
          f"ST-GCN, fp32, batch {settings['batch']}, T={settings['t']}) at "
          f"mesh {list(EDGE_MESH)} (gather), {world} gloo ranks sharing "
          f"this card, {EDGE_STEPS} steps + eval + save: losses "
          f"{run['losses']} on every rank, epoch clips/s "
          f"{[round(l['trainer']['clips_per_sec'], 2) for l in lines]}, "
          f"wall s {[round(l['trainer']['wall_s'], 1) for l in lines]}; "
          f"checkpoint {name} evaluated in one process: scores within "
          f"{gap:.3g} of scale (gate {EDGE_SCORE_GATE:g}), predictions "
          f"equal on {same} of {clips} | {card}")
    for key in texts:
        print(f"[edge] 20b: one fp32 step at [{key.replace('x', ', ')}] vs "
              f"one process (loss gate {EDGE_LOSS_TOL:g}; gradients within "
              f"{GRAD_RATIO}x the one process's gap to float64 + "
              f"{GRAD_FLOOR:g}): " + "; ".join(
                  f"rank {r} {t}" for r, t in enumerate(texts[key]))
              + f"; step ms per rank "
              f"{[round(l[key]['step_ms'], 3) for l in lines]} (ranks "
              f"sharing one card, partial sums through host memory: not a "
              f"scaling figure) vs {one_ms:.3f} one process; peak GiB per "
              f"rank {[round(l[key]['peak_gib'], 3) for l in lines]} vs "
              f"{one_peak:.3f} | {card}")

    # 20c and "ring_reverse": 8 ranks
    ring_loss, ring_logits, ring_grads, ring_ms, ring_peak = edge_step(
        settings, "ring")
    ring_ref = {"loss": ring_loss, "grads": ring_grads}
    cdir = os.path.join(workdir, "c")
    os.makedirs(cdir)
    for split, n in (("train", RING_STEPS * settings["batch"]),
                     ("val", settings["batch"])):
        # node-feature clips with a two-class signal, as phase 17's
        labels = rng.integers(0, 2, n)
        data = rng.standard_normal((n, 8, 1, 256, 1)).astype(np.float32)
        data[:, 0] += (labels * 1.5 - 0.75)[:, None, None, None]
        write_split(cdir, split, data, labels)
    ring_world = RING_MESH[0] * RING_MESH[1]
    rlines, rresults = run_ranks("ring", ring_world, cdir,
                                 dict(settings, data=cdir), timeout=600)
    want_ring = repr(edge_model(settings, "ring", "cpu").config)
    ring_texts = []
    for line, res in zip(rlines, rresults):
        rank = line["rank"]
        check_edge_run(f"20c rank {rank}", line, RING_MESH, "ring",
                       want_ring, RING_STEPS)
        if line["trainer"]["losses"] != rlines[0]["trainer"]["losses"]:
            fail(f"20c rank {rank}: losses differ from rank 0's")
        r = edge_gates(line["step"]["loss"], res["step"]["grads"], ring_ref,
                       "ring")
        logits_gap = float(np.abs(res["step"]["logits"] - ring_logits).max()
                           / np.abs(ring_logits).max())
        if logits_gap > RING_TOL:
            r["broken"].append(f"logits at {logits_gap:.3g} (gate "
                               f"{RING_TOL:g})")
        if r["broken"]:
            fail(f"20c rank {rank}: " + "; ".join(r["broken"]))
        ring_texts.append(f"{edge_text(r)}, logits {logits_gap:.3g}")
        faults.append(edge_gates(line["ring_reverse"]["loss"],
                                 res["ring_reverse"]["grads"], ring_ref,
                                 "ring"))
    rodir = os.path.join(workdir, "c_one")
    os.makedirs(rodir)
    rname, rgap, rsame, rclips = score_checkpoint(settings, cdir, rodir,
                                                  "ring")
    rrun = rlines[0]["trainer"]
    print(f"[edge] 20c: Trainer.start() on {RING_CONFIG} (V=256, C=8, "
          f"hidden 32/32, batch {settings['batch']}) at its mesh "
          f"{list(RING_MESH)} (ring), {ring_world} gloo ranks sharing this "
          f"card, {RING_STEPS} steps + eval + save: losses "
          f"{[round(v, 5) for v in rrun['losses']]} on every rank, best acc "
          f"{rrun['best_acc']:.4f}; checkpoint {rname} in one process: "
          f"scores within {rgap:.3g} of scale, predictions equal on "
          f"{rsame} of {rclips}; one fp32 step vs one process (gates "
          f"{RING_TOL:g} of scale): " + "; ".join(
              f"rank {r} {t}" for r, t in enumerate(ring_texts))
          + f"; step ms per rank "
          f"{[round(l['step']['step_ms'], 3) for l in rlines]} (not a "
          f"scaling figure) vs {ring_ms:.4f} one process; peak GiB per "
          f"rank {[round(l['step']['peak_gib'], 4) for l in rlines]} vs "
          f"{ring_peak:.4f} | {card}")

    # 20d: each planted fault outside its gate on some rank
    for fault, readings in (("edge_adjoint", faults[:world]),
                            ("ring_reverse", faults[world:])):
        caught = [r for r, item in enumerate(readings) if item["broken"]]
        if not caught:
            fail(f"20d: the planted fault {fault} passed every gate: "
                 + "; ".join(edge_text(item) for item in readings))
        worst = max(readings, key=lambda item: item["worst"])
        print(f"[edge] 20d planted fault {fault}: caught on ranks {caught} "
              f"of {len(readings)}; {edge_text(worst)}; broken: "
              f"{'; '.join(worst['broken'][:3])} | {card}")
    return {"edge14_ms": [line["1x4"]["step_ms"] for line in lines],
            "edge22_ms": [line["2x2"]["step_ms"] for line in lines],
            "one_ms": one_ms,
            "ring_ms": [line["step"]["step_ms"] for line in rlines],
            "ring_one_ms": ring_ms}


# ---------------------------------------------------------------------------
# Per-unit recomputation, the trace and the NaN check (phase 21)
# ---------------------------------------------------------------------------

REMAT_TRAINER_STEPS = 4  # Trainer steps of 21c
REMAT_TRACE_STEPS = 2    # 21c's profile_steps
# stated before the first run on the card (root PERF.md §6): the peak
# of one train_joint.yaml step (64 clips x T=300) in GiB and its ms, with
# and without remat, and NTU-60's fp32 peak; a cut smaller than half means
# the recomputation keeps activations it should drop, and fails
REMAT_PREDICTION = {"bfloat16": "24.10 -> 3-6 GiB, 181.1 -> 225-255 ms",
                    "float32": "192.3 -> 240-270 ms",
                    "NTU-60": "39.7 -> 6-10 GiB"}
# the five kernels' groups of PROFILE_GROUPS, by the names the trace gives
# their __global__ functions
TRACE_KERNELS = PROFILE_GROUPS[:5]
# weights whose gradient does not repeat its bits from run to run on the
# card: cuDNN's backward-filter algorithm for the stride-2 residual 1x1
# convolutions (l5, l8) adds in no fixed order unless cudnn.deterministic
# is set (two fp32 steps without remat differ there by ~1e-7, every other
# tensor bit-equal; with cudnn.deterministic every tensor repeats:
# scripts/step_repeatability.py).  Phase 21 holds these to STEP_GRAD_TOL
# of scale, and every tensor bit-equal under cudnn.deterministic
NONREPEATING = ("residual.conv.weight",)


def nonrepeating_gap(name: str, got, want, scale) -> float:
    """A NONREPEATING tensor's max |got - want| over ``scale``, its
    gradient's scale (the update's for a parameter); None for another
    tensor."""
    if not name.split(":")[-1].endswith(NONREPEATING):
        return None
    gap = float((got.double() - want.double()).abs().max())
    return gap / max(float(scale), 1e-30)


def remat_step(config, batch, lr: float, dev, seed: int,
               timed: bool = True):
    """One train step of ``config``'s model from the seeded init on
    ``batch``: (loss, every parameter, buffer and momentum buffer after
    SGD, the step's launches, its peak memory in GiB, and the ms of a
    step by CUDA events, timed on after it unless not ``timed``)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import Model
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step

    model = Model(config).init_weights(torch.Generator().manual_seed(seed))
    opt = build_optimizer(model, lr)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    loss = train_step(model, opt, batch, lr)[0].clone()
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    after = {k: v.clone() for k, v in model.state_dict().items()}
    after.update({f"momentum:{n}": opt.state[p]["momentum_buffer"].clone()
                  for n, p in model.named_parameters()})
    ms = (time_ms(lambda: train_step(model, opt, batch, lr), iters=2,
                  reps=3) if timed else None)
    del model, opt
    torch.cuda.empty_cache()
    return loss, after, launches, peak, ms


def remat_pair(config, batch, lr: float, dev, seed: int, label: str,
               card: str) -> dict:
    """21a / 21b: the step of ``config`` without and with ``remat`` from
    one seeded state and batch: the loss and every tensor of the state
    after SGD bit-equal but the NONREPEATING ones (STEP_GRAD_TOL of
    scale), and every tensor bit-equal under cudnn.deterministic; the
    launches PER_STEP and REMAT_STEP; the peak with remat at most half
    the peak without.  Returns the peaks and times."""
    runs = {remat: remat_step(dataclasses.replace(config, remat=remat),
                              batch, lr, dev, seed)
            for remat in (False, True)}
    (loss0, after0, launches0, peak0, ms0) = runs[False]
    (loss1, after1, launches1, peak1, ms1) = runs[True]
    differ = [k for k, v in after0.items() if not torch.equal(after1[k], v)]
    loose = {}
    for k in differ:
        name = k.split(":")[-1]
        buf = after0[f"momentum:{name}"] if f"momentum:{name}" in after0 \
            else None
        # a parameter moves by lr (1 + momentum) times its first gradient
        scale = None if buf is None else float(buf.abs().max()) * (
            1.0 if k.startswith("momentum:") else lr * 1.9)
        gap = (None if scale is None
               else nonrepeating_gap(k, after1[k], after0[k], scale))
        if gap is None or not gap <= STEP_GRAD_TOL:
            fail(f"21 {label}: the step with remat is not the step without "
                 f"it at {k} ({gap if gap is not None else 'bits'} of "
                 f"scale; differing: {differ[:6]})")
        loose[k] = gap
    if not torch.equal(loss0, loss1):
        fail(f"21 {label}: loss {float(loss1)!r} with remat vs "
             f"{float(loss0)!r}")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exact = [remat_step(dataclasses.replace(config, remat=remat), batch,
                            lr, dev, seed, timed=False)
                 for remat in (False, True)]
    finally:
        torch.backends.cudnn.deterministic = saved
    differ = [k for k, v in exact[0][1].items()
              if not torch.equal(exact[1][1][k], v)]
    if differ or not torch.equal(exact[0][0], exact[1][0]):
        fail(f"21 {label}: under cudnn.deterministic the step with remat "
             f"differs from the one without at {differ[:6]}")
    if launches0 != PER_STEP or launches1 != REMAT_STEP:
        fail(f"21 {label}: launches {launches0} / with remat {launches1} "
             f"!= {PER_STEP} / {REMAT_STEP}")
    if not peak1 <= 0.5 * peak0:
        fail(f"21 {label}: peak {peak1:.2f} GiB with remat against "
             f"{peak0:.2f} without: the recomputation keeps activations")
    print(f"[remat] {label}: one step from one seeded state and batch, "
          f"without / with remat: loss {float(loss0):.7f} bit-equal; of "
          f"the {len(after0)} parameters, buffers and momentum buffers "
          f"after SGD {len(after0) - len(loose)} bit-equal and "
          f"{len(loose)} of cuDNN's stride-2 backward-filter (not "
          f"repeatable run to run) within "
          f"{max(loose.values(), default=0.0):.3g} of scale (gate "
          f"{STEP_GRAD_TOL:g}); under cudnn.deterministic all "
          f"{len(after0)} bit-equal; launches {launches0} / {launches1}; "
          f"peak {peak0:.3f} -> {peak1:.3f} GiB, step {ms0:.2f} -> "
          f"{ms1:.2f} ms (CUDA events; predicted "
          f"{REMAT_PREDICTION.get(label.split()[-1], 'n/a')}) | {card}")
    return {"peak": (peak0, peak1), "ms": (ms0, ms1)}


def trace_kernels(trace_dir: str):
    """The one trace file under ``trace_dir``: its name, its ProfilerStep
    spans, and per kernel of TRACE_KERNELS (the events of its functions,
    their device ms)."""
    files = os.listdir(trace_dir)
    if len(files) != 1 or not files[0].startswith("rank0."):
        fail(f"21c: trace files {files}, expected one rank0.*")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    # a step's span is on the host and, on a card, again on the device
    steps = sorted({e["name"] for e in events
                    if str(e.get("name", "")).startswith("ProfilerStep#")})
    found = {}
    for group, marks in TRACE_KERNELS:
        hits = [e for e in events if e.get("cat") == "kernel"
                and any(m in e.get("name", "") for m in marks)]
        found[group] = (len(hits),
                        sum(e.get("dur", 0.0) for e in hits) / 1e3)
    return files[0], steps, found


def run_remat(rng, dev, workdir: str, card: str, seed: int) -> dict:
    """Phase 21 (21e runs inside phase 18): 21a/21b the step with and
    without remat, train_joint.yaml in fp32 and bf16 and NTU-60 in fp32;
    21c ``Trainer.start()`` with remat and a trace of its first steps;
    21d ``debug_nans`` catching a planted NaN.  Returns the figures for
    the summary."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args
    from shift_gcn_torch.train.config import load_config
    from shift_gcn_torch.train.trainer import Trainer

    out = {}
    base = load_config(["--config", TRAIN_CONFIG])
    config = config_from_reference_args(base.model_args)
    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = remat_pair(
            dataclasses.replace(config, activation_dtype=None if dtype ==
                                "float32" else dtype), batch, base.base_lr,
            dev, seed, f"21a {TRAIN_CONFIG} {dtype}", card)
    ntu = load_config(["--config", NTU60_CONFIG])
    config = config_from_reference_args(ntu.model_args)
    data, labels = ntu_clips(rng, ntu.batch_size, T_WINDOW,
                             config.num_point, config.num_person, 60)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    out["NTU-60"] = remat_pair(config, batch, ntu.base_lr, dev, seed,
                               f"21b {NTU60_CONFIG} NTU-60", card)
    del batch
    torch.cuda.empty_cache()

    # 21c: the Trainer with remat, its first steps traced
    feeder_args = {split: write_split(workdir, split, *synthetic_batch(
        rng, n, T_WINDOW)) for split, n in (
            ("train", REMAT_TRAINER_STEPS * N_WINDOWS), ("val", N_WINDOWS))}
    trace_dir = os.path.join(workdir, "trace")
    trainer = Trainer(one_epoch_config(
        TRAIN_CONFIG, workdir, feeder_args, "--remat", "true",
        "--profile_dir", trace_dir, "--profile_steps",
        str(REMAT_TRACE_STEPS)))
    if not trainer.model.config.remat:
        fail("21c: the Trainer's model does not recompute")
    epochs = record_epochs(trainer)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    expect = {k: REMAT_STEP[k] * REMAT_TRAINER_STEPS
              + PER_EVAL_FORWARD.get(k, 0) for k in REMAT_STEP}
    losses = epochs[0]["losses"]
    if launches != expect or len(losses) != REMAT_TRAINER_STEPS or (
            not np.isfinite(losses).all()):
        fail(f"21c: launches {launches} != {expect}, or losses {losses}")
    with open(os.path.join(trainer.work_dir, "log.txt")) as f:
        logged = sum("Profiler trace written to" in line for line in f)
    name, steps, found = trace_kernels(trace_dir)
    if logged != 1 or steps != [f"ProfilerStep#{i}"
                                for i in range(REMAT_TRACE_STEPS)]:
        fail(f"21c: {logged} trace log lines, steps {steps}")
    missing = [g for g, (n, _) in found.items() if n == 0]
    if missing:
        fail(f"21c: the trace names no kernel of {missing}")
    # K1 is one function, one event a launch: no more than the traced
    # steps launch (after phases 1-20 the trace has held 39 of the 40 K4
    # launches, phase 21 alone all 40: a missed event is not a fault of
    # the port)
    k1 = found[TRACE_KERNELS[0][0]][0]
    if not k1 <= REMAT_TRACE_STEPS * REMAT_STEP["temporal_shift"]:
        fail(f"21c: {k1} K1 launches in the trace of {REMAT_TRACE_STEPS} "
             "steps")
    print(f"[remat] 21c: Trainer.start() on {TRAIN_CONFIG} with remat, "
          f"profile_dir and profile_steps {REMAT_TRACE_STEPS}: "
          f"{REMAT_TRAINER_STEPS} steps + eval + save in {wall:.1f} s, "
          f"losses {[round(v, 4) for v in losses]}, launches {launches}; "
          f"trace {name} of {steps}: "
          + ", ".join(f"{g} x{n} {ms:.3f} ms" for g, (n, ms)
                      in found.items())
          + f" of device time | {card}")
    del trainer
    torch.cuda.empty_cache()

    # 21d: debug_nans names the module a planted NaN reaches first
    ddir = os.path.join(workdir, "nans")
    os.makedirs(ddir)
    feeder_args = {split: write_split(ddir, split, *synthetic_batch(
        rng, n, T_WINDOW)) for split, n in (("train", 2 * N_WINDOWS),
                                            ("val", N_WINDOWS))}
    trainer = Trainer(one_epoch_config(TRAIN_CONFIG, ddir, feeder_args,
                                       "--debug_nans", "true"))
    epochs = record_epochs(trainer)
    trainer.start()
    if not np.isfinite(epochs[0]["losses"]).all():
        fail(f"21d: the clean run's losses {epochs[0]['losses']}")
    data, labels = synthetic_batch(rng, N_WINDOWS, T_WINDOW)
    data[1, 0, T_WINDOW // 2, 3, 0] = np.nan
    try:
        trainer._train_step({"data": torch.from_numpy(data).to(dev),
                             "label": torch.from_numpy(labels).to(dev)},
                            base.base_lr)
        fail("21d: the planted NaN raised nothing")
    except FloatingPointError as err:
        if "data_bn" not in str(err):
            fail(f"21d: the planted NaN raised {err!r}, not at data_bn")
        caught = str(err)
    print(f"[remat] 21d: debug_nans on {TRAIN_CONFIG}: the clean run trains "
          f"(losses {[round(v, 4) for v in epochs[0]['losses']]}, "
          f"{epochs[0]['clips_per_sec']:.1f} clips/s with the hooks), one "
          f"NaN planted in a batch raises FloatingPointError: {caught} | "
          f"{card}")
    del trainer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Custom topologies and any joint count (phase 22)
# ---------------------------------------------------------------------------

# MediaPipe Holistic's landmarks: 33 pose, 468 face, 2 x 21 hand
HOLISTIC_V = 543
# 22a's registered topologies: (name, joints), seeded trees
TREE_GRAPHS = (("holistic_tree", HOLISTIC_V), ("tree256", 256))
WIDE_JOINTS = (145, 256, HOLISTIC_V)  # past K4/K5's 144-row frame tile
WIDE_CLIPS = 8           # 22b's clips a launch shape (x T)
WIDE_STEP_CLIPS = 4      # 22c's fp32 step
WIDE_STEPS = 4           # Trainer steps of 22d
# 22d: the largest batch of these whose bf16 step's peak stays under
# WIDE_MEMORY_SHARE of the card's memory (room for the Trainer's
# prefetched batch and eval beside the step)
WIDE_BATCHES = (16, 12, 8)
WIDE_MEMORY_SHARE = 0.85
# 22d's estimate, written before the first run on the card: the bf16
# step at 64 clips of 33 joints peaked at 24 GiB (phase 21); scaled by
# 543 / 33 and 8 / 64
WIDE_PREDICTION = "batch 8: ~49 GiB without remat"
# 22f: K4, K5 and K6 at V = 25 and 33 (whole-frame tiles), each unit's
# (T, C, D) at V144_CLIPS clips, fp32 and bf16, at each of V144_D0, on
# seeded inputs; their digests from the parent commit's build of
# csrc/shift_gcn.cu, written by scripts/shift_gcn_bitcheck.py
V144_JOINTS = (25, 33)
V144_CLIPS = 4
V144_D0 = (0, 32)
V144_DIGESTS = "scripts/shift_gcn_v144_digests.json"


def tree_graph(name: str, v: int, seed: int):
    """A SkeletonGraph over v joints from ``seed``: a tree rooted at joint
    0, each other joint hanging from a random earlier one, so that every
    joint has a bone."""
    from shift_gcn_torch.graphs import SkeletonGraph

    rng = np.random.default_rng(seed)
    parents = [0] + [int(rng.integers(0, i)) for i in range(1, v)]
    edges = tuple((i, parents[i]) for i in range(1, v))
    return SkeletonGraph(name=name, num_nodes=v, inward=edges,
                         bone_pairs=((0, 0),) + edges, center_joint=(0,),
                         zaxis=(0, 1), xaxis=(1, 2))


def backbone_shapes():
    """The default backbone's K4 launch shapes (T, C, D) at T_WINDOW, one
    each."""
    from shift_gcn_torch.models.shift_gcn import ModelConfig

    return sorted(set(forward_shapes(ModelConfig(num_class=2),
                                     T_WINDOW)[1]))


def new_kernels(x, g, gate, w, b, d0=0):
    """(K4 out, K5 dx, K6 (dgate, dW, dbias)) of this checkout."""
    from shift_gcn_torch.ops import shift_gcn_kernel as sk

    return (sk.shift_gcn_forward(x, gate, w, b, d0),
            sk.shift_gcn_dx(g, gate, w, d0),
            sk.shift_gcn_wgrad(x, g, gate, w, d0))


def flat_outputs(outs) -> dict:
    out, dx, (dgate, dw, dbias) = outs
    return {"K4": out, "K5": dx, "K6 dgate": dgate, "K6 dW": dw,
            "K6 dbias": dbias}


def v144_digests(run, dev) -> dict:
    """{case and output: sha256 of its bytes} of ``run(x, g, gate, w, b,
    d0)`` (``new_kernels``' outputs) at 22f's cases, inputs drawn with
    numpy from one seed."""
    import hashlib

    def digest(t: torch.Tensor) -> str:
        raw = t.detach().contiguous().cpu().view(torch.uint8).numpy()
        return hashlib.sha256(raw.tobytes()).hexdigest()[:32]

    rng = np.random.default_rng(144)
    digests = {}
    for v in V144_JOINTS:
        for t, c, d in backbone_shapes():
            r = V144_CLIPS * t
            f32 = np.float32
            x, g, gate, w, b = (torch.from_numpy(a).to(dev) for a in (
                rng.standard_normal((r, v, c), f32),
                rng.standard_normal((r, v, d), f32),
                np.tanh(rng.standard_normal((v, c), f32)) + f32(1),
                rng.standard_normal((c, d), f32) * f32(d ** -0.5),
                rng.standard_normal(d, f32) * f32(0.1)))
            for dtype in (torch.float32, torch.bfloat16):
                for d0 in V144_D0:
                    outs = flat_outputs(run(x.to(dtype), g.to(dtype), gate,
                                            w, b, d0))
                    for name, out in outs.items():
                        digests[f"V={v} T={t} C={c} D={d} {str(dtype)[6:]} "
                                f"d0={d0} {name}"] = digest(out)
    torch.cuda.synchronize()
    return digests


def check_wide_kernels(v: int, gen, rng, dev) -> dict:
    """22b: every kernel against its plain version at V=v, fp32 and bf16,
    at each launch shape of the default backbone with WIDE_CLIPS clips:
    K1 bit-equal and the fused K2+K3 within phase 7's gates, at ypos
    U(-7, 7) with +-20.3 and +-7.4 (taps far outside any staged window);
    K4 and K5 within phase 4's gates (2e-5 of scale, 2^-7 in bf16) and K6
    within phase 7's, each at d0 = 0 and d0 = D (a rank's slice of a layer
    twice as wide), K6 bit-equal across two launches; and phases 3 and
    7's odd cases: C=130 with an odd T (1-element lanes), an input one
    element into its storage (unaligned), and for K4-K6 C=130, D=70.  K6's
    shared memory at V as the library reckons it must be
    ``wgrad_layout``'s, which the CPU tests hold to fit.  Returns the fp32
    max |err| per kernel."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import ModelConfig
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts

    n = WIDE_CLIPS
    k1_shapes = sorted(set(forward_shapes(
        ModelConfig(num_class=2, num_point=v), T_WINDOW)[0]))
    k1_cases = [(shape, "far") for shape in k1_shapes] + [
        ((T_WINDOW // 4, 130, 2), "C=130"),
        ((T_WINDOW // 4, 128, 1), "unaligned")]
    k4_cases = [(shape, "aligned") for shape in backbone_shapes()] + [
        ((T_WINDOW // 4, 130, 70), "odd"),
        ((T_WINDOW // 4, 64, 128), "unaligned")]

    def unaligned(t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t.view(-1))
        return buf[1:].view(t.shape)

    errs = {name: 0.0 for name in KERNEL_ROWS}
    for dtype in (torch.float32, torch.bfloat16):
        name = f"V={v} {str(dtype)[6:]}"
        worst = {k: 0.0 for k in KERNEL_ROWS}
        layout = sk.wgrad_layout(v, dtype.itemsize)
        smem = kernels.library("shift_gcn").shift_gcn_wgrad_smem(
            v, int(dtype == torch.bfloat16))
        if smem != layout["smem"]:
            fail(f"22b K6 {name}: the library's shared memory {smem} B != "
                 f"wgrad_layout's {layout}")
        for (t, c, stride), kind in k1_cases:
            x = torch.randn(n, t, v, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(n, t // stride, v, c, generator=gen,
                            device=dev).to(dtype)
            if kind == "unaligned":
                x, g = unaligned(x), unaligned(g)
            ypos = torch.from_numpy(shift_positions(rng, c, "far")).to(dev)
            got = ts.temporal_shift(x, ypos, stride)
            want = ts.temporal_shift_reference(x, ypos, stride)
            torch.cuda.synchronize()
            err, _ = max_err(got, want)
            if not torch.equal(got, want):
                fail(f"22b K1 {name} T={t} C={c} s={stride} {kind}: max|err| "
                     f"{err:.3g}, not bit-equal")
            worst["temporal_shift"] = max(worst["temporal_shift"], err)
            dx_err, gy_err, _ = check_fused_backward(
                x, g, ypos, stride, f"22b {name} T={t} C={c} s={stride} "
                f"{kind}")
            worst["temporal_shift_backward"] = max(
                worst["temporal_shift_backward"], dx_err, gy_err)
            del x, g, got, want
        tol = 2e-5 if dtype == torch.float32 else 2 ** -7
        for (t, c, d), kind in k4_cases:
            r = n * t
            x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(r, v, d, generator=gen, device=dev).to(dtype)
            if kind == "unaligned":
                x, g = unaligned(x), unaligned(g)
            gate = torch.tanh(torch.randn(v, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            b = torch.randn(d, generator=gen, device=dev) * 0.1
            for d0 in (0, d):
                label = f"22b {name} T={t} C={c} D={d} d0={d0} {kind}"
                for kernel, got, want in (
                        ("shift_gcn", sk.shift_gcn_forward(x, gate, w, b, d0),
                         ss.shift_gcn_transform(x, gate, w, b, d0)),
                        ("shift_gcn_dx", sk.shift_gcn_dx(g, gate, w, d0),
                         ss.shift_gcn_dx_reference(g, gate, w, d0))):
                    err, scale = max_err(got, want)
                    if not err <= tol * scale:
                        fail(f"{label} {kernel}: max|err| {err:.3g} > "
                             f"{tol * scale:.3g}")
                    worst[kernel] = max(worst[kernel], err)
                err, _ = check_wgrad(x, g, gate, w, label, d0)
                worst["shift_gcn_wgrad"] = max(worst["shift_gcn_wgrad"], err)
            del x, g
        torch.cuda.empty_cache()
        print(f"[wide] 22b V={v} {str(dtype)[6:]}: K1 bit-equal and the "
              f"fused K2+K3 within phase 7's gates at {len(k1_cases)} "
              f"shapes (T, C, s) {[c_ for c_, _ in k1_cases]} with far "
              f"shifts; K4, K5 and K6 at {len(k4_cases)} shapes (T, C, D) "
              f"{[c_ for c_, _ in k4_cases]} x d0 in (0, D), {n} clips: "
              "max|err| " + ", ".join(f"{k} {e:.3g}" for k, e in
                                      worst.items())
              + f"; K6 bit-equal across two launches, {layout['groups']} "
              f"joint groups of {layout['joints']}, {layout['rows']} rows "
              f"of {layout['width']} channels a staged frame, "
              f"{layout['smem']} B of shared memory")
        if dtype == torch.float32:
            errs = worst
    return errs


def wide_graph_trainer(rng, dev, workdir: str, graph, card: str):
    """22d: ``Trainer.start()`` on TRAIN_CONFIG with its graph replaced
    by ``graph`` (registered) and the default backbone, bf16, at the
    largest batch of WIDE_BATCHES whose step fits: WIDE_STEPS steps, eval
    and save.  Returns (launches, batch, peak GiB, step ms)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import (
        Model, config_from_reference_args)
    from shift_gcn_torch.train.config import load_config
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils.checkpoint import latest_checkpoint

    base = load_config(["--config", TRAIN_CONFIG])
    model_args = {k: val for k, val in base.model_args.items()
                  if k != "num_point"}
    model_args["graph"] = graph.name
    config = dataclasses.replace(config_from_reference_args(model_args),
                                 activation_dtype=base.activation_dtype)
    v = graph.num_nodes
    if (config.num_point, config.activation_dtype) != (v, "bfloat16"):
        fail(f"22d: the config resolves {config.num_point} joints in "
             f"{config.activation_dtype}, not {v} in bf16")
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    batch_size = peak = step_ms = None
    for b in WIDE_BATCHES:
        model = Model(config).init_weights(torch.Generator().manual_seed(0))
        opt = build_optimizer(model, base.base_lr)
        data, labels = synthetic_batch(rng, b, T_WINDOW, v)
        batch = {"data": torch.from_numpy(data).to(dev),
                 "label": torch.from_numpy(labels).to(dev)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            train_step(model, opt, batch, base.base_lr)
            torch.cuda.synchronize()
            got = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if got <= WIDE_MEMORY_SHARE * total:
                peak = got
                step_ms = time_ms(lambda: train_step(model, opt, batch,
                                                     base.base_lr),
                                  iters=2, reps=3)
        except torch.cuda.OutOfMemoryError:
            got = None
        del model, opt, batch
        torch.cuda.empty_cache()
        if peak is not None:
            batch_size = b
            break
        print(f"[wide] 22d: batch {b} does not fit (step peak "
              f"{'out of memory' if got is None else f'{got:.2f} GiB'} of "
              f"{total:.1f}) | {card}")
    if batch_size is None:
        fail(f"22d: no batch of {WIDE_BATCHES} fits at V={v}")

    feeder_args = {split: write_split(workdir, split, *synthetic_batch(
        rng, count, T_WINDOW, v)) for split, count in (
            ("train", WIDE_STEPS * batch_size), ("val", batch_size))}
    cfg = one_epoch_config(TRAIN_CONFIG, workdir, feeder_args,
                           "--model_args", json.dumps(model_args),
                           "--batch_size", str(batch_size),
                           "--test_batch_size", str(batch_size))
    trainer = Trainer(cfg)
    if trainer.model_config.num_point != v:
        fail(f"22d: the Trainer built {trainer.model_config.num_point} "
             f"joints, not {v}")
    epochs = record_epochs(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    best = trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    run_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    expect = {k: PER_STEP[k] * WIDE_STEPS + PER_EVAL_FORWARD.get(k, 0)
              for k in PER_STEP}
    if launches != expect:
        fail(f"22d: launch counts {launches} != expected {expect}")
    losses = epochs[0]["losses"]
    if len(losses) != WIDE_STEPS or not np.isfinite(losses).all():
        fail(f"22d: train losses {losses}")
    eval_dir = os.path.join(trainer.work_dir, "eval_results")
    ckpt = latest_checkpoint(trainer.save_dir)
    if ckpt is None or not os.path.exists(os.path.join(eval_dir,
                                                       "best_acc.pkl")):
        fail("22d: the run left no checkpoint or best_acc.pkl")
    with open(os.path.join(eval_dir, "best_acc.pkl"), "rb") as f:
        scores = pickle.load(f)
    if len(scores) != batch_size or any(
            s.shape != (2,) or not np.isfinite(s).all()
            for s in scores.values()):
        fail("22d: scores are not finite 2-class rows per clip")
    print(f"[wide] 22d: Trainer.start() on {TRAIN_CONFIG} with graph "
          f"{graph.name!r} (V={v}, registered), the default backbone, "
          f"bf16, batch {batch_size}, T={T_WINDOW}: {WIDE_STEPS} steps + "
          f"1 eval batch + save in {wall:.1f} s, losses "
          f"{[round(x, 4) for x in losses]}, best acc {best:.4f}, "
          f"checkpoint {os.path.basename(ckpt)}; launches {launches} = per "
          f"step {PER_STEP} x {WIDE_STEPS} + per eval forward "
          f"{PER_EVAL_FORWARD}; a step {step_ms:.3f} ms "
          f"({batch_size / step_ms * 1e3:.1f} clips/s), step peak "
          f"{peak:.2f} GiB, the run's peak {run_peak:.2f} GiB of "
          f"{total:.1f} (predicted {WIDE_PREDICTION}) | {card}")
    del trainer
    torch.cuda.empty_cache()
    return launches, batch_size, run_peak, step_ms


def build_parent(source: str):
    """The library of another build of csrc/shift_gcn.cu (an earlier
    commit's, with this checkout's C interface), compiled with the same
    flags into the build directory."""
    import ctypes

    from shift_gcn_torch import kernels

    out = kernels.BUILD_DIR / "libshift_gcn_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    source], check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    kernels._declare("shift_gcn", lib)
    return lib


def parent_wgrad(lib, x, g, gate, w):
    """K6 of the build ``lib`` with the split it was built for: about one
    wave at every V (``wgrad_wave_split``)."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.ops import shift_gcn_kernel as sk

    r, v, c = x.shape
    d = w.shape[1]
    parts, chunk = sk.wgrad_wave_split(r, v, c, d)
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, 0, parts, chunk)
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    out = (torch.empty((v, c), device=x.device),
           torch.empty((c, d), device=x.device),
           torch.empty(d, device=x.device))
    kernels.check(lib.shift_gcn_wgrad(
        x.data_ptr(), g.data_ptr(), gate.data_ptr(), w.data_ptr(),
        partial.data_ptr(), scratch, *(t.data_ptr() for t in out), r, v, c,
        d, 0, parts, chunk, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream), "parent shift_gcn_wgrad")
    return out


def time_wide_kernels(v: int, n: int, gen, rng, dev, card: str,
                      parent=None) -> dict:
    """22e: each kernel at V=v over one train step's launches (the K1 and
    K4 of a forward, the backward kernels of a step) with n clips, fp32:
    kernel, plain version, bound and library call, as phases 6 and 10.
    K6 also on bf16 inputs (bound at the bf16 rate), with the bytes its
    blocks stage from L2 (``wgrad_staged_bytes``), and beside the build
    ``parent`` (``build_parent``; its staging reckoned as the window of
    joints + 31 rows), timed in the rounds parent, this, this, parent.
    Returns {kernel: (ms, plain, bound, library, bytes_ms, ops_ms)}."""
    from shift_gcn_torch.models.shift_gcn import ModelConfig
    from shift_gcn_torch.ops import shift_gcn_kernel as sk
    from shift_gcn_torch.ops import spatial_shift as ss
    from shift_gcn_torch.ops import temporal_shift as ts

    k1_shapes, k4_shapes = forward_shapes(
        ModelConfig(num_class=2, num_point=v), T_WINDOW)
    totals = {k: [0.0] * 6 for k in KERNEL_ROWS}
    # K6 by input dtype: this build, the parent's, plain, library, bound,
    # staged GB of this build and of the parent's
    k6 = {dtype: [0.0] * 7 for dtype in (torch.float32, torch.bfloat16)}

    def add(kernel, count, ms, plain, lib, cost):
        for i, val in enumerate((ms, plain, max(cost), lib) + cost):
            totals[kernel][i] += count * val

    def timed(fn):
        return time_ms(fn, iters=3, reps=3)

    for t, c, stride in sorted(set(k1_shapes)):
        count = k1_shapes.count((t, c, stride))
        x = torch.randn(n, t, v, c, generator=gen, device=dev)
        g = torch.randn(n, t // stride, v, c, generator=gen, device=dev)
        ypos = torch.from_numpy(
            rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
        lib1 = shift_conv_library(x, ypos, stride)
        lib2 = shift_conv_transpose_library(g, ypos, stride, t)
        lib3 = position_grad_library(x, g, ypos, stride)
        add("temporal_shift", count,
            timed(lambda: ts.temporal_shift(x, ypos, stride)),
            timed(lambda: ts.temporal_shift_reference(x, ypos, stride)),
            timed(lib1), k1_cost_ms(n, t, c, stride, v=v))
        add("temporal_shift_backward", count,
            timed(lambda: ts.temporal_shift_backward(x, g, ypos, stride)),
            timed(lambda: ts.temporal_shift_backward_reference(
                x, g, ypos, stride)), timed(lib2) + timed(lib3),
            k23_cost_ms(n, t, c, stride, v=v))
        del x, g
    for t, c, d in sorted(set(k4_shapes)):
        count = k4_shapes.count((t, c, d))
        r = n * t
        x = torch.randn(r, v, c, generator=gen, device=dev)
        g = torch.randn(r, v, d, generator=gen, device=dev)
        gate = torch.tanh(torch.randn(v, c, generator=gen, device=dev)) + 1
        w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
        b = torch.randn(d, generator=gen, device=dev) * 0.1
        wt = w.t().contiguous()
        shear = {(ch, sign): torch.from_numpy(ss.flat_shift_index(
            v, ch, sign)).to(dev) for ch in (c, d) for sign in (1, -1)}

        def lib4():
            h = x.view(r, v * c).index_select(1, shear[c, 1]).view(r, v, c)
            z = torch.matmul(h * gate, w) + b
            return z.view(r, v * d).index_select(1, shear[d, -1]).view(
                r, v, d)

        def lib5():
            gz = g.view(r, v * d).index_select(1, shear[d, 1]).view(r, v, d)
            dh = torch.matmul(gz, wt) * gate
            return dh.view(r, v * c).index_select(1, shear[c, -1]).view(
                r, v, c)

        def lib6(xx=x, gg=g):
            # two index_select shears into fp32, one per-joint fp32 bmm,
            # three reductions
            sx = xx.view(r, v * c).index_select(1, shear[c, 1]).view(
                r, v, c).float()
            gz = gg.view(r, v * d).index_select(1, shear[d, 1]).view(
                r, v, d).float()
            m = torch.bmm(sx.permute(1, 2, 0), gz.permute(1, 0, 2))
            return ((m * w[None]).sum(-1), (m * gate[:, :, None]).sum(0),
                    gz.sum((0, 1)))

        for got, want in ((lib4(), ss.shift_gcn_transform(x, gate, w, b)),
                          (lib5(), ss.shift_gcn_dx_reference(g, gate, w))
                          ) + tuple(zip(lib6(), ss.shift_gcn_wgrad_reference(
                              x, g, gate, w))):
            err, scale = max_err(got, want)
            if not err <= 1e-4 * scale:
                fail(f"22e V={v}: a library yardstick disagrees "
                     f"({err:.3g})")
        add("shift_gcn", count,
            timed(lambda: sk.shift_gcn_forward(x, gate, w, b)),
            timed(lambda: ss.shift_gcn_transform(x, gate, w, b)),
            timed(lib4), k4_cost_ms(r, c, d, v=v))
        add("shift_gcn_dx", count,
            timed(lambda: sk.shift_gcn_dx(g, gate, w)),
            timed(lambda: ss.shift_gcn_dx_reference(g, gate, w)),
            timed(lib5), k4_cost_ms(r, d, c, v=v))
        add("shift_gcn_wgrad", count,
            timed(lambda: sk.shift_gcn_wgrad(x, g, gate, w)),
            timed(lambda: ss.shift_gcn_wgrad_reference(x, g, gate, w)),
            timed(lib6), k6_cost_ms(r, c, d, v=v))
        for dtype, acc in k6.items():
            xx, gg = x.to(dtype), g.to(dtype)
            builds = {} if parent is None else {
                "parent": lambda: parent_wgrad(parent, xx, gg, gate, w)}
            builds["this"] = lambda: sk.shift_gcn_wgrad(xx, gg, gate, w)
            ms = dict.fromkeys(builds, 0.0)
            for build in list(builds) + list(builds)[::-1]:
                ms[build] += timed(builds[build]) / 2
            itemsize = dtype.itemsize
            rate = TF32_3X_FLOPS if itemsize == 4 else BF16_FLOPS
            for i, val in enumerate((
                    ms["this"], ms.get("parent", 0.0),
                    timed(lambda: ss.shift_gcn_wgrad_reference(
                        xx, gg, gate, w)),
                    timed(lambda: lib6(xx, gg)),
                    max(k6_cost_ms(r, c, d, itemsize, rate, v=v)),
                    sk.wgrad_staged_bytes(r, v, c, d, itemsize) / 1e9,
                    sk.wgrad_staged_bytes(r, v, c, d, itemsize, False)
                    / 1e9)):
                acc[i] += count * val
            del xx, gg
        del x, g
    torch.cuda.empty_cache()
    for kernel, (ms, plain, bound, lib, bytes_ms, ops_ms) in totals.items():
        by = "operations" if ops_ms > bytes_ms else "bytes"
        print(f"[wide] 22e {kernel} at V={v}, a step's launches with {n} "
              f"clips x T={T_WINDOW}, fp32: {ms:.4f} ms, "
              f"{100 * bound / ms:.0f}% of bound {bound:.4f} by {by} "
              f"(plain {plain:.4f}, library {lib:.4f}) | {card}")
    for dtype, (ms, old, plain, lib, bound, staged, staged_old) in (
            k6.items()):
        was = (f"{old:.4f} ms" if parent is not None
               else "not measured (no --k6-parent)")
        print(f"[wide] 22e K6 at V={v}, {str(dtype)[6:]} inputs, a step's "
              f"launches with {n} clips: this build {ms:.4f} ms staging "
              f"{staged:.4g} GB from L2, the parent build {was} staging "
              f"{staged_old:.4g} GB; plain {plain:.4f}, library {lib:.4f}, "
              f"bound {bound:.4f} ({100 * bound / ms:.0f}%) | {card}")
    return totals


def run_wide(rng, gen, dev, workdir: str, card: str, seed: int,
             parent=None) -> dict:
    """Phase 22: 22a topologies registered through ``register_graph``;
    22b each kernel against its plain version at V = 145, 256 and 543;
    22c one fp32 train step at V=543, kernel path vs the plain backward;
    22d ``Trainer.start()`` on the registered 543-joint graph; 22e the
    kernels' times at V=543 beside their bounds (K6 beside the library
    ``parent``, another build of csrc/shift_gcn.cu, where given); 22f K4,
    K5 and K6 at V = 25 and 33 bit-equal to the parent commit's build.
    Returns the figures for the kernels line and the summary."""
    from shift_gcn_torch import graphs
    from shift_gcn_torch.models.shift_gcn import (
        ModelConfig, config_from_reference_args)

    # 22a: the topologies, registered and resolved by name
    trees = {}
    for i, (name, v) in enumerate(TREE_GRAPHS):
        graph = tree_graph(name, v, seed + i)
        graphs.register_graph(graph)
        parents = graphs.get_graph(name).bone_parents()
        cfg = config_from_reference_args({"graph": name, "num_class": 2,
                                          "num_person": 1})
        if (graphs.get_graph(name) is not graph or cfg.num_point != v
                or parents[0] != 0
                or not (parents[1:] < np.arange(1, v)).all()):
            fail(f"22a: {name} does not resolve as registered")
        trees[v] = graph
    print(f"[wide] 22a: registered {[(n, v) for n, v in TREE_GRAPHS]} "
          "(seeded trees rooted at joint 0); each resolves by name through "
          "get_graph and config_from_reference_args, every joint a bone")

    # 22b: the kernels against their plain versions past the frame tile
    errs = {}
    for v in WIDE_JOINTS:
        for kernel, err in check_wide_kernels(v, gen, rng, dev).items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)

    # 22c: one fp32 step at V=543 against the plain backward
    big = trees[HOLISTIC_V]
    config = ModelConfig(num_class=2, num_point=HOLISTIC_V, num_person=1,
                         graph=big.name)
    grad_gap, gy_ratio = check_train_step(
        config, rng, dev, seed, label=f"22c fp32 V={HOLISTIC_V}",
        clips=WIDE_STEP_CLIPS)

    # 22d: the Trainer on the registered graph
    launches, batch, peak, step_ms = wide_graph_trainer(
        rng, dev, workdir, big, card)

    # 22e: the kernels' times at the Trainer's shapes
    totals = time_wide_kernels(HOLISTIC_V, batch, gen, rng, dev, card,
                               parent)

    # 22f: the whole-frame tiles, bit for bit the parent's build
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           V144_DIGESTS)) as f:
        want = json.load(f)
    got = v144_digests(new_kernels, dev)
    differ = [k for k in want if got.get(k) != want[k]]
    if differ or set(got) != set(want):
        fail(f"22f: {len(differ)} of {len(want)} outputs at V <= 144 not "
             f"bit-equal to the parent's build, first {differ[:4]}")
    print(f"[wide] 22f: K4, K5 and K6 at V {V144_JOINTS} ({len(want)} "
          f"outputs: each unit's (T, C, D) at {V144_CLIPS} clips, fp32 and "
          f"bf16, d0 {V144_D0}) bit-equal to the parent commit's build "
          f"({V144_DIGESTS})")
    return {"errs": errs, "launches": launches, "batch": batch,
            "peak": peak, "step_ms": step_ms, "totals": totals,
            "grad_gap": grad_gap, "gy_ratio": gy_ratio}


# ---------------------------------------------------------------------------
# The shift-op demo and the accuracy runbook (phase 24)
# ---------------------------------------------------------------------------

DEMO_SCRIPT = "scripts/torch_demo_shift_op.py"
RUNBOOK_SCRIPT = "scripts/torch_reproduce_accuracy.sh"
# 24b's environment: configs/mediapipe/train_*.yaml unchanged (full
# width, batch 64, bf16), one epoch of 64 clips and 64 validation clips
RUNBOOK_ENV = {"EPOCHS": "1", "N_TRAIN": "64", "N_VAL": "64"}
RUNBOOK_DEVICE = "cuda"   # the device each stream's log must name
RUNBOOK_TIMEOUT = 600     # s, each of the two runs
RUNBOOK_STREAMS = ("joint", "bone", "joint_motion", "bone_motion")


def repo_path(rel: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def load_demo():
    """scripts/torch_demo_shift_op.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_demo_shift_op",
                                                  repo_path(DEMO_SCRIPT))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_shift_demo(dev, card: str) -> None:
    """Phase 24a: the demo's forward and backward (ones(1, 8, 4, 5), C=5
    fp32: 20-byte rows, K1's and the fused K2+K3's 1-element lanes) on
    ``dev`` at strides 1 and 2, in this process, against the same
    function on the CPU (the plain versions): the output bit-equal,
    grad_ypos equal element for element (its 1e-4 tie steps included),
    grad_xpos exactly zero, grad_input within fp32 roundoff; one K1 and
    one fused K2+K3 launch a stride."""
    from shift_gcn_torch import kernels

    demo = load_demo()
    expect = {name: int(name in ("temporal_shift", "temporal_shift_backward"))
              for name in kernels.KERNELS}
    for stride in (1, 2):
        kernels.reset_launches()
        got = demo.run_demo(stride, dev)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = demo.run_demo(stride, "cpu")
        got = {k: v.cpu() for k, v in got.items()}
        if launches != expect:
            fail(f"24a: demo launch counts at stride {stride} {launches} "
                 f"!= expected {expect}")
        if not torch.equal(got["out"], want["out"]):
            fail(f"24a: demo output at stride {stride} is not bit-equal to "
                 f"the plain version's: max|err| "
                 f"{max_err(got['out'], want['out'])[0]:.3g}")
        if not torch.equal(got["grad_ypos"], want["grad_ypos"]):
            fail(f"24a: grad_ypos at stride {stride} "
                 f"{got['grad_ypos'].tolist()} != the plain version's "
                 f"{want['grad_ypos'].tolist()}")
        if got["grad_xpos"].count_nonzero():
            fail(f"24a: grad_xpos at stride {stride} "
                 f"{got['grad_xpos'].tolist()} is not zero")
        err, scale = max_err(got["grad_input"], want["grad_input"])
        if not err <= 1e-6 * scale:
            fail(f"24a: grad_input at stride {stride} max|err| {err:.3g} > "
                 f"{1e-6 * scale:.3g}")
        print(f"[demo] 24a: {DEMO_SCRIPT} at stride {stride} on {dev}: out "
              f"{tuple(got['out'].shape)} bit-equal to the plain version, "
              f"grad_ypos {[sig(v) for v in got['grad_ypos'].tolist()]} "
              f"equal, grad_xpos "
              f"zero, grad_input max|err| {err:.3g} (norm "
              f"{float(torch.linalg.vector_norm(got['grad_input'])):.4f}); "
              f"launches {launches} | {card}")


def run_runbook(workdir: str, card: str) -> dict:
    """Phase 24b: scripts/torch_reproduce_accuracy.sh in synthetic mode
    (RUNBOOK_ENV) with its data and work dirs under ``workdir``; its
    process group killed once the joint stream's final checkpoint exists
    and the bone stream's log has appeared, then run again: the rerun
    must skip both data stages, resume the joint stream past its end with
    no epoch trained, write the four best-score pickles and print the
    table, and every stream's log must name RUNBOOK_DEVICE.  Returns the
    runs' seconds."""
    import signal

    work = os.path.join(workdir, "work")
    env = dict(os.environ, DATA_DIR=os.path.join(workdir, "data"),
               WORK_DIR=work, **RUNBOOK_ENV)
    run_dir = {s: os.path.join(work, f"mediapipe_ShiftGCN_{s}")
               for s in RUNBOOK_STREAMS}
    joint_saves = os.path.join(work, "save_models",
                               "mediapipe_ShiftGCN_joint")
    last = int(RUNBOOK_ENV["EPOCHS"]) - 1
    final = f"mediapipe_ShiftGCN_joint-{last}-"

    def joint_final() -> bool:
        return os.path.isdir(joint_saves) and any(
            n.startswith(final) and n.endswith(".pt")
            for n in os.listdir(joint_saves))

    cmd = ["bash", repo_path(RUNBOOK_SCRIPT)]
    t0 = time.perf_counter()
    first_log = os.path.join(workdir, "runbook_first.txt")
    with open(first_log, "w") as out:
        proc = subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while not (joint_final() and os.path.exists(
                    os.path.join(run_dir["bone"], "log.txt"))):
                if proc.poll() is not None:
                    with open(first_log) as f:
                        fail(f"24b: the runbook exited ({proc.returncode}) "
                             f"before the kill point:\n{f.read()[-3000:]}")
                    return {}
                if time.perf_counter() - t0 > RUNBOOK_TIMEOUT:
                    fail("24b: the joint stream's final checkpoint and the "
                         f"bone stream's log did not appear in "
                         f"{RUNBOOK_TIMEOUT} s")
                    return {}
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    first_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    rerun = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
    try:
        printed, _ = rerun.communicate(timeout=RUNBOOK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(rerun.pid, signal.SIGKILL)
        printed, _ = rerun.communicate()
    second_s = time.perf_counter() - t1
    with open(os.path.join(workdir, "runbook_rerun.txt"), "w") as f:
        f.write(printed)
    if rerun.returncode != 0:
        fail(f"24b: the rerun exited {rerun.returncode} after "
             f"{second_s:.0f} s:\n{printed[-3000:]}")
        return {}
    for line in ("== stage 1: joint data already present, skipping gendata",
                 "== stage 2: modality artifacts already present, skipping",
                 "== metrics vs BASELINE.md =="):
        if line not in printed:
            fail(f"24b: the rerun did not print {line!r}")
    logs = {}
    for stream, path in run_dir.items():
        with open(os.path.join(path, "log.txt")) as f:
            logs[stream] = f.read()
        if f"Device: {RUNBOOK_DEVICE}" not in logs[stream]:
            fail(f"24b: the {stream} stream's log does not show it trained "
                 f"on {RUNBOOK_DEVICE}")
        if not os.path.exists(os.path.join(path, "eval_results",
                                           "best_acc.pkl")):
            fail(f"24b: no best-score pickle for the {stream} stream")
    resumed = logs["joint"].split("Auto-resume found checkpoint")
    if (len(resumed) != 2 or f"Resumed: epoch={last + 1}" not in resumed[1]
            or "Training epoch:" in resumed[1]):
        fail("24b: the joint stream's rerun did not resume past its end "
             "without training")
    table = printed[printed.index("== metrics vs BASELINE.md"):]
    top1 = table.splitlines()[2].split()
    print(f"[runbook] 24b: {RUNBOOK_SCRIPT} synthetic, "
          f"{RUNBOOK_ENV['N_TRAIN']} + {RUNBOOK_ENV['N_VAL']} clips of "
          f"3x300x33x1, {RUNBOOK_ENV['EPOCHS']} epoch, "
          f"configs/mediapipe/train_*.yaml unchanged: killed after the "
          f"joint stream in {first_s:.1f} s, the rerun skipped both data "
          f"stages, resumed the joint stream past its end (no epoch "
          f"trained) and trained three streams on {RUNBOOK_DEVICE} in "
          f"{second_s:.1f} s; four best pickles, table printed ("
          f"{' '.join(top1[:3])}) | {card}")
    return {"first_s": first_s, "rerun_s": second_s}


# ---------------------------------------------------------------------------
# Train-mode BN (phase 25)
# ---------------------------------------------------------------------------

def bn_model(config_path: str, dev):
    """The train-mode model of ``config_path``'s model_args and
    activation dtype, seeded init."""
    from shift_gcn_torch.models.shift_gcn import (
        Model, config_from_reference_args)
    from shift_gcn_torch.train.config import load_config

    base = load_config(["--config", config_path])
    config = dataclasses.replace(
        config_from_reference_args(base.model_args),
        activation_dtype=base.activation_dtype)
    model = Model(config, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    return model.train()


def bn_calls(model, x):
    """Every train-mode BN call of one forward of ``model`` on ``x``, in
    call order: (input shape, dtype, feature_dims, whether its input
    needs a gradient in training: all but data_bn's, whose input is the
    clips)."""
    from shift_gcn_torch.ops.batchnorm import BatchNorm

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((tuple(args[0].shape), args[0].dtype,
                                        mod.feature_dims,
                                        mod is not model.data_bn)))
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x)
    for hook in hooks:
        hook.remove()
    return calls


def bn_bytes(shape, dtype, want_dx: bool):
    """Bytes of one call each way, each input read and each output written
    once: forward x and y; backward x and dy, and dx where it is wanted."""
    size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return 2 * size, (3 if want_dx else 2) * size


def check_bn_case(shape, dtype, fd: int, want_dx: bool, lp: bool, gen, dev,
                  label: str):
    """The kernels against their plain versions at one call's shape, on
    N(0.5, 2) inputs: forward (mean and inv, y, the running statistics and
    the count), y bit-equal to the plain normalize given the kernels'
    statistics, backward (dx where wanted, dw, db) from the same
    statistics, and every output bit-equal across two launches.  Returns
    the inputs for the timings."""
    from shift_gcn_torch.ops import batchnorm as bn

    f = int(np.prod(shape[len(shape) - fd:]))
    dims = tuple(range(len(shape) - fd))
    feat = shape[len(shape) - fd:]
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = torch.rand(f, generator=gen, device=dev) + 0.5
    b = torch.randn(f, generator=gen, device=dev)
    rm0 = torch.randn(f, generator=gen, device=dev) * 0.1
    rv0 = torch.rand(f, generator=gen, device=dev) + 0.5

    def forward(launcher):
        state = (rm0.clone(), rv0.clone(),
                 torch.zeros((), dtype=torch.long, device=dev))
        y, mean_inv = launcher(x, w, b, *state, feature_dims=fd, lp=lp)
        return (y, mean_inv) + state

    got, again = forward(bn.batch_norm_train_forward), \
        forward(bn.batch_norm_train_forward)
    want = forward(bn.batch_norm_train_forward_reference)
    grads = [bn.batch_norm_train_backward(x, dy, got[1], w, feature_dims=fd,
                                          want_dx=want_dx)
             for _ in range(2)]
    grad_want = bn.batch_norm_train_backward_reference(
        x, dy, got[1], w, feature_dims=fd, want_dx=want_dx)
    torch.cuda.synchronize()
    where = f"25 {label} {tuple(shape)} {str(dtype)[6:]} F={f}" + (
        " lp" if lp else "")
    for name, a, c in zip(("y", "mean_inv", "running_mean", "running_var",
                           "count"), got, again):
        if not torch.equal(a, c):
            fail(f"{where}: {name} differs between two launches")
    for name, a, c in zip(("dx", "dw", "db"), *grads):
        if not (a is None and c is None or torch.equal(a, c)):
            fail(f"{where}: {name} differs between two launches")
    y, mean_inv, rm, rv, count = got
    mean, inv = mean_inv.unbind(0)
    x32 = x.float()
    abs_mean = x32.abs().mean(dims).reshape(-1)
    errs = {"mean": float(((mean - want[1][0]).abs() / abs_mean).max()),
            "inv": float(((inv - want[1][1]).abs() / want[1][1]).max())}
    if not max(errs.values()) <= BN_TOL:
        fail(f"{where}: statistics off the plain version's by {errs} of "
             f"scale > {BN_TOL:g}")
    plain_y = bn._normalize(x, mean.reshape(feat), inv.reshape(feat), w, b,
                            feat, lp)
    if not torch.equal(y, plain_y):
        fail(f"{where}: y not bit-equal to the plain normalize on the "
             f"kernels' statistics (max|err| {max_err(y, plain_y)[0]:.3g})")
    tol = BN_TOL if dtype == torch.float32 else 2 ** -7
    for name, a, c, t in (("y", y, want[0], tol),
                          ("running_mean", rm, want[2], BN_TOL),
                          ("running_var", rv, want[3], BN_TOL)):
        err, scale = max_err(a, c)
        if not err <= t * scale:
            fail(f"{where}: {name} max|err| {err:.3g} > {t * scale:.3g}")
        errs[name] = err / scale
    if int(count) != 1 or int(want[4]) != 1:
        fail(f"{where}: num_batches_tracked {int(count)}, plain "
             f"{int(want[4])}, not 1")
    dx, dw, db = grads[0]
    if (dx is None) != (not want_dx):
        fail(f"{where}: dx {'missing' if dx is None else 'not skipped'}")
    g32 = dy.float()
    xhat = (x32 - mean.reshape(feat)) * inv.reshape(feat)
    for name, a, c, terms in (("db", db, grad_want[2], g32.abs()),
                              ("dw", dw, grad_want[1], (g32 * xhat).abs())):
        bound = BN_TOL * terms.sum(dims).reshape(-1)
        ratio = float(((a - c).abs() / bound).max())
        if not ratio <= 1.0:
            fail(f"{where}: {name} off the plain version's by {ratio:.3g} "
                 f"x {BN_TOL:g} of the sum of |terms|")
        errs[name] = ratio * BN_TOL
    if want_dx:
        err, scale = max_err(dx, grad_want[0])
        if not err <= tol * scale:
            fail(f"{where}: dx max|err| {err:.3g} > {tol * scale:.3g}")
        errs["dx"] = err / scale
    return {"x": x, "dy": dy, "w": w, "b": b, "mean_inv": mean_inv,
            "state": (rm, rv, count), "errs": errs}


def time_bn_case(case, shape, dtype, fd: int, want_dx: bool):
    """(kernel forward ms, kernel backward ms, plain ms, library ms) of one
    call at ``case``'s inputs: the plain versions forward and backward,
    and ``F.batch_norm`` forward and backward on x as (R, F), the library
    yardstick that the port never calls."""
    import torch.nn.functional as F

    from shift_gcn_torch.ops import batchnorm as bn

    x, dy, w, b, mean_inv = (case[k] for k in ("x", "dy", "w", "b",
                                               "mean_inv"))
    rm, rv, count = case["state"]
    kw = {"feature_dims": fd}
    fwd = time_ms(lambda: bn.batch_norm_train_forward(x, w, b, rm, rv, count,
                                                      **kw))
    bwd = time_ms(lambda: bn.batch_norm_train_backward(
        x, dy, mean_inv, w, want_dx=want_dx, **kw))

    def plain():
        _, mi = bn.batch_norm_train_forward_reference(x, w, b, rm, rv, count,
                                                      **kw)
        bn.batch_norm_train_backward_reference(x, dy, mi, w,
                                               want_dx=want_dx, **kw)

    f = int(np.prod(shape[len(shape) - fd:]))
    x2 = x.reshape(-1, f).detach().requires_grad_(want_dx)
    dy2 = dy.reshape(-1, f)
    w2, b2 = w.detach().requires_grad_(), b.detach().requires_grad_()
    inputs = [t for t in (x2, w2, b2) if t.requires_grad]

    def library():
        out = F.batch_norm(x2, rm, rv, w2, b2, training=True)
        torch.autograd.grad(out, inputs, dy2)

    return fwd, bwd, time_ms(plain), time_ms(library)


def run_batchnorm(gen, dev, card: str) -> dict:
    """Phase 25: the train-mode BN kernels against their plain versions at
    every BN call of one train step of each of BN_MODELS (N_WINDOWS clips
    of T=T_WINDOW), with lp also on each bf16 shape; the launch counters of
    one train step of each model (one forward and one backward launch per
    train-mode BN); each call's time forward and backward summed over the
    step beside its bytes bound, its plain version and F.batch_norm.
    Returns {model: {...}} for the summary."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.train.optim import build_optimizer
    from shift_gcn_torch.train.state import train_step

    out = {}
    rng = np.random.default_rng(25)
    for label, config_path in BN_MODELS:
        model = bn_model(config_path, dev)
        cfg = model.config
        data, labels = ntu_clips(rng, N_WINDOWS, T_WINDOW, cfg.num_point,
                                 cfg.num_person, cfg.num_class)
        batch = {"data": torch.from_numpy(data).to(dev),
                 "label": torch.from_numpy(labels).to(dev)}
        calls = bn_calls(model, batch["data"])
        opt = build_optimizer(model, 0.1)
        kernels.reset_launches()
        train_step(model, opt, batch, 0.1)
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES[k] for k in BN_KERNELS}
        bns = sum(isinstance(m, type(model.data_bn)) for m in model.modules())
        if launches != dict.fromkeys(BN_KERNELS, len(calls)) or \
                len(calls) != bns:
            fail(f"25 {label}: BN launch counts of one train step "
                 f"{launches}, expected {len(calls)} each, one per "
                 f"train-mode BN ({bns} BatchNorm modules)")
        del model, opt, batch
        torch.cuda.empty_cache()
        cases = {}
        for call in calls:
            cases[call] = cases.get(call, 0) + 1
        worst = {}
        totals = dict.fromkeys(("fwd", "bwd", "bytes_fwd", "bytes_bwd",
                                "plain", "library"), 0.0)
        for (shape, dtype, fd, want_dx), count in cases.items():
            for lp in ((False, True) if dtype != torch.float32
                       else (False,)):
                case = check_bn_case(shape, dtype, fd, want_dx, lp, gen, dev,
                                     label)
                for k, v in case["errs"].items():
                    worst[k] = max(worst.get(k, 0.0), v)
                if lp:
                    continue
                times = time_bn_case(case, shape, dtype, fd, want_dx)
                for k, v in zip(("fwd", "bwd", "plain", "library"), times):
                    totals[k] += count * v
                for k, v in zip(("bytes_fwd", "bytes_bwd"),
                                bn_bytes(shape, dtype, want_dx)):
                    totals[k] += count * v
                del case
            torch.cuda.empty_cache()
        bound_fwd = totals["bytes_fwd"] / HBM_BYTES_PER_S * 1e3
        bound_bwd = totals["bytes_bwd"] / HBM_BYTES_PER_S * 1e3
        print(f"[bn] 25 {label}: {len(calls)} train-mode BNs a step, "
              f"{len(cases)} shapes (lp also at each bf16 one), kernels vs "
              f"plain versions: worst share of scale "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
              + f" (tol {BN_TOL:g}, bf16 y and dx 2^-7); y bit-equal to the "
              f"plain normalize on the kernels' statistics; every output "
              f"bit-equal across two launches; launches of one train step "
              f"{launches}")
        print(f"[bn] 25 {label}, {N_WINDOWS} clips x T={T_WINDOW}, a step's "
              f"BN calls: forward {totals['fwd']:.3f} ms (bound "
              f"{bound_fwd:.3f}, {100 * bound_fwd / totals['fwd']:.0f}%), "
              f"backward {totals['bwd']:.3f} ms (bound {bound_bwd:.3f}, "
              f"{100 * bound_bwd / totals['bwd']:.0f}%); plain "
              f"{totals['plain']:.3f} ms, F.batch_norm "
              f"{totals['library']:.3f} ms, forward and backward | {card}")
        out[label] = {"calls": len(calls), "launches": launches,
                      "ms": sig(totals["fwd"]), "backward_ms": sig(
                          totals["bwd"]), "bound_ms": sig(bound_fwd),
                      "backward_bound_ms": sig(bound_bwd),
                      "plain_ms": sig(totals["plain"]),
                      "library_ms": sig(totals["library"]),
                      "max_err": {k: sig(v) for k, v in worst.items()}}
    return out


# ---------------------------------------------------------------------------
# 2s-AGCN's adjacency (phase 26)
# ---------------------------------------------------------------------------

def adjacency_shapes(config, n: int, t: int):
    """{(N', V, T, K, d): launches a step} of the adjacency of every unit
    of ``config`` (an AGCNConfig) on clips of ``t`` frames, ``n`` skeleton
    rows a batch: T is the unit's input length, d = C_out / 4."""
    from shift_gcn_torch.graphs import get_graph
    from shift_gcn_torch.models.agcn import COFF_EMBEDDING

    k = get_graph(config.graph).A.shape[0]
    shapes = {}
    for _, cout, stride, _ in config.blocks:
        shape = (n, config.num_point, t, k, cout // COFF_EMBEDDING)
        shapes[shape] = shapes.get(shape, 0) + 1
        t = -(-t // stride)
    return shapes


def adjacency_cost_ms(n: int, v: int, t: int, k: int, d: int):
    """(forward, backward) bound ms of one launch: bytes at the HBM rate
    (forward e, A and PA read and G written; backward e, P and dG read and
    de written; as ``benchmark/families/agcn2s.py`` counts them) or the
    contraction's FLOPs (2 N' K d T V^2, twice that backward) at the fp32
    SIMT rate, the larger."""
    emb = 4 * n * v * t * 2 * k * d
    graph = 4 * n * k * v * v
    flops = 2.0 * n * k * d * t * v * v
    return (1e3 * max((emb + 2 * 4 * k * v * v + graph) / HBM_BYTES_PER_S,
                      flops / FP32_SIMT_FLOPS),
            1e3 * max((2 * emb + 2 * graph) / HBM_BYTES_PER_S,
                      2 * flops / FP32_SIMT_FLOPS))


def check_adjacency_case(shape, gen, dev):
    """The kernels against their plain versions at one launch shape, on
    N(0, 9) embeddings (attention logits spread past 1), A in U(0, 1) and
    PA N(0, 0.01): G and P within ADJ_TOL of their largest value, each
    column of P summing to 1 over the source joints, de within ADJ_TOL of
    its largest value from the plain P, every output bit-equal across two
    launches.  Returns (the inputs, the worst shares of scale)."""
    from shift_gcn_torch.ops import adaptive

    n, v, t, k, d = shape
    e = torch.randn(n, v, t, 2 * k * d, generator=gen, device=dev) * 3
    a = torch.rand(k, v, v, generator=gen, device=dev)
    pa = torch.randn(k, v, v, generator=gen, device=dev) * 0.1
    dg = torch.randn(n, k, v, v, generator=gen, device=dev)
    (g, p), (g2, p2) = (adaptive.adjacency_forward(e, a, pa, k)
                        for _ in range(2))
    de, de2 = (adaptive.adjacency_backward(e, p, dg) for _ in range(2))
    want_g, want_p = adaptive.adjacency_forward_reference(e, a, pa, k)
    want_de = adaptive.adjacency_backward_reference(e, want_p, dg)
    torch.cuda.synchronize()
    where = f"26 adjacency (N', V, T, K, d) = {shape}"
    for name, x, y in (("G", g, g2), ("P", p, p2), ("de", de, de2)):
        if not torch.equal(x, y):
            fail(f"{where}: {name} differs between two launches")
    errs = {}
    for name, got, want in (("G", g, want_g), ("P", p, want_p),
                            ("de", de, want_de)):
        err, scale = max_err(got, want)
        if not err <= ADJ_TOL * scale:
            fail(f"{where}: {name} max|err| {err:.3g} > "
                 f"{ADJ_TOL * scale:.3g}")
        errs[name] = err / scale
    columns = float((p.sum(2) - 1).abs().max())
    if not columns <= 1e-5:
        fail(f"{where}: P's columns sum to 1 within {columns:.3g}, not "
             f"over the source joints")
    return (e, a, pa, dg, p), errs


def tconv_shapes(config, n: int, t: int):
    """{(R, T, C, stride): launches a step} of every unit's 9-tap conv of
    ``config`` (an AGCNConfig) on clips of ``t`` frames, ``n`` skeleton
    rows a batch: R = n V rows, T the conv's input length, C its width."""
    shapes = {}
    for _, cout, stride, _ in config.blocks:
        shape = (n * config.num_point, t, cout, stride)
        shapes[shape] = shapes.get(shape, 0) + 1
        t = -(-t // stride)
    return shapes


def tconv_cost_ms(rows: int, t: int, c: int, stride: int):
    """(forward, input gradient + weight gradient) bound ms of one
    launch each: per op 2 R T' C^2 9 FLOPs at the 3xTF32 rate or its
    bytes at the HBM rate (each input read and each output written once),
    the larger."""
    t_out = -(-t // stride)
    x, y, w = 4 * rows * t * c, 4 * rows * t_out * c, 4 * 9 * c * c
    flops = 2.0 * rows * t_out * c * c * 9

    def bound(nbytes):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / TF32_3X_FLOPS)

    return (bound(x + w + 4 * c + y),
            bound(y + w + x) + bound(x + y + w + 4 * c))


def check_tconv_case(shape, gen, dev):
    """The kernels against their plain versions in float64 at one launch
    shape, on N(0, 1) inputs and a fan-out draw of W: y, dx, dW and db
    each within twice cuDNN's fp32 gap to the same plain version, or
    TCONV_FLOOR of its largest value; every output bit-equal across two
    launches.  Returns (the inputs, the worst shares of scale)."""
    from shift_gcn_torch.ops import agcn_tconv

    rows, t, c, stride = shape
    x = torch.randn(rows, t, c, generator=gen, device=dev)
    w = torch.randn(c, c, 9, 1, generator=gen, device=dev) * \
        (2.0 / (9 * c)) ** 0.5
    b = torch.randn(c, generator=gen, device=dev) * 0.1
    dy = torch.randn(rows, -(-t // stride), c, generator=gen, device=dev)
    outs = [(agcn_tconv.tconv_forward(x, w, b, stride),
             agcn_tconv.tconv_input_grad(dy, w, t, stride),
             *agcn_tconv.tconv_weight_grad(x, dy, stride))
            for _ in range(2)]
    torch.cuda.synchronize()
    where = f"26 9-tap conv (R, T, C, stride) = {shape}"
    names = ("y", "dx", "dW", "db")
    for name, one, two in zip(names, *outs):
        if not torch.equal(one, two):
            fail(f"{where}: {name} differs between two launches")
    x64, w64, b64, dy64 = (a.double() for a in (x, w, b, dy))
    want = (agcn_tconv.tconv_forward_reference(x64, w64, b64, stride),
            agcn_tconv.tconv_input_grad_reference(dy64, w64, t, stride),
            *agcn_tconv.tconv_weight_grad_reference(x64, dy64, stride))
    library = conv2d_fp32(x, w, b, dy, stride)
    errs = {}
    for name, got, lib, ref in zip(names, outs[0], library, want):
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max())
        tol = max(2 * float((lib.double() - ref).abs().max()),
                  TCONV_FLOOR * scale)
        if not err <= tol:
            fail(f"{where}: {name} max|err| {err:.3g} > {tol:.3g}")
        errs[name] = err / scale
    del outs, want, library
    return (x, w, b, dy), errs


def conv2d_fp32(x, w, b, dy, stride: int):
    """cuDNN's fp32 (TF32 off) forward, dx, dW and db of the 9-tap conv
    on the (R, C, T, 1) view: the library that the kernels replace."""
    leaves = [a.detach().clone().requires_grad_() for a in (x, w, b)]
    y = torch.nn.functional.conv2d(
        leaves[0].transpose(1, 2).unsqueeze(-1), leaves[1], leaves[2],
        stride=(stride, 1), padding=(4, 0)).squeeze(-1).transpose(1, 2)
    y.backward(dy)
    return (y.detach(), *(a.grad for a in leaves))


def device_kernel_names(fn) -> list:
    """The device kernels of one call of ``fn``, by the names the profiler
    shows (none where there is no card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]


def run_tconv(config, model, batch, gen, dev, card: str) -> dict:
    """Phase 26's 9-tap conv: no cuDNN convolution in a profiled forward
    and backward of ``model`` on ``batch``; the kernels against their
    plain versions at every unit's launch shape (check_tconv_case); their
    times over a step's launches beside the bound, the plain versions and
    cuDNN's fp32 forward and backward.  Returns the figures of the kernels
    entry."""
    from shift_gcn_torch.ops import agcn_tconv

    def step():
        torch.nn.functional.cross_entropy(
            model(batch["data"]), batch["label"]).backward()

    found = [k for k in device_kernel_names(step)
             if any(p in k for p in CUDNN_CONV)]
    if found:
        fail(f"26 a 2s-AGCN forward and backward ran cuDNN's convolution "
             f"kernels {found}")
    model.zero_grad(set_to_none=True)
    worst = {}
    totals = dict.fromkeys(("fwd", "dx", "dw", "bound_fwd", "bound_bwd",
                            "plain", "library"), 0.0)
    shapes = tconv_shapes(config, N_WINDOWS * config.num_person, T_WINDOW)
    for shape, count in shapes.items():
        (x, w, b, dy), errs = check_tconv_case(shape, gen, dev)
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        t, stride = shape[1], shape[3]
        fwd = time_ms(lambda: agcn_tconv.tconv_forward(x, w, b, stride))
        dx = time_ms(lambda: agcn_tconv.tconv_input_grad(dy, w, t, stride))
        dw = time_ms(lambda: agcn_tconv.tconv_weight_grad(x, dy, stride))

        def plain():
            agcn_tconv.tconv_forward_reference(x, w, b, stride)
            agcn_tconv.tconv_input_grad_reference(dy, w, t, stride)
            agcn_tconv.tconv_weight_grad_reference(x, dy, stride)

        plain_ms = time_ms(plain, iters=2, reps=3)
        library = time_ms(lambda: conv2d_fp32(x, w, b, dy, stride))
        bound_fwd, bound_bwd = tconv_cost_ms(*shape)
        for key, val in (("fwd", fwd), ("dx", dx), ("dw", dw),
                         ("plain", plain_ms), ("library", library),
                         ("bound_fwd", bound_fwd), ("bound_bwd", bound_bwd)):
            totals[key] += count * val
        print(f"[agcn] 26 9-tap conv (R, T, C, stride) = {shape} x{count}: "
              f"forward {fwd:.4f} ms (bound {bound_fwd:.4f}), input grad "
              f"{dx:.4f} + weight grad {dw:.4f} ms (bound {bound_bwd:.4f}), "
              f"plain {plain_ms:.4f}, cuDNN fp32 {library:.4f} ms forward "
              f"and backward | {card}")
        del x, w, b, dy
        torch.cuda.empty_cache()
    ms = totals["fwd"] + totals["dx"] + totals["dw"]
    bound = totals["bound_fwd"] + totals["bound_bwd"]
    print(f"[agcn] 26 9-tap conv kernels vs plain versions (float64) at "
          f"{len(shapes)} unit shapes: worst share of the largest value "
          + ", ".join(f"{k} {x:.3g}" for k, x in sorted(worst.items()))
          + f" (within twice cuDNN fp32's gap or {TCONV_FLOOR:g}), "
          f"bit-equal across two launches; no cuDNN convolution in a "
          f"forward and backward")
    print(f"[agcn] 26 a step's 9-tap conv launches at {N_WINDOWS} clips x "
          f"T={T_WINDOW}: forward {totals['fwd']:.3f} ms (bound "
          f"{totals['bound_fwd']:.3f}), input grad {totals['dx']:.3f} + "
          f"weight grad {totals['dw']:.3f} ms (bound "
          f"{totals['bound_bwd']:.3f}), {100 * bound / ms:.0f}% of the "
          f"3xTF32 bound; plain {totals['plain']:.3f} ms; cuDNN fp32 "
          f"{totals['library']:.3f} ms | {card}")
    return {"max_err": {k: sig(x) for k, x in worst.items()},
            "ms": sig(totals["fwd"]),
            "backward_ms": sig(totals["dx"] + totals["dw"]),
            "input_grad_ms": sig(totals["dx"]),
            "weight_grad_ms": sig(totals["dw"]),
            "bound_ms": sig(totals["bound_fwd"]),
            "backward_bound_ms": sig(totals["bound_bwd"]),
            "plain_ms": sig(totals["plain"]),
            "library_ms": sig(totals["library"])}


def run_agcn(rng, gen, dev, workdir: str, card: str) -> dict:
    """Phase 26: 2s-AGCN's joint stream (AGCN_CONFIG, the ``agcn2s``
    family at the published widths, fp32) through the Trainer for
    AGCN_STEPS steps of N_WINDOWS synthetic NTU-60 clips of T_WINDOW
    frames, launches counted from zero: one adjacency forward and one
    backward per unit, one 9-tap conv forward, input gradient and weight
    gradient per unit, one BN forward and backward per train-mode BN,
    nothing else of the port's; the adjacency kernels against their plain
    versions at every unit's launch shape; their times over a step's
    launches beside the bound and the plain versions; a bare train step's
    time, peak memory and busy share; and the 9-tap conv (run_tconv).
    Returns the figures of the kernels entries and the summary."""
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models import agcn
    from shift_gcn_torch.models.registry import get_model
    from shift_gcn_torch.ops import adaptive
    from shift_gcn_torch.ops.batchnorm import BatchNorm
    from shift_gcn_torch.train.config import load_config
    from shift_gcn_torch.train.trainer import Trainer

    base = load_config(["--config", AGCN_CONFIG])
    config = agcn.config_from_args(base.model_args)
    if not (get_model(base.model).name == "agcn2s"
            and (config.num_class, config.num_point, config.num_person,
                 config.graph, config.blocks, base.batch_size)
            == (60, 25, 2, "ntu_rgb_d", agcn.PUBLISHED_BLOCKS, 64)
            and base.activation_dtype is None):
        fail(f"{AGCN_CONFIG} no longer trains the published 2s-AGCN "
             "(agcn2s, 60 classes, V=25, M=2, ten units) at batch 64 in "
             "fp32")
    v, m = config.num_point, config.num_person
    feeder_args = {
        split: write_split(workdir, split, *ntu_clips(
            rng, n, T_WINDOW, v, m, config.num_class))
        for split, n in (("train", AGCN_STEPS * N_WINDOWS),
                         ("val", N_WINDOWS))}
    cfg = one_epoch_config(AGCN_CONFIG, workdir, feeder_args,
                           "--batch_size", str(N_WINDOWS),
                           "--test_batch_size", str(N_WINDOWS))
    trainer = Trainer(cfg)
    if not (isinstance(trainer.model, agcn.Model)
            and trainer.model.config == config):
        fail(f"the Trainer built {type(trainer.model).__name__} from "
             f"{AGCN_CONFIG}, not the published agcn2s")
    units = len(config.blocks)
    bns = sum(isinstance(mod, BatchNorm) for mod in trainer.model.modules())
    kernels.reset_launches()
    epoch = trainer.train_epoch(0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    per_step = dict.fromkeys(kernels.KERNELS, 0)
    per_step.update(dict.fromkeys(AGCN_KERNELS, units))
    per_step.update(dict.fromkeys(TCONV_KERNELS, units))
    per_step.update(dict.fromkeys(BN_KERNELS, bns))
    expect = {k: c * AGCN_STEPS for k, c in per_step.items()}
    if launches != expect:
        fail(f"26 2s-AGCN launch counts of {AGCN_STEPS} Trainer steps "
             f"{launches} != expected {expect}: per step one adjacency "
             f"forward and backward and one 9-tap conv forward, input "
             f"gradient and weight gradient per unit ({units}), one BN "
             f"forward and backward per train-mode BN ({bns})")
    losses = epoch["losses"]
    if len(losses) != AGCN_STEPS or not np.isfinite(losses).all():
        fail(f"26 2s-AGCN train losses {losses}")
    del trainer
    torch.cuda.empty_cache()

    model = agcn.Model(config, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    data, labels = ntu_clips(rng, N_WINDOWS, T_WINDOW, v, m,
                             config.num_class)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    step_ms, fwd_ms, peak, busy = step_cost(
        model, batch, base.base_lr, dev,
        f"one 2s-AGCN fp32 train step, batch {N_WINDOWS}", card)
    model.train()
    tconv = run_tconv(config, model, batch, gen, dev, card)
    del model, batch
    torch.cuda.empty_cache()

    worst = {}
    totals = dict.fromkeys(("fwd", "bwd", "bound_fwd", "bound_bwd",
                            "plain"), 0.0)
    shapes = adjacency_shapes(config, N_WINDOWS * m, T_WINDOW)
    for shape, count in shapes.items():
        (e, a, pa, dg, p), errs = check_adjacency_case(shape, gen, dev)
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        k = shape[3]
        fwd = time_ms(lambda: adaptive.adjacency_forward(e, a, pa, k))
        bwd = time_ms(lambda: adaptive.adjacency_backward(e, p, dg))

        def plain():
            _, pp = adaptive.adjacency_forward_reference(e, a, pa, k)
            adaptive.adjacency_backward_reference(e, pp, dg)

        plain_ms = time_ms(plain)
        bound_fwd, bound_bwd = adjacency_cost_ms(*shape)
        for key, val in (("fwd", fwd), ("bwd", bwd), ("plain", plain_ms),
                         ("bound_fwd", bound_fwd), ("bound_bwd", bound_bwd)):
            totals[key] += count * val
        print(f"[agcn] 26 adjacency (N', V, T, K, d) = {shape} x{count}: "
              f"forward {fwd:.4f} ms (bound {bound_fwd:.4f}), backward "
              f"{bwd:.4f} ms (bound {bound_bwd:.4f}), plain {plain_ms:.4f} "
              f"ms forward and backward | {card}")
        del e, a, pa, dg, p
        torch.cuda.empty_cache()
    ms = totals["fwd"] + totals["bwd"]
    bound = totals["bound_fwd"] + totals["bound_bwd"]
    print(f"[agcn] 26 {AGCN_CONFIG} through the Trainer (agcn2s, "
          f"published widths, fp32, batch {N_WINDOWS}, T={T_WINDOW}): "
          f"{AGCN_STEPS} steps, losses {[round(x, 4) for x in losses]}, "
          f"launches {launches}; adjacency kernels vs plain versions at "
          f"{len(shapes)} unit shapes: worst share of the largest value "
          + ", ".join(f"{k} {x:.3g}" for k, x in sorted(worst.items()))
          + f" (tol {ADJ_TOL:g}), bit-equal across two launches")
    print(f"[agcn] 26 a step's adjacency launches at {N_WINDOWS} clips x "
          f"T={T_WINDOW}: forward {totals['fwd']:.3f} ms (bound "
          f"{totals['bound_fwd']:.3f}), backward {totals['bwd']:.3f} ms "
          f"(bound {totals['bound_bwd']:.3f}), {100 * bound / ms:.0f}% of "
          f"bound; plain {totals['plain']:.3f} ms; bare train step "
          f"{step_ms:.3f} ms ({N_WINDOWS / step_ms * 1e3:.1f} clips/s), "
          f"eval forward {fwd_ms:.3f} ms, step peak memory {peak:.2f} GiB, "
          f"device busy {'n/a' if busy is None else f'{100 * busy:.1f}%'} "
          f"of the profiled step | {card}")
    return {"launches": {k: launches[k] // AGCN_STEPS
                         for k in AGCN_KERNELS},
            "max_err": {k: sig(x) for k, x in worst.items()},
            "ms": sig(totals["fwd"]), "backward_ms": sig(totals["bwd"]),
            "bound_ms": sig(totals["bound_fwd"]),
            "backward_bound_ms": sig(totals["bound_bwd"]),
            "plain_ms": sig(totals["plain"]),
            "step_ms": sig(step_ms), "peak_gib": sig(peak),
            "tconv": {"launches": {k: launches[k] // AGCN_STEPS
                                   for k in TCONV_KERNELS}, **tconv}}


RANK_JOBS = {"dp": rank_dp, "seqpar": rank_seqpar, "tp": rank_tp,
             "tp22": rank_tp22, "edge": rank_edge, "ring": rank_ring}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k6-parent", default=None, metavar="SHIFT_GCN_CU",
                    help="an earlier commit's csrc/shift_gcn.cu: phase 22e "
                    "times its K6 beside this checkout's")
    ap.add_argument("--bn-only", action="store_true",
                    help="phases 1, 2 and 25 alone: the train-mode BN "
                    "kernels' checks, launch counts and timings")
    ap.add_argument("--agcn-only", action="store_true",
                    help="phases 1, 2 and 26 alone: 2s-AGCN through the "
                    "Trainer and its adjacency kernels' checks, launch "
                    "counts and timings")
    # a rank process of phase 18, started by run_ranks
    for flag in ("--rank-job", "--workdir", "--settings"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_job:
        rank_main(args)
        return

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
        # K4 and K5 x fp32, bf16 x two column tiles x whole-frame and wide
        # tiles, K6 x fp32, bf16 x the whole frame and joint groups
        if len(sass) != 20 or any(h == 0 for h, _ in sass.values()):
            fail(f"K4/K5/K6 functions without tensor-core instructions: "
                 f"{sass}")
        print("[build] K4/K5/K6 functions, HMMA instructions / registers: "
              + ", ".join(f"{k} {h}/{r}" for k, (h, r) in sass.items()))
    if args.bn_only or args.agcn_only:
        if args.bn_only:
            out = {"batch_norm_train": run_batchnorm(gen, dev, card)}
        else:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
                out = {"agcn_adjacency": run_agcn(rng, gen, dev, wd, card)}
        print(json.dumps(out, separators=(",", ":")))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return

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
        train_launches, epoch, replay = run_trainer(rng, dev, workdir)
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

    # 15.-17. lowering knobs, NTU-60, the other families --------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run_lowering_knobs(config, rng, dev, workdir, args.seed, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _, ntu_step, ntu_fwd, ntu_peak, ntu_batch = run_ntu(rng, gen, dev,
                                                            workdir, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        family_ms = run_families(rng, dev, workdir, card)

    # 18. data and sequence parallelism ------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        par = run_parallel(rng, dev, workdir, card, args.seed)

    # 19. tensor parallelism -----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        tp = run_tensor_parallel(rng, dev, workdir, card, args.seed)

    # 20. the edge partition -----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        edge = run_edge_partition(rng, dev, workdir, card, args.seed)

    # 21. per-unit recomputation, the trace, the NaN check -----------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        remat = run_remat(rng, dev, workdir, card, args.seed)
    print(f"[remat] {par['remat']}")

    # 22. custom topologies and any joint count ----------------------------
    parent = build_parent(args.k6_parent) if args.k6_parent else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        wide = run_wide(rng, gen, dev, workdir, card, args.seed, parent)

    # 23. phase 9's epoch with the clips in memory -------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run_in_memory(replay, epoch, dev, workdir, card)
    del replay

    # 24. the shift-op demo and the accuracy runbook -----------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_shift_demo(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        runbook = run_runbook(workdir, card)
    print(f"[runbook] phase 24 in {time.perf_counter() - t0:.1f} s: the "
          f"killed run {runbook['first_s']:.1f} s, the rerun "
          f"{runbook['rerun_s']:.1f} s")

    # 25. train-mode BN ----------------------------------------------------
    bn = run_batchnorm(gen, dev, card)

    # 26. 2s-AGCN's adjacency ------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        adj = run_agcn(rng, gen, dev, workdir, card)

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
    for entry in entries:
        name = entry["name"]
        ms, plain, bound, lib, bytes_ms, ops_ms = wide["totals"][name]
        entry[f"v{HOLISTIC_V}"] = {
            "launches": wide["launches"][name],
            "max_abs_err": sig(wide["errs"][name]), "ms": sig(ms),
            "plain_ms": sig(plain), "bound_ms": sig(bound),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": sig(lib)}
    entries.append({
        "name": "batch_norm_train", "route": "cuda", "source": BN_SOURCE,
        "replaces": "no TPU kernel: stock ops (reference ops/batchnorm.py)",
        "bound_by": "bytes", **bn})
    entries.append({
        "name": "agcn_adjacency", "route": "cuda", "source": AGCN_SOURCE,
        "replaces": "no TPU kernel: 2s-AGCN's attention (reference "
        "ops/adaptive.py)", "bound_by": "bytes",
        **{k: x for k, x in adj.items() if k not in ("step_ms", "peak_gib",
                                                     "tconv")}})
    entries.append({
        "name": "agcn_tconv", "route": "cuda", "source": TCONV_SOURCE,
        "replaces": "no TPU kernel: 2s-AGCN's 9-tap temporal conv, "
        "cuDNN's in the port before", "bound_by": "operations",
        **adj["tconv"]})
    print("[note] kernel ms / plain_ms / bound_ms / library_ms, fp32: "
          "temporal_shift and shift_gcn per stream forward at "
          f"{N_WINDOWS} windows x T={T_WINDOW}, launches from the serving "
          "run; the three backward kernels (the fused K2+K3, K5, K6) per "
          f"train step at {N_WINDOWS} clips x T={T_WINDOW}, launches from "
          "the Trainer run, the fused kernel's library_ms the sum of two "
          "calls, K6's that of index_select x2 + bmm + three reductions; "
          f"v{HOLISTIC_V}: phase 22, the same over a forward's or a step's "
          f"launches at V={HOLISTIC_V} with {wide['batch']} clips, "
          "launches from its Trainer run (22d), max_abs_err over V in "
          f"{WIDE_JOINTS} (22b); batch_norm_train: phase 25, forward "
          "(ms) and backward per train step of each model at "
          f"{N_WINDOWS} clips x T={T_WINDOW}; agcn_adjacency: phase 26, "
          "forward (ms) and backward over a 2s-AGCN train step's launches "
          f"at {N_WINDOWS} clips x T={T_WINDOW}, launches a step from its "
          "Trainer run; agcn_tconv: phase 26, forward (ms) and input plus "
          "weight gradient (backward_ms) over the same step's launches, "
          "library_ms cuDNN's fp32 forward and backward; summary: phases "
          "6, 8, 9, 10, 12, 13, 14, 16-22, 26")
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
          f"{100 * epoch4['dataloader_share']:.1f}%; NTU-60 batch "
          f"{ntu_batch} step/fwd {ntu_step:.4g}/{ntu_fwd:.4g}, peak "
          f"{ntu_peak:.3g} GiB; step ST-GCN {family_ms['stgcn']:.4g}, "
          f"embed16 {family_ms['stgcn_embed16']:.4g}, ring-GNN "
          f"{family_ms['ring_gnn']:.4g}; fp32 step ms on ranks sharing "
          f"the card, [2,1] " + "/".join(f"{v:.4g}" for v in par["dp_ms"])
          + f" vs {par['one_ms'][1]:.4g}, [2,2] T={T_PAD} "
          + "/".join(f"{v:.4g}" for v in par["seqpar_ms"])
          + f" vs {par['one_ms'][0]:.4g}; TP [1,2] "
          + "/".join(f"{v:.4g}" for v in tp["tp12_ms"]) + ", [2,2] "
          + "/".join(f"{v:.4g}" for v in tp["tp22_ms"])
          + f" vs {tp['one_ms']:.4g}; ST-GCN gather [1,4] "
          + "/".join(f"{v:.4g}" for v in edge["edge14_ms"]) + ", [2,2] "
          + "/".join(f"{v:.4g}" for v in edge["edge22_ms"])
          + f" vs {edge['one_ms']:.4g}; ring [1,8] "
          + "/".join(f"{v:.3g}" for v in edge["ring_ms"])
          + f" vs {edge['ring_one_ms']:.3g}; remat GiB/ms without->with "
          + ", ".join(f"{k} {r['peak'][0]:.3g}->{r['peak'][1]:.3g}/"
                      f"{r['ms'][0]:.4g}->{r['ms'][1]:.4g}"
                      for k, r in remat.items())
          + f"; V={HOLISTIC_V} bf16 batch {wide['batch']} step "
          f"{wide['step_ms']:.4g} ms, peak {wide['peak']:.3g} GiB, fp32 "
          f"grads {wide['grad_gap']:.2g}; 2s-AGCN step {adj['step_ms']:.4g} "
          f"ms, peak {adj['peak_gib']:.3g} GiB")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
