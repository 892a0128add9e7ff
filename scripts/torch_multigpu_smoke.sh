#!/usr/bin/env bash
# The port's multi-GPU training (shift_gcn_torch, one process per card)
# on configs/mediapipe/train_seqpar.yaml, unchanged in model, batch 64,
# padding to 304 and bf16, for two epochs of 8 steps on synthetic clips
# (the kernels built first; the second epoch's clips/s is past the first
# step's warm-up):
#   1. one process on one card (mesh cleared, no T shards),
#   2. torchrun over N cards as data parallelism, mesh [N, 1],
#   3. torchrun over N cards as data x sequence parallelism, mesh
#      [N/2, 2] (the config's own [4, 2] when N=8),
#   4. torchrun over N cards as tensor parallelism, mesh [1, N] and
#      [N/2, 2] with shard_time off: configs/mediapipe/train_joint.yaml's
#      model and batch (the seqpar config is that model and batch with
#      T padded to 304 and a mesh), on the same padded clips, so that run
#      1 is their one-process reference too,
#   5. the edge partition: configs/stgcn_edges.yaml's model and batch
#      (full-width ST-GCN, fp32, batch 16) on the same clips, unpadded,
#      in one process (its parallel keys off) and under torchrun at mesh
#      [N/2, 2] (gather), and configs/synthetic_ring.yaml's on synthetic
#      node-feature clips in one process and at mesh [1, N] (ring),
#   6. for every multi-card run, one process on one card resumed from the
#      run's last checkpoint, past the end: it only evaluates, without a
#      group.
# Any run that fails fails the script.  Then it checks, and fails unless:
#   - every run's first-step loss is within LOSS_GATE relative of its
#     one-process run's (run 1, or the edge runs' own; all start from the
#     same seed on the same batch; the ranks sum BN's statistics in
#     another order, which rounds some bf16 activations the other way),
#   - every run's test loss is finite,
#   - the scores each multi-card run wrote equal those of the one-process
#     evaluation of its checkpoint within SCORE_GATE of their scale, with
#     the same top-1 accuracy (the eval forward is per clip; only the
#     pooling's and the gather's order differ).
# Each run's full log is in out_dir/<run>.log; the script prints the step
# losses, the epochs' clips/s and the checks.
#
#   scripts/torch_multigpu_smoke.sh [N] [out_dir]     (N: 4 by default)
set -euo pipefail
N=${1:-4}
OUT=${2:-_proof/multigpu}
LOSS_GATE=2e-3
SCORE_GATE=1e-2
mkdir -p "$OUT"
python - "$OUT" <<'EOF'
import os, pickle, sys

import numpy as np

out = sys.argv[1]
rng = np.random.default_rng(0)
for split, n in (("train", 512), ("val", 128)):
    labels = rng.integers(0, 2, n)
    data = (rng.standard_normal((n, 3, 300, 33, 1)) * 0.1).astype(np.float32)
    data[:, 0] += (labels * 0.3)[:, None, None, None].astype(np.float32)
    np.save(os.path.join(out, f"{split}_data.npy"), data)
    with open(os.path.join(out, f"{split}_label.pkl"), "wb") as f:
        pickle.dump(([f"{split}{i}" for i in range(n)], labels.tolist()), f)
    # the ring-GNN's node-feature clips (V=256, C=8)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 8, 1, 256, 1)).astype(np.float32)
    data[:, 0] += (labels * 1.5 - 0.75)[:, None, None, None]
    np.save(os.path.join(out, f"ring_{split}_data.npy"), data)
    with open(os.path.join(out, f"ring_{split}_label.pkl"), "wb") as f:
        pickle.dump(([f"{split}{i}" for i in range(n)], labels.tolist()), f)
EOF
python -c "from shift_gcn_torch import kernels; kernels.build_all()"
CONFIG=configs/mediapipe/train_seqpar.yaml
PAD=", pad_to_frames: 304"
SPLIT=""
feeder() {
  echo "{data_path: $OUT/$SPLIT$1_data.npy, label_path: $OUT/$SPLIT$1_label.pkl$PAD}"
}
run() {
  local name=$1; shift
  echo "== $name: $*"
  if ! "$@" -m shift_gcn_torch.cli.train \
      --config "$CONFIG" --num_epoch 2 \
      --eval_interval 2 --save_interval 2 --log_interval 1 \
      --Experiment_name "$name" \
      --work_dir "$OUT/work" --model_saved_name "$OUT/save" \
      --train_feeder_args "$(feeder train)" \
      --test_feeder_args "$(feeder val)" \
      "${EXTRA[@]}" > "$OUT/$name.log" 2>&1; then
    tail -n 40 "$OUT/$name.log"
    echo "== $name failed"
    exit 1
  fi
  grep -E "Batch\(|Mean|Top1|clips/s" "$OUT/$name.log"
}
ONE=(--mesh_shape --shard_time false)
EXTRA=("${ONE[@]}")
run one python
EXTRA=(--mesh_shape "$N" 1 --shard_time false)
run "dp$N" python -m torch.distributed.run --standalone --nproc-per-node "$N"
EXTRA=(--mesh_shape $((N / 2)) 2)
run "seqpar$N" python -m torch.distributed.run --standalone --nproc-per-node "$N"
TP=("tp1x$N" "tp$((N / 2))x2")
EXTRA=(--mesh_shape 1 "$N" --shard_time false)
run "${TP[0]}" python -m torch.distributed.run --standalone --nproc-per-node "$N"
EXTRA=(--mesh_shape $((N / 2)) 2 --shard_time false)
run "${TP[1]}" python -m torch.distributed.run --standalone --nproc-per-node "$N"
for name in "dp$N" "seqpar$N" "${TP[@]}"; do
  EXTRA=("${ONE[@]}" --resume "$(ls "$OUT/save/$name"/*.pt)")
  run "$name-eval1" python
done
EDGES="edges$((N / 2))x2"
RING="ring1x$N"
CONFIG=configs/stgcn_edges.yaml PAD=""
EDGE_ONE=(--mesh_shape --edge_partition false)
EXTRA=("${EDGE_ONE[@]}")
run edges-one python
EXTRA=(--mesh_shape $((N / 2)) 2)
run "$EDGES" python -m torch.distributed.run --standalone --nproc-per-node "$N"
EXTRA=("${EDGE_ONE[@]}" --resume "$(ls "$OUT/save/$EDGES"/*.pt)")
run "$EDGES-eval1" python
CONFIG=configs/synthetic_ring.yaml SPLIT=ring_
EXTRA=("${EDGE_ONE[@]}")
run ring-one python
EXTRA=(--mesh_shape 1 "$N")
run "$RING" python -m torch.distributed.run --standalone --nproc-per-node "$N"
EXTRA=("${EDGE_ONE[@]}" --resume "$(ls "$OUT/save/$RING"/*.pt)")
run "$RING-eval1" python
python - "$OUT" "$N" "$LOSS_GATE" "$SCORE_GATE" <<'EOF'
import math, os, pickle, re, sys

import numpy as np

out, n, loss_gate, score_gate = sys.argv[1], sys.argv[2], *map(
    float, sys.argv[3:])
bad = []


def log(name):
    with open(os.path.join(out, f"{name}.log")) as f:
        return f.read()


def scores(name):
    with open(os.path.join(out, "work", name, "eval_results",
                           "best_acc.pkl"), "rb") as f:
        got = pickle.load(f)
    return np.stack([got[k] for k in sorted(got)])


# one-process run -> the multi-card runs held to it
groups = {"one": [f"dp{n}", f"seqpar{n}", f"tp1x{n}", f"tp{int(n) // 2}x2"],
          "edges-one": [f"edges{int(n) // 2}x2"], "ring-one": [f"ring1x{n}"]}
multi = [r for runs in groups.values() for r in runs]
first = {r: float(re.search(r"Batch\(0/\d+\) done\. Loss: ([-\d.naif]+)",
                            log(r)).group(1))
         for r in list(groups) + multi}
for one, runs in groups.items():
    for r in runs:
        gap = abs(first[r] - first[one]) / abs(first[one])
        print(f"[check] {r}: first-step loss {first[r]} vs one process "
              f"{first[one]}: {gap:.3g} relative (gate {loss_gate:g})")
        if not gap <= loss_gate:
            bad.append(f"{r} first-step loss")
for r in list(groups) + multi + [f"{r}-eval1" for r in multi]:
    test = float(re.findall(r"Mean test loss: (\S+?)\.?$", log(r), re.M)[-1])
    if not math.isfinite(test):
        bad.append(f"{r} test loss {test}")
for r in multi:
    got, want = scores(r), scores(f"{r}-eval1")
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    top = [re.findall(r"Top1: ([\d.]+)%", log(x))[-1]
           for x in (r, f"{r}-eval1")]
    print(f"[check] {r}: its scores vs one process evaluating its "
          f"checkpoint: max |diff| {gap:.3g} of their scale (gate "
          f"{score_gate:g}), top-1 {top[0]}% vs {top[1]}%, predictions "
          f"equal on {int((got.argmax(1) == want.argmax(1)).sum())} of "
          f"{len(got)} clips")
    if not gap <= score_gate or top[0] != top[1]:
        bad.append(f"{r} scores")
if bad:
    sys.exit(f"[check] failed: {bad}")
print("[check] all passed")
EOF
