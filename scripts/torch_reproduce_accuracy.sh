#!/usr/bin/env bash
# Turnkey BASELINE.md accuracy reproduction with the PyTorch/CUDA port
# (shift_gcn_torch): one command from raw inputs to the 4-stream ensemble
# metrics table compared against the reference's published numbers
# (README.md:47-60, TRAINING_REPORT.md:209-341).  The counterpart of
# scripts/reproduce_accuracy.sh, stage for stage.  Every path/epoch
# argument is defaulted so it can run unattended the day real data mounts.
#
# Modes:
#   scripts/torch_reproduce_accuracy.sh /path/to/ntu_videos
#       REAL mode: MediaPipe gendata (--ntu-mode, xsub split) -> bone/motion
#       modality derivation -> 4-stream 140-epoch training -> ensemble ->
#       metrics vs BASELINE.md.  Needs the NTU RGB+D video set + the
#       mediapipe package.
#   scripts/torch_reproduce_accuracy.sh            (no argument)
#       SYNTHETIC mode: generates production-SHAPED synthetic joint data
#       ((N,3,300,33,1) + {part}_label.pkl), derives the real bone/motion
#       modalities, trains all four streams for $EPOCHS epochs, ensembles,
#       and prints the same table: a harness smoke that proves the whole
#       chain runs end to end.  Accuracy numbers in this mode are
#       meaningless; the artifact SHAPES are the point.
#
# Training runs on the GPU (the train CLI's default) and fails without
# one; there is no CPU fallback.  A CPU run passes `--torch-device|cpu`
# in EXTRA_TRAIN_ARGS.
#
# Env knobs: DATA_DIR (./data/mediapipe), WORK_DIR (./work_dir),
# EPOCHS (140 real / 3 synthetic), N_TRAIN/N_VAL (synthetic sizes),
# EXTRA_TRAIN_ARGS (extra cli.train flags, '|'-delimited).
#
# Re-entry safe: every stream trains with `--resume auto`, so an
# interrupted unattended run (preemption, worker crash) just reruns this
# script.  A finished stream skips: its final checkpoint,
# ${WORK_DIR}/save_models/mediapipe_ShiftGCN_<stream>/
# mediapipe_ShiftGCN_<stream>-<EPOCHS-1>-<step>.pt, resumes past the last
# epoch, and a stream killed DURING its final eval re-evaluates without
# retraining (Trainer.start's missing-pickle guard).  Checkpoints are
# written to a temporary file and renamed, so a stream killed during a
# save resumes from its previous checkpoint.  Data stages skip on
# completion markers written only after they finish
# (tests/test_torch_runbook.py exercises kill + rerun).
set -euo pipefail
cd "$(dirname "$0")/.."

VIDEO_DIR="${1:-}"
DATA_DIR="${DATA_DIR:-./data/mediapipe}"
WORK_DIR="${WORK_DIR:-./work_dir}"

if [[ -n "${VIDEO_DIR}" ]]; then
    MODE=real
    EPOCHS="${EPOCHS:-140}"
else
    MODE=synthetic
    EPOCHS="${EPOCHS:-3}"
    N_TRAIN="${N_TRAIN:-64}"
    N_VAL="${N_VAL:-64}"
fi
echo "== torch_reproduce_accuracy: mode=${MODE} data=${DATA_DIR} epochs=${EPOCHS} =="

# ---------------------------------------------------------------- stage 1
# joint-stream data: MediaPipe extraction (real) or synthetic generator.
# Re-entry: skip on the stage-completion marker (written only AFTER the
# stage finishes — bare artifact existence is not interruption-safe:
# np.save / open_memmap create files before their contents are complete)
# or on a fully-present pre-existing artifact set (manual gendata runs).
STAGE1_DONE="${DATA_DIR}/.stage1.done"
if [[ -f "${STAGE1_DONE}" ]] || [[ -f "${DATA_DIR}/train_data_joint.npy" \
      && -f "${DATA_DIR}/val_data_joint.npy" \
      && -f "${DATA_DIR}/train_label.pkl" \
      && -f "${DATA_DIR}/val_label.pkl" ]]; then
    echo "== stage 1: joint data already present, skipping gendata =="
elif [[ "${MODE}" == real ]]; then
    python -m shift_gcn_torch.data.gendata.mediapipe \
        --video-dir "${VIDEO_DIR}" --out-dir "${DATA_DIR}" \
        --ntu-mode --benchmark xsub --subsample-ratio 3.0
else
    python - "$DATA_DIR" "$N_TRAIN" "$N_VAL" <<'EOF'
import os, pickle, sys
import numpy as np

out, n_train, n_val = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.makedirs(out, exist_ok=True)
rng = np.random.default_rng(0)
for part, n in (("train", n_train), ("val", n_val)):
    labels = rng.integers(0, 2, n)
    data = (rng.standard_normal((n, 3, 300, 33, 1)) * 0.1).astype(np.float32)
    drift = np.linspace(0, 1, 300)[:, None, None]
    for i in range(n):
        if labels[i] == 1:
            data[i, 1] += drift
    np.save(os.path.join(out, f"{part}_data_joint.npy"), data)
    names = [f"S001C001P001R001A{43 if y else 1:03d}_{i}.skeleton"
             for i, y in enumerate(labels)]
    with open(os.path.join(out, f"{part}_label.pkl"), "wb") as f:
        pickle.dump((names, labels.tolist()), f)
    print(f"synthetic {part}: {data.shape}")
EOF
fi
touch "${STAGE1_DONE}"

# ---------------------------------------------------------------- stage 2
# bone + motion modality derivation (the real pipeline in both modes).
# Re-entry: marker ONLY — the memmap writer (modality_cli) preallocates
# full-size .npy files before filling them, so a killed run leaves
# zero-tailed artifacts that a bare existence check would wrongly accept.
# Rederiving is minutes, never hours; correctness wins.
STAGE2_DONE="${DATA_DIR}/.stage2.done"
if [[ -f "${STAGE2_DONE}" ]]; then
    echo "== stage 2: modality artifacts already present, skipping =="
else
    python -m shift_gcn_torch.data.gendata.modality_cli \
        --data-dir "${DATA_DIR}" --graph mediapipe_pose --sets train val
    touch "${STAGE2_DONE}"
fi

# ---------------------------------------------------------------- stage 3
# 4-stream training from the shipped reference-matrix configs
# synthetic mode compresses eval/save to the last epoch (chain smoke);
# real mode keeps the configs' eval_interval=5 — best_acc.pkl must hold
# the BEST-epoch scores (the protocol the BASELINE numbers come from,
# reference main.py:496-502), not the final epoch's
if [[ "${MODE}" == real ]]; then
    INTERVALS=()
else
    INTERVALS=(--eval_interval "${EPOCHS}" --save_interval "${EPOCHS}")
fi
# EXTRA_TRAIN_ARGS is '|'-delimited (args like --model_args carry a
# YAML dict with spaces, so whitespace splitting would fragment them)
EXTRA=()
if [[ -n "${EXTRA_TRAIN_ARGS:-}" ]]; then
    IFS='|' read -r -a EXTRA <<< "${EXTRA_TRAIN_ARGS}"
fi
for stream in joint bone joint_motion bone_motion; do
    echo "=== training ${stream} (${EPOCHS} epochs) ==="
    python -m shift_gcn_torch.cli.train \
        --config "configs/mediapipe/train_${stream}.yaml" \
        --work_dir "${WORK_DIR}" \
        --model_saved_name "${WORK_DIR}/save_models" \
        --resume auto \
        --num_epoch "${EPOCHS}" ${INTERVALS[@]+"${INTERVALS[@]}"} \
        --train_feeder_args "{data_path: ${DATA_DIR}/train_data_${stream}.npy, label_path: ${DATA_DIR}/train_label.pkl}" \
        --test_feeder_args "{data_path: ${DATA_DIR}/val_data_${stream}.npy, label_path: ${DATA_DIR}/val_label.pkl}" \
        ${EXTRA[@]+"${EXTRA[@]}"}
done

# ---------------------------------------------------------------- stage 4
# ensemble + comparison against BASELINE.md
python - "$DATA_DIR" "$WORK_DIR" "$MODE" <<'EOF'
import sys

from shift_gcn_torch.ensemble import run_ensemble

data_dir, work_dir, mode = sys.argv[1:4]
streams = ["joint", "bone", "joint_motion", "bone_motion"]
result = run_ensemble(
    f"{data_dir}/val_label.pkl",
    [f"{work_dir}/mediapipe_ShiftGCN_{s}/eval_results/best_acc.pkl"
     for s in streams],
    binary_report=True)

BASELINE = {  # BASELINE.md (README.md:47-60, TRAINING_REPORT.md:318-341)
    "ensemble top-1": 0.9977,
    "fall precision": 0.9577,
    "fall recall": 0.9022,
    "fall f1": 0.9291,
}
b = result.get("binary", {})
measured = {
    "ensemble top-1": result["top1"],
    "fall precision": b.get("precision", float("nan")),
    "fall recall": b.get("recall", float("nan")),
    "fall f1": b.get("f1", float("nan")),
}
print("\n== metrics vs BASELINE.md ==")
print(f"{'metric':<18}{'measured':>10}{'baseline':>10}{'delta':>9}")
for k, base in BASELINE.items():
    m = measured[k]
    print(f"{k:<18}{m:>10.4f}{base:>10.4f}{m - base:>+9.4f}")
if mode == "synthetic":
    print("\n[synthetic mode: chain smoke only — accuracy numbers are "
          "meaningless; rerun with a video dir for the real measurement]")
else:
    ok = measured["ensemble top-1"] >= 0.997
    print("\nPASS: ensemble >= 99.7%" if ok
          else "\nFAIL: ensemble below the 99.7% BASELINE bar")
    sys.exit(0 if ok else 1)
EOF
