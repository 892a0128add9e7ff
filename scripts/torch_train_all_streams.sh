#!/usr/bin/env bash
# Train all four modality streams with the PyTorch/CUDA port, then run the
# ensemble: the counterpart of scripts/train_all_streams.sh (the
# reference's sequential per-stream runs, run.sh + README instructions).
# Streams share the GPU one after another; each trains on the GPU (the
# train CLI's default) and fails without one.
#
# Usage: scripts/torch_train_all_streams.sh [CONFIG_DIR] [DATA_DIR]
#   (WORK_DIR from the environment, ./work_dir by default)
set -euo pipefail

CONFIG_DIR=${1:-configs/mediapipe}
DATA_DIR=${2:-./data/mediapipe}
WORK_DIR=${WORK_DIR:-./work_dir}

for stream in joint bone joint_motion bone_motion; do
    echo "=== training ${stream} ==="
    python -m shift_gcn_torch.cli.train --config "${CONFIG_DIR}/train_${stream}.yaml"
done

echo "=== ensemble ==="
exp_prefix=$(python - "$CONFIG_DIR" <<'EOF'
import sys, yaml
cfg = yaml.safe_load(open(f"{sys.argv[1]}/train_joint.yaml"))
print(cfg["Experiment_name"].rsplit("_joint", 1)[0])
EOF
)
python -m shift_gcn_torch.ensemble \
    --label "${DATA_DIR}/val_label.pkl" \
    --scores \
      "${WORK_DIR}/${exp_prefix}_joint/eval_results/best_acc.pkl" \
      "${WORK_DIR}/${exp_prefix}_bone/eval_results/best_acc.pkl" \
      "${WORK_DIR}/${exp_prefix}_joint_motion/eval_results/best_acc.pkl" \
      "${WORK_DIR}/${exp_prefix}_bone_motion/eval_results/best_acc.pkl" \
    --binary-report
