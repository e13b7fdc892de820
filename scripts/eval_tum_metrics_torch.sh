#!/bin/bash
# The PyTorch port's copy of scripts/eval_tum_metrics.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# Post-hoc ATE over saved TUM trajectories (reference eval_tum_metrics.sh,
# evo_ape -as replaced by the built-in Umeyama eval_ate_torch.py).
# Usage: scripts/eval_tum_metrics_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_tum_metrics_torch.sh <datasets_root> [--no-calib]}
SUB=calib; [ "${2:-}" = "--no-calib" ] && SUB=no_calib
SEQS=(rgbd_dataset_freiburg1_360 rgbd_dataset_freiburg1_desk \
      rgbd_dataset_freiburg1_desk2 rgbd_dataset_freiburg1_floor \
      rgbd_dataset_freiburg1_plant rgbd_dataset_freiburg1_room \
      rgbd_dataset_freiburg1_rpy rgbd_dataset_freiburg1_teddy \
      rgbd_dataset_freiburg1_xyz)
for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/tum/$seq/groundtruth.txt" \
        --est "logs/tum/$SUB/$seq/$seq.txt"
done
