#!/bin/bash
# The PyTorch port's copy of scripts/eval_tum.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# TUM fr1 evaluation sweep (reference scripts/eval_tum.sh equivalent, no SLURM)
# Usage: scripts/eval_tum_torch.sh <datasets_root> [config]
set -e
ROOT=${1:?usage: eval_tum_torch.sh <datasets_root> [config]}
CONFIG=${2:-config/eval_calib.yaml}

SEQS=(rgbd_dataset_freiburg1_360 rgbd_dataset_freiburg1_desk \
      rgbd_dataset_freiburg1_desk2 rgbd_dataset_freiburg1_floor \
      rgbd_dataset_freiburg1_plant rgbd_dataset_freiburg1_room \
      rgbd_dataset_freiburg1_rpy rgbd_dataset_freiburg1_teddy \
      rgbd_dataset_freiburg1_xyz)

for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_torch.py --dataset "$ROOT/tum/$seq" --config "$CONFIG" --no-viz
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/tum/$seq/groundtruth.txt" \
        --est "logs/$seq.txt" | tee -a logs/tum_ate_rmse.txt
done
