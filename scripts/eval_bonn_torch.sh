#!/bin/bash
# The PyTorch port's copy of scripts/eval_bonn.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# Bonn dynamic-scene evaluation sweep (reference scripts/eval_bonn.sh, no SLURM)
# Usage: scripts/eval_bonn_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_bonn_torch.sh <datasets_root> [--no-calib]}
CONFIG=config/eval_calib.yaml
[ "$2" = "--no-calib" ] && CONFIG=config/eval_no_calib.yaml

SEQS=(rgbd_bonn_removing_nonobstructing_box2 rgbd_bonn_removing_obstructing_box \
      rgbd_bonn_moving_nonobstructing_box2 rgbd_bonn_crowd rgbd_bonn_kidnapping_box \
      rgbd_bonn_balloon rgbd_bonn_placing_nonobstructing_box rgbd_bonn_synchronous \
      rgbd_bonn_static_close_far rgbd_bonn_synchronous2 \
      rgbd_bonn_moving_nonobstructing_box rgbd_bonn_balloon_tracking)

for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_torch.py --dataset "$ROOT/bonn/$seq" --config "$CONFIG" --no-viz
    python scripts/prepare_bonn.py \
        --groundtruth_path "$ROOT/bonn/$seq/groundtruth.txt" \
        --estimated_path "logs/$seq.txt" \
        --output_path "logs/bonn_transformed/$seq.txt"
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/bonn/$seq/groundtruth.txt" \
        --est "logs/bonn_transformed/$seq.txt" | tee -a logs/bonn_ate_rmse.txt
done
