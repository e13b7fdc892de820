#!/bin/bash
# The PyTorch port's copy of scripts/eval_7_scenes.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# 7-Scenes evaluation sweep (reference scripts/eval_7_scenes.sh, no SLURM)
# Usage: scripts/eval_7_scenes_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_7_scenes_torch.sh <datasets_root> [--no-calib]}
CONFIG=config/eval_calib.yaml
[ "$2" = "--no-calib" ] && CONFIG=config/eval_no_calib.yaml

SEQS=(chess fire heads office pumpkin redkitchen stairs)

for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_torch.py --dataset "$ROOT/7-scenes/$seq/seq-01" --config "$CONFIG" --no-viz
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/7-scenes/$seq/seq-01/groundtruth.txt" \
        --est "logs/seq-01.txt" | tee -a logs/7scenes_ate_rmse.txt
done
