#!/bin/bash
# The PyTorch port's copy of scripts/eval_tum2.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# TUM dynamic-sequence sweep with the MonST3R pipeline (reference
# scripts/eval_tum2.sh equivalent, no SLURM).
# Usage: scripts/eval_tum2_torch.sh <datasets_root> [config]
set -e
ROOT=${1:?usage: eval_tum2_torch.sh <datasets_root> [config]}
CONFIG=${2:-config/eval_calib.yaml}
. "$(dirname "$0")/tum2_seqs.sh"
for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_monster_torch.py --dataset "$ROOT/tum2/$seq" --config "$CONFIG" --no-viz
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/tum2/$seq/groundtruth.txt" \
        --est "logs/$seq.txt" | tee -a logs/tum2_ate_rmse.txt
done
