#!/bin/bash
# The PyTorch port's copy of scripts/eval_bonn_metrics.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# Post-hoc ATE over saved (transformed) Bonn trajectories (reference
# eval_bonn_metrics.sh; evo_ape -as -> eval_ate_torch.py). Run
# scripts/transform_bonn_estimates.sh first.
# Usage: scripts/eval_bonn_metrics_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_bonn_metrics_torch.sh <datasets_root> [--no-calib]}
SUB=calib; [ "${2:-}" = "--no-calib" ] && SUB=no_calib
. "$(dirname "$0")/bonn_seqs.sh"
for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/bonn/$seq/groundtruth.txt" \
        --est "logs/bonn_transformed/$SUB/$seq/$seq.txt"
done
