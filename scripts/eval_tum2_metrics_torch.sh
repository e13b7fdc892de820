#!/bin/bash
# The PyTorch port's copy of scripts/eval_tum2_metrics.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# Post-hoc ATE over saved TUM dynamic trajectories (reference
# eval_tum2_metrics.sh; evo_ape -as -> eval_ate_torch.py).
# Usage: scripts/eval_tum2_metrics_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_tum2_metrics_torch.sh <datasets_root> [--no-calib]}
SUB=calib; [ "${2:-}" = "--no-calib" ] && SUB=no_calib
. "$(dirname "$0")/tum2_seqs.sh"
for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/tum2/$seq/groundtruth.txt" \
        --est "logs/tum2/$SUB/$seq/$seq.txt"
done
