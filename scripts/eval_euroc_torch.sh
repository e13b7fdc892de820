#!/bin/bash
# The PyTorch port's copy of scripts/eval_euroc.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# EuRoC MAV evaluation sweep (reference scripts/eval_euroc.sh, no SLURM)
# Usage: scripts/eval_euroc_torch.sh <datasets_root> [--no-calib]
set -e
ROOT=${1:?usage: eval_euroc_torch.sh <datasets_root> [--no-calib]}
CONFIG=config/eval_calib.yaml
[ "$2" = "--no-calib" ] && CONFIG=config/eval_no_calib.yaml

SEQS=(MH_01_easy MH_02_easy MH_03_medium MH_04_difficult MH_05_difficult \
      V1_01_easy V1_02_medium V1_03_difficult V2_01_easy V2_02_medium V2_03_difficult)

for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_torch.py --dataset "$ROOT/euroc/$seq" --config "$CONFIG" --no-viz
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/euroc/$seq/mav0/state_groundtruth_estimate0/data.tum" \
        --est "logs/$seq.txt" | tee -a logs/euroc_ate_rmse.txt
done
