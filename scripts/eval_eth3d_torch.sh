#!/bin/bash
# The PyTorch port's copy of scripts/eval_eth3d.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# ETH3D SLAM evaluation sweep (reference scripts/eval_eth3d.sh, no SLURM)
# Usage: scripts/eval_eth3d_torch.sh <datasets_root>
set -e
ROOT=${1:?usage: eval_eth3d_torch.sh <datasets_root>}
CONFIG=${2:-config/eth3d.yaml}

SEQS=(cables_1 camera_shake_1 ceiling_1 desk_3 einstein_1 einstein_2 \
      mannequin_3 mannequin_4 motion_1 planar_2 plant_scene_1 sfm_house_loop \
      sofa_1 table_3)

for seq in "${SEQS[@]}"; do
    echo "=== $seq ==="
    python main_torch.py --dataset "$ROOT/eth3d/$seq" --config "$CONFIG" --no-viz
    python scripts/eval_ate_torch.py \
        --gt "$ROOT/eth3d/$seq/groundtruth.txt" \
        --est "logs/$seq.txt" | tee -a logs/eth3d_ate_rmse.txt
done
