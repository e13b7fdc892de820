#!/bin/bash
# The PyTorch port's copy of scripts/run_main_monster_slam.sh: the same steps through the port's
# entry points (main_torch.py, main_monster_torch.py, scripts/eval_ate_torch.py).
# Dynamic MonST3R pipeline on Bonn person_tracking
# (reference scripts/run_main_monster_slam.sh, no SLURM)
set -e
ROOT=${1:?usage: run_main_monster_slam_torch.sh <datasets_root>}
python main_monster_torch.py \
    --dataset "$ROOT/bonn/rgbd_bonn_person_tracking" \
    --config config/calib.yaml
