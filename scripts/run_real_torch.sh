#!/bin/bash
# The PyTorch port's copy of scripts/run_real.sh: one-command real-weights
# drill, checkpoint + TUM fr1_desk -> run main_torch.py with calibration ->
# ATE vs ground truth (scripts/eval_ate_torch.py) -> 5% parity verdict
# against BASELINE.md (reference: scripts/eval_tum.sh:46-63 +
# results/tum_ate_rmse.txt fr1_desk = 0.016136). No JAX is needed.
#
# Usage:
#   scripts/run_real_torch.sh                      # download + run fr1_desk
#   scripts/run_real_torch.sh --dataset D --checkpoint C [--baseline 0.016136]
#   scripts/run_real_torch.sh --synthetic [--device cpu] [--max-frames N]
#       smoke test: a TINY random checkpoint in the reference's pickle
#       format (scripts/make_tiny_checkpoint_torch.py) and a synthetic
#       TUM-layout scene (scripts/make_synthetic_tum.py), both under
#       build/run_real_torch_synth/; exercises the identical stitching and
#       skips the parity verdict (random weights carry no geometry).
#   --device cuda (default) or cpu is passed to main_torch.py.
set -euo pipefail
cd "$(dirname "$0")/.."

CHECKPOINT=checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth
CKPT_URL=https://download.europe.naverlabs.com/ComputerVision/MASt3R/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth
DATASET=datasets/tum/rgbd_dataset_freiburg1_desk
DATA_URL=https://cvg.cit.tum.de/rgbd/dataset/freiburg1/rgbd_dataset_freiburg1_desk.tgz
BASELINE=0.016136   # BASELINE.md fr1_desk (results/tum_ate_rmse.txt:22)
CONFIG=config/eval_calib.yaml
SYNTHETIC=0
MAX_FRAMES=0
DEVICE=cuda

while [[ $# -gt 0 ]]; do
  case "$1" in
    --synthetic) SYNTHETIC=1; shift ;;
    --dataset) DATASET=$2; shift 2 ;;
    --checkpoint) CHECKPOINT=$2; shift 2 ;;
    --baseline) BASELINE=$2; shift 2 ;;
    --config) CONFIG=$2; shift 2 ;;
    --max-frames) MAX_FRAMES=$2; shift 2 ;;
    --device) DEVICE=$2; shift 2 ;;
    *) echo "unknown arg: $1" >&2; exit 2 ;;
  esac
done

if [[ $SYNTHETIC -eq 1 ]]; then
  CHECKPOINT=build/run_real_torch_synth/ckpt.pth
  DATASET=build/run_real_torch_synth/tum/rgbd_dataset_freiburg1_synth
  mkdir -p build/run_real_torch_synth
  [[ -f $CHECKPOINT ]] || python scripts/make_tiny_checkpoint_torch.py "$CHECKPOINT"
  [[ -f $DATASET/rgb.txt ]] || python scripts/make_synthetic_tum.py "$DATASET" 8
  CONFIG=config/eval_no_calib.yaml   # synthetic scene has no real fr1 optics
fi

# 1. Checkpoint (download once; ~2.2 GB)
if [[ ! -f $CHECKPOINT ]]; then
  echo "downloading MASt3R checkpoint -> $CHECKPOINT"
  mkdir -p "$(dirname "$CHECKPOINT")"
  wget -q --show-progress -O "$CHECKPOINT" "$CKPT_URL"
fi

# 2. Dataset (download + extract once)
if [[ ! -f $DATASET/rgb.txt ]]; then
  echo "downloading TUM fr1_desk -> $DATASET"
  mkdir -p "$(dirname "$DATASET")"
  wget -q --show-progress -O "${TMPDIR:-/tmp}/fr1_desk.tgz" "$DATA_URL"
  tar -xzf "${TMPDIR:-/tmp}/fr1_desk.tgz" -C "$(dirname "$DATASET")"
fi

# 3. SLAM run (conversion happens inside main_torch.py's load_checkpoint)
SAVE_AS=real_drill_torch
RUN_ARGS=(--dataset "$DATASET" --config "$CONFIG" --no-viz \
          --checkpoint "$CHECKPOINT" --save-as "$SAVE_AS" --device "$DEVICE")
[[ $MAX_FRAMES -gt 0 ]] && RUN_ARGS+=(--max-frames "$MAX_FRAMES")
python main_torch.py "${RUN_ARGS[@]}"

SEQ=$(basename "$DATASET")
EST=logs/$SAVE_AS/$SEQ.txt
if [[ $SYNTHETIC -eq 1 ]]; then
  # random weights keyframe rarely -> evaluate the per-frame trajectory so
  # the association/alignment path is actually exercised
  EST=logs/$SAVE_AS/${SEQ}_full.txt
fi
[[ -f $EST ]] || { echo "FAIL: trajectory $EST not written" >&2; exit 1; }

# 4. ATE vs ground truth (evo_ape-equivalent Umeyama Sim(3) alignment)
ATE_OUT=$(python scripts/eval_ate_torch.py --gt "$DATASET/groundtruth.txt" --est "$EST")
echo "$ATE_OUT"
RMSE=$(echo "$ATE_OUT" | grep -oE 'rmse[ =:]+[0-9.eE+-]+' | grep -oE '[0-9.eE+-]+$' | head -1)

# 5. Verdict
if [[ $SYNTHETIC -eq 1 ]]; then
  echo "SYNTHETIC smoke: stitching OK (rmse=$RMSE; parity verdict needs real weights)"
  echo "real invocation: scripts/run_real_torch.sh    # downloads ckpt + fr1_desk"
  exit 0
fi
python - "$RMSE" "$BASELINE" <<'EOF'
import sys
rmse, base = float(sys.argv[1]), float(sys.argv[2])
ratio = rmse / base
ok = rmse <= base * 1.05
print(f"ATE rmse={rmse:.6f} baseline={base:.6f} ratio={ratio:.3f} "
      f"-> {'PASS (within 5%)' if ok else 'FAIL (>5% above reference)'}")
sys.exit(0 if ok else 1)
EOF
