#!/usr/bin/env python
"""MonST3R-SLAM on PyTorch/CUDA: the dynamic-scene pipeline, with
`main_monster_slam.py`'s flags.

    python main_monster_torch.py --dataset <path> [--config config/base.yaml]
        [--save-as NAME] [--no-viz] [--calib intrinsics.yaml]
        [--checkpoint mast3r.pth] [--monst3r-checkpoint monst3r.pth]
        [--retrieval-checkpoint path.pth] [--raft-checkpoint raft.pth|random]
        [--sam2-checkpoint sam2.pt] [--max-frames N] [--seed S] [--device cuda|cpu]

MASt3R + MonST3R dual inference on shared MonST3R encoder features (X and C
from MonST3R, D and Q from MASt3R), the optical-flow-vs-ego-motion dynamic
mask before matching (with `use_dynamic_mask`, which this entry point turns
on unless the config sets it, and a calibration), refined on the host
(`refine_dynamic_mask_with_sam2`) under the temporal propagator by SAM2 or
by the native hysteresis + GrabCut refiner. The models compute in bf16 on
every device, with bf16 weights under `bf16_params`. Without a checkpoint
file a model gets random weights from `--seed` (MASt3R), `--seed + 1`
(MonST3R).

Optical flow: `--raft-checkpoint random` installs RAFT with random weights
from `--seed + 2` (for testing), an existing file loads a torch RAFT state
dict, a missing file falls back to OpenCV DIS on the host.

Mask refinement: `--sam2-checkpoint random` installs SAM2 at its test size
with random weights from `--seed + 3` (the video predictor's from `--seed +
4`; for testing), an existing file loads the official Hiera-B+ checkpoint;
with `sam2_video_predictor: true` in the config the video predictor refines
(`sam2_carry_memory` keeps its memory across frames), else the image
refiner. A missing file keeps the native refiner, as in the reference. SAM2
runs on the same device as the models.

Runs on the first CUDA card unless `--device cpu` is given; with `cuda` and
no card it fails. Outputs under logs/[<save-as>/] as `main_torch.py`'s, and
with the debug keys of the config the mask overlays under
logs/<dataset>/<sequence>/.

`main(argv)` parses the flags, builds the weights and installs the flow and
the refiner; `run(...)` drives the dataset, the SLAM loop and the export.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

import main_torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--config", default="config/base.yaml")
    parser.add_argument("--save-as", dest="save_as", default="default")
    parser.add_argument("--no-viz", dest="no_viz", action="store_true")
    parser.add_argument("--calib", default="")
    parser.add_argument("--checkpoint",
                        default="checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth")
    parser.add_argument("--monst3r-checkpoint",
                        default="checkpoints/MonST3R_PO-TA-S-W_ViTLarge_BaseDecoder_512_dpt.pth")
    parser.add_argument("--retrieval-checkpoint", default="")
    parser.add_argument("--raft-checkpoint",
                        default="checkpoints/Tartan-C-T-TSKH-spring540x960-M.pth",
                        help="torch RAFT weights; 'random' installs RAFT with random weights "
                        "(for testing); a missing file falls back to OpenCV DIS flow")
    parser.add_argument("--sam2-checkpoint", default="checkpoints/sam2_hiera_base_plus.pt",
                        help="official SAM2 weights (Hiera-B+) for the mask refinement; "
                        "'random' installs SAM2_TEST with random weights (for testing); a "
                        "missing file keeps the native hysteresis + GrabCut refiner")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def install_sam2(sam2_checkpoint: str, cfg: dict, seed: int, device):
    """SAM2 refinement of the dynamic mask, installed as the reference
    installs it: 'random' gives SAM2_TEST weights from `seed`, an existing
    file SAM2_BASE_PLUS through the checkpoint converter. With the config's
    `sam2_video_predictor` the video predictor refines (VIDEO_TEST weights
    from `seed + 1` with 'random'; `sam2_carry_memory` keeps its memory
    across frames), else the image refiner. The weights live on `device`. A
    missing file keeps the native hysteresis + GrabCut refiner. Returns the
    installed refiner, or None."""
    from monst3r_slam_torch.dynamic import mask as dyn_mask
    from monst3r_slam_torch.dynamic import sam2 as sam2_mod
    from monst3r_slam_torch.dynamic import sam2_video as sam2v

    use_video = bool(cfg.get("sam2_video_predictor", False))
    vparams = None
    if sam2_checkpoint == "random":
        scfg, vcfg = sam2_mod.SAM2_TEST, sam2v.VIDEO_TEST
        params = sam2_mod.init_sam2_params(torch.Generator(device=device).manual_seed(seed), scfg)
        if use_video:
            vparams = sam2v.init_video_params(
                torch.Generator(device=device).manual_seed(seed + 1), scfg, vcfg)
        origin = "(random init — testing only)"
    elif pathlib.Path(sam2_checkpoint).is_file():
        scfg, vcfg = sam2_mod.SAM2_BASE_PLUS, sam2v.VIDEO_BASE_PLUS
        if use_video:
            params, vparams = sam2v.video_params_from_torch(sam2_checkpoint, scfg, vcfg,
                                                            device=device)
        else:
            params = sam2_mod.sam2_params_from_torch(sam2_checkpoint, scfg, device=device)
        origin = f"from {sam2_checkpoint}"
    else:
        dyn_mask.set_mask_refiner(None)
        print(f"SAM2 checkpoint {sam2_checkpoint} not found — using the native "
              "hysteresis+GrabCut refiner")
        return None
    if use_video:
        refiner = sam2v.Sam2VideoRefiner(params, vparams, scfg, vcfg,
                                         carry_memory=bool(cfg.get("sam2_carry_memory", False)))
        print(f"SAM2 VIDEO-predictor refiner installed {origin}")
    else:
        refiner = sam2_mod.Sam2Refiner(params, scfg)
        print(f"SAM2 refiner installed {origin}")
    dyn_mask.set_mask_refiner(refiner)
    return refiner


def install_flow(raft_checkpoint: str, seed: int, device) -> None:
    """The dynamic mask's optical flow: RAFT (random weights from `seed`
    with 'random', or a torch RAFT file) as the flow estimator and the fused
    flow-error program, else OpenCV DIS on the host."""
    from monst3r_slam_torch.dynamic import mask as dyn_mask
    from monst3r_slam_torch.dynamic import raft as raft_mod

    if raft_checkpoint == "random":
        params = raft_mod.init_raft_params(torch.Generator(device=device).manual_seed(seed))
        origin = "(random init — testing only)"
    elif pathlib.Path(raft_checkpoint).is_file():
        params = raft_mod.raft_params_from_torch(raft_checkpoint, device=device)
        origin = f"from {raft_checkpoint}"
    else:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
        print(f"RAFT checkpoint {raft_checkpoint} not found — falling back to OpenCV DIS "
              "optical flow")
        return
    dyn_mask.set_flow_estimator(raft_mod.make_raft_flow_estimator(params))
    dyn_mask.set_flow_error_program(raft_mod.make_fused_flow_error_program(params))
    print(f"RAFT flow estimator installed {origin}")


def run(args: argparse.Namespace, cfg: dict, dual, dtype=torch.bfloat16):
    """Dataset -> prefetch -> the dual-model SLAM loop -> export, with the
    weights of `dual` (a DualParams on `args.device`) and the flow already
    installed (`install_flow`). Returns (slam, per-frame host ms)."""
    return main_torch.run(args, cfg, dual.mast3r, dual.mast3r_cfg, dtype=dtype, dual=dual)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.dynamic.inference import DualParams
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference

    cfg = load_config(args.config)
    cfg.setdefault("use_dynamic_mask", True)
    mast3r, mast3r_cfg = main_torch.load_or_random(args.checkpoint, MAST3R_512, args.seed,
                                                   args.device)
    monst3r, monst3r_cfg = main_torch.load_or_random(args.monst3r_checkpoint, MONST3R_512,
                                                     args.seed + 1, args.device)
    # As in the reference, the models compute in bf16 on every device, and
    # `bf16_params` stores their weights so.
    if cfg.get("bf16_params", True):
        mast3r, monst3r = cast_params_for_inference(mast3r), cast_params_for_inference(monst3r)
    install_flow(args.raft_checkpoint, args.seed + 2, args.device)
    install_sam2(args.sam2_checkpoint, cfg, args.seed + 3, args.device)
    return run(args, cfg, DualParams(monst3r, monst3r_cfg, mast3r, mast3r_cfg))


if __name__ == "__main__":
    main()
