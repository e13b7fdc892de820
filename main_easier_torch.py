#!/usr/bin/env python
"""Easi3R-SLAM on PyTorch/CUDA: the attention-reweighted dynamic-scene
pipeline, with `main_easier_slam.py`'s flags.

    python main_easier_torch.py --dataset <path> [--config config/base.yaml]
        [--save-as NAME] [--no-viz] [--calib intrinsics.yaml]
        [--checkpoint mast3r.pth] [--easi3r-checkpoint dust3r.pth]
        [--retrieval-checkpoint path.pth] [--k-mad 2.0]
        [--max-frames N] [--seed S] [--device cuda|cpu]

Easi3R is training-free dynamic handling for DUSt3R-family models: the first
pass of each pair decode collects the cross-attention every token receives
from the other view, tokens that receive anomalously little (under median -
`--k-mad` x MAD) are flagged dynamic, and a second pass re-weights the
cross-attention against them and gives the pointmaps (dynamic/easi3r.py).
X and C come from that double inference, D and Q from the MASt3R decoder on
the same Easi3R encoder features, and the attention masks zero C and Q on
the dynamic pixels. No optical flow or mask refinement: `use_dynamic_mask`
is turned off.

The models compute in bf16 on every device, with bf16 weights under
`bf16_params`. Without a checkpoint file a model gets random weights from
`--seed` (MASt3R), `--seed + 1` (Easi3R, at MONST3R_512: the DUSt3R
architecture, a DPT head without descriptors). Runs on the first CUDA card
unless `--device cpu` is given; with `cuda` and no card it fails. Unless
`--no-viz` is given the live viewer serves the reconstruction at
http://127.0.0.1:8089/, as in `main_torch.py`. Outputs under
logs/[<save-as>/] as `main_torch.py`'s.

`main(argv)` parses the flags and builds the weights; `run(...)` drives the
dataset, the SLAM loop and the export.
"""

from __future__ import annotations

import argparse

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
    parser.add_argument("--easi3r-checkpoint",
                        default="checkpoints/DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth",
                        help="DUSt3R-architecture weights driven through the two-pass "
                        "attention-reweighted Easi3R inference")
    parser.add_argument("--retrieval-checkpoint", default="")
    parser.add_argument("--k-mad", type=float, default=2.0,
                        help="MAD multiplier for the attention dynamic mask")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def run(args: argparse.Namespace, cfg: dict, easi3r, dtype=torch.bfloat16):
    """Dataset -> prefetch -> the Easi3R SLAM loop -> export, with the
    weights of `easi3r` (an EasiParams on `args.device`). Returns (slam,
    per-frame host ms)."""
    cfg = dict(cfg, use_dynamic_mask=False)  # the masks come from the attention
    return main_torch.run(args, cfg, easi3r.mast3r, easi3r.mast3r_cfg, dtype=dtype,
                          easi3r=easi3r)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.dynamic.inference import EasiParams
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference

    cfg = load_config(args.config)
    mast3r, mast3r_cfg = main_torch.load_or_random(args.checkpoint, MAST3R_512, args.seed,
                                                   args.device)
    easi, easi_cfg = main_torch.load_or_random(args.easi3r_checkpoint, MONST3R_512,
                                               args.seed + 1, args.device)
    # As in the reference, the models compute in bf16 on every device, and
    # `bf16_params` stores their weights so.
    if cfg.get("bf16_params", True):
        mast3r, easi = cast_params_for_inference(mast3r), cast_params_for_inference(easi)
    return run(args, cfg, EasiParams(easi, easi_cfg, mast3r, mast3r_cfg, k_mad=args.k_mad))


if __name__ == "__main__":
    main()
