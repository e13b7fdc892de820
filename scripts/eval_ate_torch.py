#!/usr/bin/env python
"""ATE RMSE of saved TUM-format trajectories against ground truth, with the
PyTorch port's evaluation (no JAX): the counterpart of scripts/eval_ate.py,
with the same flags, the same printed line and the same plot.

It replaces the reference's `evo_ape tum gt.txt est.txt -as` calls
(scripts/eval_tum.sh:46-63) with the built-in Umeyama Sim(3) alignment.

Usage: python scripts/eval_ate_torch.py --gt groundtruth.txt --est logs/.../seq.txt
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from monst3r_slam_torch.app.evaluate import (  # noqa: E402
    associate,
    ate_rmse,
    load_tum_trajectory,
    umeyama_alignment,
)


def save_plot(path, gt_t, gt_xyz, est_t, est_xyz, with_scale, max_diff=0.02,
              mode="xz", title=""):
    """The aligned trajectories in one plane (`evo_ape --plot --plot_mode
    xz --save_plot out.pdf`), aligned on the same timestamp-matched pairs as
    the RMSE."""
    ei, gi = associate(est_t, gt_t, max_diff)
    s, R, t = umeyama_alignment(est_xyz[ei], gt_xyz[gi], with_scale)
    est_a = (s * (R @ est_xyz.T)).T + t
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax_idx = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[mode]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt_xyz[:, ax_idx[0]], gt_xyz[:, ax_idx[1]], color="0.4", ls="--",
            label="ground truth")
    ax.plot(est_a[:, ax_idx[0]], est_a[:, ax_idx[1]], color="tab:blue",
            label="estimate (aligned)")
    ax.set_xlabel(mode[0])
    ax.set_ylabel(mode[1])
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt", required=True)
    p.add_argument("--est", required=True)
    p.add_argument("--max-diff", type=float, default=0.02)
    p.add_argument("--no-scale", action="store_true")
    p.add_argument("--save-plot", default=None, help="write an aligned-trajectory plot (pdf/png)")
    p.add_argument("--plot-mode", default="xz", choices=["xy", "xz", "yz"])
    args = p.parse_args(argv)

    gt_t, gt_xyz, _ = load_tum_trajectory(args.gt)
    est_t, est_xyz, _ = load_tum_trajectory(args.est)
    rmse, n = ate_rmse(est_t, est_xyz, gt_t, gt_xyz, max_diff=args.max_diff,
                       with_scale=not args.no_scale)
    print(f"ate_rmse {rmse:.6f} m  ({n} matched poses)")
    if args.save_plot:
        save_plot(args.save_plot, gt_t, gt_xyz, est_t, est_xyz, not args.no_scale,
                  max_diff=args.max_diff, mode=args.plot_mode, title=f"ATE RMSE {rmse:.4f} m")
        print(f"plot saved to {args.save_plot}")


if __name__ == "__main__":
    main()
