#!/usr/bin/env python
"""Write a TINY-width MASt3R checkpoint in the reference's on-disk layout
(torch.save of {'args': Namespace(model=<constructor string>), 'model':
state dict}) with random weights from a seed, using only the PyTorch port,
for smoke runs of the port's entry points (scripts/run_real_torch.sh
--synthetic). Either package's `load_checkpoint` reads it.

Usage: python scripts/make_tiny_checkpoint_torch.py <out.pth> [--seed N]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from monst3r_slam_torch.models.config import TINY
    from monst3r_slam_torch.models.convert import save_checkpoint
    from monst3r_slam_torch.models.init import init_params

    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(args.out, init_params(torch.Generator().manual_seed(args.seed), TINY), TINY)
    print(f"wrote TINY checkpoint {args.out}")


if __name__ == "__main__":
    main()
