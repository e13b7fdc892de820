#!/usr/bin/env python
"""Two frames -> MASt3R pointmaps and dense matches with the PyTorch port:
the counterpart of scripts/demo_pair.py, with the same flags plus
`--device`.

Both images are resized to width 512, encoded and decoded by MAST3R_512
(random weights from `--seed`, or `--checkpoint`, a reference torch
checkpoint) in bf16, as the reference computes, and matched by the tiled
matcher: on the card through the attention and tile-match kernels, on the
CPU through their plain versions.

Usage:
  python scripts/demo_pair_torch.py --img1 a.png --img2 b.png \\
      [--checkpoint ckpt.pth] [--out out_dir] [--device cuda|cpu]

Outputs: out_dir/pair.ply (both pointmaps, coloured by their images) and
matches.npz (idx_1_to_2, valid, conf1, conf2), and the match fraction (with
the kernels' launch counts on the card) on stdout.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img1", required=True)
    p.add_argument("--img2", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--out", default="logs/demo_pair")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import cv2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    from monst3r_slam_torch.app.evaluate import save_ply
    from monst3r_slam_torch.data.preprocess import resize_img
    from monst3r_slam_torch.models import mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.ops import attention, matching, matching_pallas, matching_tiled

    def load(path):
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        return resize_img(img.astype(np.float32) / 255.0, 512)

    r1, r2 = load(args.img1), load(args.img2)
    img1 = torch.from_numpy(r1["img"]).to(args.device)
    img2 = torch.from_numpy(r2["img"]).to(args.device)
    h, w = img1.shape[1:3]

    ckpt = pathlib.Path(args.checkpoint) if args.checkpoint else None
    if ckpt and ckpt.is_file():
        from monst3r_slam_torch.models.convert import load_checkpoint

        params, cfg = load_checkpoint(str(ckpt), device=args.device)
    else:
        from monst3r_slam_torch.models.init import init_params

        print("WARNING: no checkpoint — random weights (geometry meaningless)")
        params = init_params(torch.Generator(device=args.device).manual_seed(args.seed),
                             MAST3R_512)
        cfg = MAST3R_512

    a0, b0 = attention.fused_attention.launches, matching_pallas.tile_match_kernel.launches
    with torch.no_grad():
        feat1, pos1 = model_api.encode(params, cfg, img1)
        feat2, pos2 = model_api.encode(params, cfg, img2)
        out = model_api.decode(params, cfg, feat1, pos1, feat2, pos2, (h, w))
        idx, valid = matching_tiled.match(
            out.X1, out.X2, out.D1, out.D2, cfg=matching.MatchingConfig(),
            tcfg=matching_tiled.TiledConfig(), use_kernel=img1.is_cuda)
    match_frac = float(valid.float().mean())
    print(f"pointmaps: {tuple(out.X1.shape)}, match fraction: {match_frac:.3f}")
    if img1.is_cuda:
        print(f"kernel launches: attention {attention.fused_attention.launches - a0}, "
              f"tile_match {matching_pallas.tile_match_kernel.launches - b0}")

    def host(x):
        return x.float().cpu().numpy()

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    pts = np.concatenate([host(out.X1).reshape(-1, 3), host(out.X2).reshape(-1, 3)])
    cols = np.concatenate([r1["unnormalized_img"].reshape(-1, 3),
                           r2["unnormalized_img"].reshape(-1, 3)])
    save_ply(out_dir / "pair.ply", pts, cols)
    np.savez(out_dir / "matches.npz", idx_1_to_2=idx.int().cpu().numpy(), valid=valid.cpu().numpy(),
             conf1=host(out.C1), conf2=host(out.C2))
    print(f"wrote {out_dir}/pair.ply and matches.npz")


if __name__ == "__main__":
    main()
