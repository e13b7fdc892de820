#!/usr/bin/env python
"""Fine-tune the two-view pointmap model on PyTorch/CUDA, with `train.py`'s flags.

    python train_torch.py [--data DIR | --synthetic] [--checkpoint path.pth]
                          [--steps N] [--batch B] [--lr LR] [--img-size H W]
                          [--tiny] [--save out.npz] [--ckpt-dir DIR]
                          [--ckpt-every N] [--device cuda|cpu]

Confidence-weighted pointmap regression with AdamW (`monst3r_slam_torch/
train/`), the model computing in bf16 on f32 weights, on a dp x tp mesh
(`parallel/mesh.make_mesh`) over every visible CUDA card, as `train.py`
builds one over every device: the batch split over dp, the ViT weights
split over tp (Megatron column / row parallel), one process driving every
card. With one card, or with `--device cpu`, the mesh is (1, 1) and the
step is the one-device step. With `cuda` and no card it fails. On the card
every attention runs kernel A, forward only. `--batch` must divide by dp.

Data: a directory of .npz samples with img1/img2 (H, W, 3) normalized,
gt_X1/gt_X2 (H, W, 3), valid1/valid2 (H, W); or --synthetic, the
reference's synthetic pair drawn from a `torch.Generator` seeded with the
step (its bits differ from JAX's random draws). Without `--checkpoint` the
weights are random from seed 0.

`--ckpt-dir` keeps the whole training state (weights, AdamW moments, step)
every `--ckpt-every` steps and at the end, and resumes from its newest
file; the format is the port's (`train/checkpoint.py`). `--save` writes
the final weights as `train.py` does: `np.savez_compressed` in the JAX
package's layout, named as JAX's `tree_util.keystr` names its leaves, so
either package loads them.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

BATCH_KEYS = ("img1", "img2", "gt_X1", "gt_X2", "valid1", "valid2")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", default="", help="dir of .npz samples")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoint", default="", help="torch .pth to start from")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--img-size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke)")
    p.add_argument("--save", default="trained_params.npz")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint dir: resumes the full training state "
                        "(params + AdamW moments + step) if one exists")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def synthetic_batch(seed: int, b: int, h: int, w: int, device="cpu") -> dict:
    """The reference's synthetic pair: noisy images and a pinhole pointmap
    whose depth follows image 1, every pixel valid. Drawn on the CPU from
    `seed`, so every device gets the same batch."""
    gen = torch.Generator().manual_seed(seed)
    img1 = torch.randn((b, h, w, 3), generator=gen) * 0.5
    img2 = img1 + 0.05 * torch.randn((b, h, w, 3), generator=gen)
    z = 2.0 + torch.sigmoid(img1[..., 0:1]) * 2.0
    u = torch.linspace(-1, 1, w)[None, None, :, None]
    v = torch.linspace(-0.75, 0.75, h)[None, :, None, None]
    gt = torch.cat([u * z, v * z, z], dim=-1)
    valid = torch.ones((b, h, w))
    batch = {"img1": img1, "img2": img2, "gt_X1": gt, "gt_X2": gt,
             "valid1": valid, "valid2": valid}
    return {k: t.to(device) for k, t in batch.items()}


def npz_batch(files, step: int, b: int, device) -> dict:
    samples = []
    for i in range(b):
        with np.load(files[(step * b + i) % len(files)]) as f:
            samples.append({k: f[k] for k in BATCH_KEYS})
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]).astype(np.float32)).to(device)
            for k in BATCH_KEYS}


def save_params(path: str, params) -> None:
    """The weights (a tree of plain tensors: `gather_params` of a sharded
    one) as `train.py --save` writes them."""
    from monst3r_slam_torch.models.convert import params_to_jax
    from monst3r_slam_torch.train.step import named_leaves

    np.savez_compressed(path, **dict(named_leaves(params_to_jax(params))))


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    from monst3r_slam_torch.models.config import MAST3R_512, TINY
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.parallel.mesh import (batch_sharding, gather_params, make_mesh,
                                                  shard_params)
    from monst3r_slam_torch.train import checkpoint as ckpt
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer, train_step

    device = torch.device(args.device)
    mesh = make_mesh(devices=None if args.device == "cuda" else [device])
    device = mesh.home
    cfg = TINY if args.tiny else MAST3R_512
    if args.checkpoint:
        from monst3r_slam_torch.models.convert import load_checkpoint

        params, cfg = load_checkpoint(args.checkpoint, device=device)
    else:
        params = init_params(torch.Generator(device=device).manual_seed(0), cfg)

    print(f"mesh: {dict(mesh.shape)}")
    params = shard_params(params, mesh)
    state = init_train_state(params, make_optimizer(args.lr))

    mngr = None
    start_step = 0
    if args.ckpt_dir:
        mngr = ckpt.make_manager(args.ckpt_dir)
        restored = ckpt.restore_latest(mngr, state)
        if restored is not None:
            state = restored
            start_step = state.step
            print(f"resumed from {args.ckpt_dir} at step {start_step}")

    h, w = args.img_size
    files = sorted(pathlib.Path(args.data).glob("*.npz")) if args.data else []

    def get_batch(step):
        if args.synthetic or not files:
            batch = synthetic_batch(step, args.batch, h, w, device)
        else:
            batch = npz_batch(files, step, args.batch, device)
        return {k: batch_sharding(mesh, v) for k, v in batch.items()}

    t0 = time.time()
    for step in range(start_step, args.steps):
        state, loss = train_step(state, cfg, get_batch(step), mesh=mesh)
        if step % 10 == 0:
            done = step - start_step + 1  # steps completed this run
            print(f"step {step}: loss {float(loss):.4f} "
                  f"({(time.time() - t0) / done:.2f} s/step)")
        if mngr is not None and (step + 1) % max(args.ckpt_every, 1) == 0:
            ckpt.save(mngr, state)
    if mngr is not None:
        # no-op when the last loop iteration already saved this step
        ckpt.save(mngr, state)

    if args.save:
        save_params(args.save, gather_params(state.params, mesh))
        print(f"saved params to {args.save}")


if __name__ == "__main__":
    main()
