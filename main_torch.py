#!/usr/bin/env python
"""MASt3R-SLAM on PyTorch/CUDA: the port's entry point, with `main.py`'s flags.

    python main_torch.py --dataset <path> [--config config/base.yaml]
                         [--save-as NAME] [--no-viz] [--calib intrinsics.yaml]
                         [--checkpoint path.pth] [--retrieval-checkpoint path.pth]
                         [--max-frames N] [--seed S] [--device cuda|cpu]

Runs on the first CUDA card unless `--device cpu` is given; with `cuda` and
no card it fails. The model computes in bf16 on every device, as `main.py`,
with its weights stored in bf16 under the config's `bf16_params`. Without
the checkpoint file the model gets random weights from `--seed`. The live
viewer is not ported: without `--no-viz` one line says so and the run is
headless.

Outputs under logs/[<save-as>/]: <seq>.txt (keyframe trajectory, TUM
format), <seq>_full.txt (every frame), <seq>.ply (the keyframe pointmaps
above confidence 1.5, coloured) and keyframes/<timestamp>.png.

`main(argv)` parses the flags and builds the weights; `run(...)` drives the
dataset, the SLAM loop and the export on given weights and config.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch
import yaml


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--config", default="config/base.yaml")
    parser.add_argument("--save-as", dest="save_as", default="default")
    parser.add_argument("--no-viz", dest="no_viz", action="store_true")
    parser.add_argument("--calib", default="")
    parser.add_argument("--checkpoint",
                        default="checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth")
    parser.add_argument("--retrieval-checkpoint", default="")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def run(args: argparse.Namespace, cfg: dict, params: dict, model_cfg, dtype=torch.bfloat16,
        dual=None):
    """Dataset -> prefetch -> SLAM loop -> export, with `params` (already on
    `args.device`) and the run config `cfg` (made the global config the
    dataset readers consult); `dual` (MonST3R + MASt3R weights) runs the
    dynamic pipeline, as `main_monster_torch.py` does. Returns (slam,
    per-frame host ms)."""
    from monst3r_slam_torch.app import evaluate
    from monst3r_slam_torch.app.config import set_global_config
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.data.datasets import Intrinsics, load_dataset
    from monst3r_slam_torch.data.prefetch import FramePrefetcher, uploading_preprocess
    from monst3r_slam_torch.data.preprocess import resize_img
    from monst3r_slam_torch.slam import retrieval as retrieval_mod

    device = args.device
    config = set_global_config(dict(cfg))
    dataset = load_dataset(args.dataset)
    dataset.subsample(config.get("dataset", {}).get("subsample", 1))
    if args.calib:
        with open(args.calib) as f:
            intr = yaml.safe_load(f)
        config["use_calib"] = True
        dataset.use_calibration = True
        dataset.camera_intrinsics = Intrinsics.from_calib(
            dataset.img_size, intr["width"], intr["height"],
            np.asarray([intr["fx"], intr["fy"], intr["cx"], intr["cy"]]
                       + list(intr.get("distortion", []))),
        )
    img_size = tuple(dataset.get_img_shape()[0])
    print(f"frame size: {img_size}, frames: {len(dataset)}")

    K = None
    if config.get("use_calib", False) and dataset.has_calib():
        K = torch.tensor(dataset.camera_intrinsics.K_frame, dtype=torch.float32, device=device)

    rp = pathlib.Path(args.retrieval_checkpoint) if args.retrieval_checkpoint else None
    if rp and rp.is_file():
        retr_params, _ = retrieval_mod.retrieval_params_from_checkpoint(str(rp), device=device)
        retr_db = retrieval_mod.ASMKDatabase(
            retrieval_mod.load_codebook(str(rp).replace(".pth", "_codebook.pkl")))
    else:
        # No pretrained codebook: the database fits one by k-means on the
        # first keyframes' features (retrieval.n_words, bootstrap_frames).
        retr_params = retrieval_mod.init_retrieval_params(
            torch.Generator().manual_seed(1), model_cfg.enc_dim, device=device)
        retr_db = retrieval_mod.ASMKDatabase.from_config(config)

    slam = SLAMSystem(params=params, model_cfg=model_cfg, cfg=dict(config), img_size=img_size,
                      K=K, retrieval_params=retr_params, retrieval_db=retr_db, device=device,
                      dtype=dtype, dual=dual)
    print(f"backend: {'worker thread' if slam._worker is not None else 'main thread'}, global "
          f"solve {'f64 host' if slam.host_solve else 'f32 device'}, tracking decisions "
          f"{slam.defer_depth} frames late, retrieval "
          f"{'from ' + str(rp) if rp and rp.is_file() else 'codebook bootstrapped by k-means'}")
    if not args.no_viz:
        print("live viewer: not ported to the PyTorch package; running headless (--no-viz)")

    n = min(len(dataset), args.max_frames) if args.max_frames else len(dataset)
    # Reading and resizing frame t+1 overlaps the device's work on frame t.
    frames = FramePrefetcher(
        dataset, uploading_preprocess(lambda img: resize_img(img, dataset.img_size), device), hi=n)
    frame_ms = []
    t0 = time.time()
    for i, timestamp, out in frames:
        tf = time.perf_counter()
        slam.process_frame(i, timestamp, out["img_dev"], uimg=out["unnormalized_img"])
        frame_ms.append((time.perf_counter() - tf) * 1e3)
        if i % 30 == 0 and i > 0:
            print(f"frame {i}/{n}  FPS: {i / (time.time() - t0):.3f}  keyframes: {slam.n_kf}")
    slam.finalize()  # the last deferred decisions and the backend worker's solves
    elapsed = time.time() - t0
    print(f"done: {n} frames in {elapsed:.1f}s = {n / elapsed:.3f} FPS "
          f"(backend stall {slam.backend_stall_s:.2f}s)")

    if dataset.save_results:
        save_dir, seq_name = evaluate.prepare_savedir(args, dataset)
        T_kfs, kf_ids = slam.keyframe_trajectory()
        evaluate.save_traj(save_dir, f"{seq_name}.txt", dataset.timestamps, T_kfs, kf_ids)
        frame_ids, T_all = slam.full_trajectory()
        evaluate.save_full_traj(save_dir, f"{seq_name}_full.txt",
                                [dataset.timestamps[i] for i in frame_ids], T_all)
        n_kf = slam.n_kf
        mem = slam.mem
        confs = mem.C[:n_kf] / torch.clamp(mem.N[:n_kf, None, None].float(), min=1.0)
        evaluate.save_reconstruction(
            save_dir, f"{seq_name}.ply", T_kfs, mem.X_canon[:n_kf].cpu().numpy(),
            confs.cpu().numpy(), slam.keyframe_colors(), conf_threshold=1.5,
        )
        evaluate.save_keyframes(
            save_dir / "keyframes", dataset.timestamps, kf_ids,
            [np.asarray(u, np.float32) / 255.0 if u is not None
             else np.full((*img_size, 3), 0.5) for u in slam.kf_uimgs[:n_kf]],
        )
        print(f"saved results to {save_dir}")
    return slam, frame_ms


def load_or_random(path: str, default_cfg, seed: int, device):
    """(params, cfg) from the checkpoint at `path`, or random weights of
    `default_cfg` from `seed` when there is no such file."""
    from monst3r_slam_torch.models.convert import load_checkpoint
    from monst3r_slam_torch.models.init import init_params

    p = pathlib.Path(path)
    if p.is_file():
        params, cfg = load_checkpoint(str(p), device=device)
        print(f"loaded checkpoint {p}")
        return params, cfg
    print(f"WARNING: checkpoint {p} not found — random weights")
    return init_params(torch.Generator(device=device).manual_seed(seed), default_cfg), default_cfg


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference

    cfg = load_config(args.config)
    params, model_cfg = load_or_random(args.checkpoint, MAST3R_512, args.seed, args.device)
    # As in the reference, the model computes in bf16 on every device, and
    # `bf16_params` stores its weights so.
    if cfg.get("bf16_params", True):
        params = cast_params_for_inference(params)
    return run(args, cfg, params, model_cfg)


if __name__ == "__main__":
    main()
