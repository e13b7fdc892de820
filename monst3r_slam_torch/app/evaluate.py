"""Trajectory and reconstruction export, and ATE evaluation.

The port's copy of the JAX package's `app/evaluate.py`: the reference
`mast3r_slam/evaluate.py` writers (save_traj:24, save_full_traj:110,
save_reconstruction:48, save_keyframes:74, save_ply:89) with a local binary
PLY writer, and an evo-compatible ATE RMSE (`evo_ape tum -as`: Umeyama
Sim(3) alignment). Everything here takes and writes host arrays; the world
points of the reconstruction are computed with the port's Sim(3) action on
CPU tensors.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from monst3r_slam_torch.core import lie


def prepare_savedir(args, dataset):
    """logs/[<save_as>/] and the sequence name (evaluate.py:15-22)."""
    save_dir = pathlib.Path("logs")
    if getattr(args, "save_as", "default") != "default":
        save_dir = save_dir / args.save_as
    seq_name = (
        pathlib.Path(dataset.dataset_path).stem
        if getattr(dataset, "dataset_path", None)
        else "live"
    )
    save_dir.mkdir(exist_ok=True, parents=True)
    return save_dir, seq_name


def _tum_line(timestamp, T_WC_se3: np.ndarray) -> str:
    t = T_WC_se3[0:3]
    q = T_WC_se3[3:7]  # xyzw
    return (
        f"{timestamp} "
        f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
    )


def save_traj(save_dir, filename, timestamps, keyframe_T_WCs, keyframe_ids):
    """Keyframe trajectory in TUM format, scale dropped (evaluate.py:24-46)."""
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(exist_ok=True, parents=True)
    with open(save_dir / filename, "w") as f:
        for kf_id, T in zip(keyframe_ids, keyframe_T_WCs):
            f.write(_tum_line(timestamps[int(kf_id)], np.asarray(T)[0:7]))


def save_full_traj(save_dir, filename, frame_timestamps, frame_T_WCs):
    """All-frame trajectory in TUM format (evaluate.py:110-141)."""
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(exist_ok=True, parents=True)
    with open(save_dir / filename, "w") as f:
        for ts, T in zip(frame_timestamps, frame_T_WCs):
            f.write(_tum_line(ts, np.asarray(T)[0:7]))


def save_ply(filename, points: np.ndarray, colors: np.ndarray):
    """Binary little-endian PLY point cloud: x, y, z float32 and r, g, b
    uchar per vertex (evaluate.py:89-107 layout)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = np.uint8(np.clip(colors, 0.0, 1.0) * 255)
    n = points.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = points.T
    rec["red"], rec["green"], rec["blue"] = colors.T
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def save_reconstruction(save_dir, filename, T_WCs, X_canons, confs, colors, conf_threshold):
    """Keyframe pointmaps in the world frame, above a confidence threshold,
    as one PLY (evaluate.py:48-72)."""
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(exist_ok=True, parents=True)
    pts_all, col_all = [], []
    for T, X, C, rgb in zip(T_WCs, X_canons, confs, colors):
        keep = np.asarray(C).reshape(-1) > conf_threshold
        Xw = lie.sim3_act(torch.as_tensor(np.asarray(T, np.float32)),
                          torch.as_tensor(np.asarray(X, np.float32))).numpy()
        pts_all.append(Xw[keep])
        col_all.append(np.asarray(rgb).reshape(-1, 3)[keep])
    if pts_all:
        save_ply(save_dir / filename, np.concatenate(pts_all), np.concatenate(col_all))


def save_keyframes(save_dir, timestamps, keyframe_ids, keyframe_imgs):
    """Keyframe PNGs named by timestamp (evaluate.py:74-87)."""
    import cv2

    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(exist_ok=True, parents=True)
    for kf_id, img in zip(keyframe_ids, keyframe_imgs):
        ts = timestamps[int(kf_id)]
        img8 = np.uint8(np.clip(np.asarray(img), 0, 1) * 255)
        cv2.imwrite(str(save_dir / f"{ts}.png"), cv2.cvtColor(img8, cv2.COLOR_RGB2BGR))


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity (s, R, t) aligning x -> y, both (n, 3)
    (Umeyama 1991; the `-as` flag of evo_ape). An estimate that never moved
    has no observable scale: s = 1 then."""
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc**2).sum() / x.shape[0]
    s = float(np.trace(np.diag(d) @ S) / var_x) if with_scale and var_x > 0 else 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def associate(est_timestamps, gt_timestamps, max_diff: float = 0.02):
    """Nearest-timestamp association (TUM convention); (ei, gi) index arrays
    into the estimate and ground-truth trajectories."""
    est_t = np.asarray([float(t) for t in est_timestamps])
    gt_t = np.asarray([float(t) for t in gt_timestamps])
    pairs = []
    for i, t in enumerate(est_t):
        j = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[j] - t) <= max_diff:
            pairs.append((i, j))
    return np.asarray([p[0] for p in pairs], int), np.asarray([p[1] for p in pairs], int)


def ate_rmse(est_timestamps, est_xyz: np.ndarray, gt_timestamps, gt_xyz: np.ndarray,
             max_diff: float = 0.02, with_scale: bool = True):
    """Associate by timestamp, Sim(3)-align, RMSE of the translation error
    (the reference's headline metric, scripts/eval_tum.sh:46-63). Returns
    (rmse, number of associated poses)."""
    ei, gi = associate(est_timestamps, gt_timestamps, max_diff)
    if len(ei) < 3:
        raise ValueError(f"only {len(ei)} timestamp matches")
    x = est_xyz[ei]
    y = gt_xyz[gi]
    s, R, t = umeyama_alignment(x, y, with_scale)
    err = np.linalg.norm((s * (R @ x.T)).T + t - y, axis=1)
    return float(np.sqrt(np.mean(err**2))), len(ei)


def load_tum_trajectory(path):
    """(timestamps (n,), xyz (n, 3), quat_xyzw (n, 4)) of a TUM file."""
    data = np.atleast_2d(np.loadtxt(path, comments="#", dtype=np.float64))
    return data[:, 0], data[:, 1:4], data[:, 4:8]
