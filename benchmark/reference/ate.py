"""Absolute trajectory error: Sim(3) alignment (Umeyama 1991) of an
estimated camera path to its ground truth, in float64 NumPy."""

from __future__ import annotations

import numpy as np


def align_errors(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> np.ndarray:
    """Per-frame translation errors after the least-squares similarity that
    maps the estimate onto the ground truth, (n,)."""
    x, y = np.asarray(est_xyz, np.float64), np.asarray(gt_xyz, np.float64)
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    U, d, Vt = np.linalg.svd(yc.T @ xc / len(x))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_x = (xc**2).sum() / len(x)
    s = float(np.trace(np.diag(d) @ S) / var_x) if var_x > 0 else 1.0
    return np.linalg.norm((s * (R @ x.T)).T + (my - s * R @ mx) - y, axis=1)


def extent(gt_xyz: np.ndarray) -> float:
    """The diagonal of the ground truth's bounding box."""
    return float(np.linalg.norm(np.ptp(np.asarray(gt_xyz, np.float64), axis=0)))


def episode_pct(est_xyz, gt_xyz) -> float:
    """One episode's ATE (RMSE) as a percentage of its extent."""
    e = align_errors(est_xyz, gt_xyz)
    return float(np.sqrt(np.mean(e**2)) / extent(gt_xyz) * 100.0)


def mix_pct(episodes) -> float:
    """The ATE of a mix's episodes, each aligned to its ground truth alone,
    every frame's error over its episode's extent, as a percentage: the
    root of the mean, over the distinct episodes of the mix, of each one's
    mean squared error over all its completed replays, so that each
    episode of the mix weighs the same however often a window replays it.
    `episodes` is [(episode id, est_xyz, gt_xyz)]."""
    by_id: dict = {}
    for i, est, gt in episodes:
        by_id.setdefault(i, []).append(align_errors(est, gt) / extent(gt))
    return float(np.sqrt(np.mean([np.mean(np.concatenate(r) ** 2)
                                  for r in by_id.values()])) * 100.0)
