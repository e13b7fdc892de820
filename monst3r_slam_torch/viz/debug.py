"""Debug dumps of the dynamic pipeline.

The port's copy of the JAX package's `viz/debug.py`: the mask overlays
(`save_mask_overlay`, cv2, the same PNG bytes), the pointmap panels before
and after masking (`save_pointmap_visualization`), the confidence overlay
triptych (`save_confidence_overlay`) and the 3D scatter comparison
(`save_3d_pointcloud_comparison`), the last three drawn by matplotlib with
the reference's figures. matplotlib is imported inside those three, so the
mask overlays, which the dynamic path writes by default, need only cv2.
All take numpy arrays on the host; callers treat them as best-effort.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _np_img(img) -> np.ndarray:
    """-> (h, w, 3) float in [0, 1]."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 3:
        img = np.transpose(img, (1, 2, 0))
    img = img.astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return np.clip(img, 0.0, 1.0)


def save_mask_overlay(path, img, mask, color=(255, 0, 0), alpha=0.5):
    """The frame image with a translucent coloured mask, as a PNG."""
    import cv2

    img8 = np.uint8(_np_img(img) * 255)
    overlay = img8.copy()
    overlay[np.asarray(mask).astype(bool)] = color
    out = np.uint8((1 - alpha) * img8 + alpha * overlay)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(out, cv2.COLOR_RGB2BGR))


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_pointmap_visualization(X_before, C_before, X_after, C_after, frame_id, save_dir,
                                prefix="pointmap"):
    """2x2 confidence and depth panels before and after masking, and their
    difference panels. Returns the two PNG paths."""
    plt = _pyplot()
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    def squeeze(x):
        x = np.asarray(x, np.float32)
        return x[0] if x.ndim == 4 or (x.ndim == 3 and x.shape[-1] != 3) else x

    Xb = squeeze(X_before)
    Cb = np.asarray(C_before, np.float32).reshape(np.asarray(X_before).shape[-3:-1])
    Xa = squeeze(X_after)
    Ca = np.asarray(C_after, np.float32).reshape(Cb.shape)
    db = np.where(np.abs(Xb[..., 2]) < 1e-6, np.nan, Xb[..., 2])
    da = np.where(np.abs(Xa[..., 2]) < 1e-6, np.nan, Xa[..., 2])

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    fig.suptitle(f"Pointmap Visualization - Frame {frame_id}", fontsize=14)
    for ax, data, title, cmap in (
        (axes[0, 0], Cb, "Original Confidence", "viridis"),
        (axes[0, 1], Ca, "Masked Confidence", "viridis"),
        (axes[1, 0], db, "Original Depth", "plasma"),
        (axes[1, 1], da, "Masked Depth", "plasma"),
    ):
        im = ax.imshow(data, cmap=cmap, aspect="auto")
        ax.set_title(title)
        ax.axis("off")
        plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    p1 = save_dir / f"{prefix}_frame_{frame_id:06d}.png"
    fig.savefig(p1, dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    fig.suptitle(f"Pointmap Differences - Frame {frame_id}", fontsize=14)
    for ax, data, title in (
        (axes[0], Cb - Ca, "Confidence Difference (Original - Masked)"),
        (axes[1], db - da, "Depth Difference (Original - Masked)"),
    ):
        im = ax.imshow(data, cmap="RdBu_r", aspect="auto")
        ax.set_title(title)
        ax.axis("off")
        plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    p2 = save_dir / f"{prefix}_diff_frame_{frame_id:06d}.png"
    fig.savefig(p2, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return p1, p2


def save_confidence_overlay(C_map, dynamic_mask, frame_img, frame_id, save_dir,
                            prefix="conf_overlay"):
    """Image | confidence overlay | dynamic-mask overlay. Returns the PNG path."""
    plt = _pyplot()
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    C = np.asarray(C_map, np.float32)
    C = C.reshape(C.shape[-2:]) if C.ndim > 2 else C
    mask = np.asarray(dynamic_mask).astype(bool).reshape(C.shape)
    img = _np_img(frame_img)

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    fig.suptitle(f"Confidence Overlay - Frame {frame_id}", fontsize=14)
    axes[0].imshow(img)
    axes[0].set_title("Original Image")
    axes[0].axis("off")
    im = axes[1].imshow(C, cmap="viridis", aspect="auto", alpha=0.8)
    axes[1].imshow(img, alpha=0.3)
    axes[1].set_title("Confidence Map Overlay")
    axes[1].axis("off")
    plt.colorbar(im, ax=axes[1], fraction=0.046, pad=0.04)
    mask_rgba = np.zeros((*mask.shape, 4))
    mask_rgba[mask] = [1, 0, 0, 0.6]
    axes[2].imshow(img)
    axes[2].imshow(mask_rgba, alpha=0.7)
    axes[2].set_title("Dynamic Mask Overlay")
    axes[2].axis("off")
    path = save_dir / f"{prefix}_frame_{frame_id:06d}.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def save_3d_pointcloud_comparison(X_before, C_before, X_after, C_after, frame_id, save_dir,
                                  prefix="pointcloud_3d", max_points=10000):
    """Side-by-side confidence-coloured 3D scatters before and after masking
    (at most `max_points` each, drawn by a generator seeded 0). Returns the
    PNG path."""
    plt = _pyplot()
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)

    def prep(X, C):
        pts = np.asarray(X, np.float32).reshape(-1, 3)
        conf = np.asarray(C, np.float32).reshape(-1)
        ok = (conf > 0.01) & (np.abs(pts[:, 2]) > 1e-6) & (np.abs(pts[:, 2]) < 100)
        pts, conf = pts[ok], conf[ok]
        if len(pts) > max_points:
            sel = rng.choice(len(pts), max_points, replace=False)
            pts, conf = pts[sel], conf[sel]
        return pts, conf

    pb, cb = prep(X_before, C_before)
    pa, ca = prep(X_after, C_after)

    fig = plt.figure(figsize=(16, 8))
    axes = []
    for i, (pts, conf, title) in enumerate(((pb, cb, "Before"), (pa, ca, "After")), start=1):
        ax = fig.add_subplot(1, 2, i, projection="3d")
        if len(pts):
            sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=conf, cmap="viridis", s=1,
                            alpha=0.6)
            plt.colorbar(sc, ax=ax, shrink=0.5, aspect=20)
        ax.set_title(f"3D Points {title} Masking (Frame {frame_id})")
        axes.append(ax)
    if len(pb) and len(pa):
        allp = np.vstack([pb, pa])
        for ax in axes:
            ax.set_xlim(allp[:, 0].min(), allp[:, 0].max())
            ax.set_ylim(allp[:, 1].min(), allp[:, 1].max())
            ax.set_zlim(allp[:, 2].min(), allp[:, 2].max())
    path = save_dir / f"{prefix}_frame_{frame_id:06d}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
