"""Headless visualization: depth/confidence maps, trajectory plots, mask
overlays.

The port's copy of the JAX package's `viz/headless.py`. The reference
system's live viewer is a moderngl+imgui window in a separate process
(`visualization.py:42-474`), and its evaluation path runs `--no-viz`. This
module gives the headless equivalents (the debug dumps of
tracker2.py:132-206 and visualization_utils.py:15-30), and
`export_scene_html` writes a self-contained point-cloud viewer page.
matplotlib and cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence

import numpy as np


def depth2rgb(depth: np.ndarray, d_min=None, d_max=None) -> np.ndarray:
    """Colormapped depth (visualization_utils.py:15-22), uint8 HWC."""
    import matplotlib

    depth = np.asarray(depth, np.float32)
    d_min = np.nanmin(depth) if d_min is None else d_min
    d_max = np.nanmax(depth) if d_max is None else d_max
    norm = np.clip((depth - d_min) / max(d_max - d_min, 1e-12), 0, 1)
    cmap = matplotlib.colormaps["turbo"]
    return np.uint8(cmap(norm)[..., :3] * 255)


def save_image(path, img_u8: np.ndarray):
    import cv2

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))


def overlay_mask(img_u8: np.ndarray, mask: np.ndarray, color=(255, 0, 0), alpha=0.5):
    """Dynamic-mask overlay (tracker2.py:132-157 debug dump)."""
    out = img_u8.astype(np.float32).copy()
    m = np.asarray(mask, bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return np.uint8(out)


def plot_trajectory(path, T_WCs: np.ndarray, gt_xyz: Optional[np.ndarray] = None):
    """Top-down (x, z) trajectory plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = np.asarray(T_WCs)[:, :3]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(xyz[:, 0], xyz[:, 2], "b-", lw=1, label="estimate")
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 2], "k--", lw=1, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>monst3r-slam viewer</title>
<style>body{{margin:0;background:#111}}</style></head>
<body><canvas id="c"></canvas>
<script>
// Minimal self-contained point-cloud viewer (orbit + zoom), no dependencies.
const pts = new Float32Array({points});
const cols = new Uint8Array({colors});
const canvas = document.getElementById('c');
canvas.width = innerWidth; canvas.height = innerHeight;
const ctx = canvas.getContext('2d');
let yaw = 0.5, pitch = 0.4, dist = 4, cx = 0, cy = 0;
let dragging = false, lx = 0, ly = 0;
canvas.onmousedown = e => {{ dragging = true; lx = e.x; ly = e.y; }};
window.onmouseup = () => dragging = false;
window.onmousemove = e => {{
  if (!dragging) return;
  yaw += (e.x - lx) * 0.005; pitch += (e.y - ly) * 0.005;
  lx = e.x; ly = e.y; draw();
}};
canvas.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); }};
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 0.8 * Math.min(canvas.width, canvas.height);
  const img = ctx.createImageData(canvas.width, canvas.height);
  const zbuf = new Float32Array(canvas.width * canvas.height).fill(1e9);
  for (let i = 0; i < pts.length; i += 3) {{
    let x = pts[i], y = pts[i+1], z = pts[i+2];
    let x1 = cyaw * x + syaw * z, z1 = -syaw * x + cyaw * z;
    let y1 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist;
    if (z2 < 0.05) continue;
    const u = Math.round(canvas.width / 2 + f * x1 / z2);
    const v = Math.round(canvas.height / 2 + f * y1 / z2);
    if (u < 0 || v < 0 || u >= canvas.width || v >= canvas.height) continue;
    const idx = v * canvas.width + u;
    if (z2 > zbuf[idx]) continue;
    zbuf[idx] = z2;
    const j = i / 3 * 3, o = idx * 4;
    img.data[o] = cols[j]; img.data[o+1] = cols[j+1];
    img.data[o+2] = cols[j+2]; img.data[o+3] = 255;
  }}
  ctx.putImageData(img, 0, 0);
}}
draw();
</script></body></html>
"""


def export_scene_html(path, points: np.ndarray, colors: np.ndarray, max_points=300000):
    """Self-contained interactive point-cloud HTML (viewer substitute)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = np.uint8(np.clip(colors, 0, 1) * 255)
    if points.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(points.shape[0], max_points, replace=False)
        points, colors = points[sel], colors[sel]
    center = points.mean(0)
    scale = np.percentile(np.linalg.norm(points - center, axis=1), 90) or 1.0
    norm_pts = (points - center) / scale
    html = _HTML_TEMPLATE.format(
        points=np.round(norm_pts, 3).flatten().tolist(),
        colors=colors.flatten().tolist(),
    )
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
