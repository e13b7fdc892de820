"""Geometry oracle: exact multi-view-consistent pointmaps of a known scene.

Port of the JAX package's `utils/oracle.py`: the synthetic height-field
scene of tests/test_ate_regression.py (surface z = f(x, y), Newton
ray-surface intersection, random-Fourier world descriptors), computed in
f32 with torch on the pose's device, so frames render on the card from an
(8,) Sim(3) pose. A caller that runs the real decode and then replaces its
outputs with `render_pair`'s drives the tracker, keyframing and backend on
geometry that is consistent across views, at the model's full cost.

Poses may carry leading batch dimensions: `render_frame`, `render_pair` and
`render_image` render every pose of the batch at once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from monst3r_slam_torch.core import lie


def surface_z(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (3.0 + 0.25 * torch.sin(0.9 * x) + 0.25 * torch.cos(0.7 * y)
            + 0.1 * torch.sin(1.7 * (x + y)))


def _surface_g_and_dg(t: torch.Tensor, tau: torch.Tensor, m: torch.Tensor):
    """g = z - surface_z(x, y) along the rays t + tau m, and dg/dtau:
    t (..., 3), tau (..., n), m (..., n, 3)."""
    xw = t[..., 0:1] + tau * m[..., 0]
    yw = t[..., 1:2] + tau * m[..., 1]
    zw = t[..., 2:3] + tau * m[..., 2]
    g = zw - surface_z(xw, yw)
    dg = (m[..., 2]
          - 0.25 * 0.9 * torch.cos(0.9 * xw) * m[..., 0]
          + 0.25 * 0.7 * torch.sin(0.7 * yw) * m[..., 1]
          - 0.1 * 1.7 * torch.cos(1.7 * (xw + yw)) * (m[..., 0] + m[..., 1]))
    return g, dg


def pixel_rays(h: int, w: int, fx: float, fy: float, device=None) -> torch.Tensor:
    """(h*w, 3) rays through the pixel grid, z = 1, principal point at the
    image centre."""
    u = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return torch.stack([(u - w / 2) / fx, (v - h / 2) / fy, torch.ones_like(u)],
                       dim=-1).reshape(-1, 3)


def render_frame(T_WC: torch.Tensor, h: int, w: int, fx: float, fy: float,
                 newton_iters: int = 25):
    """Exact pointmaps for ground-truth camera poses T_WC (..., 8):
    (X_cam (..., hw, 3), X_world (..., hw, 3)), f32 on T_WC's device."""
    M = lie.sim3_matrix(T_WC.float())
    sR = M[..., :3, :3]
    t = M[..., :3, 3]
    r = pixel_rays(h, w, fx, fy, T_WC.device)
    m = r @ sR.transpose(-1, -2)  # (..., hw, 3) world directions
    tau = (3.0 - t[..., 2:3]) / m[..., 2]  # the flat plane's intersection
    for _ in range(newton_iters):
        g, dg = _surface_g_and_dg(t, tau, m)
        tau = tau - g / dg
    X_world = t[..., None, :] + tau[..., None] * m
    X_cam = tau[..., None] * r
    return X_cam, X_world


def make_rff(desc_dim: int, scale: float = 1.5, generator: torch.Generator | None = None):
    """Random-Fourier-feature descriptor parameters {"W": (3, F), "b": (F,)}
    (keyed by the world point, so descriptors agree across views), drawn
    from `generator` on its device. `scale` sets the texture's frequency:
    the pixel footprint at 384x512 is ~5x smaller than at 64x80, and scale
    ~12 keeps the descriptors locally discriminative there. The reference
    draws from a JAX key, so a seed gives other numbers here."""
    dev = None if generator is None else generator.device
    W = scale * torch.randn((3, desc_dim), generator=generator, device=dev)
    b = torch.rand((desc_dim,), generator=generator, device=dev) * (2.0 * math.pi)
    return {"W": W, "b": b}


def world_desc(rff, X_world: torch.Tensor) -> torch.Tensor:
    d = torch.sin(X_world @ rff["W"] + rff["b"])
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def render_pair(T_WCi: torch.Tensor, T_WCj: torch.Tensor, rff, h: int, w: int, fx: float,
                fy: float):
    """Oracle decode outputs for frame pairs (poses (..., 8)), view j's
    points in view i's camera frame (the decoder's convention):
    (X1 (..., hw, 3), D1 (..., hw, F), X2 (..., hw, 3), D2 (..., hw, F))."""
    Xi_cam, Xi_w = render_frame(T_WCi, h, w, fx, fy)
    Xj_cam, Xj_w = render_frame(T_WCj, h, w, fx, fy)
    T_ij = lie.sim3_rel(T_WCi.float(), T_WCj.float())
    Xj_in_i = lie.sim3_act(T_ij[..., None, :], Xj_cam)
    return Xi_cam, world_desc(rff, Xi_w), Xj_in_i, world_desc(rff, Xj_w)


def render_image(T_WC: torch.Tensor, h: int, w: int, fx: float, fy: float) -> torch.Tensor:
    """A photometric rendering for the encoder: smooth functions of the
    world intersection point in [-1, 1] (ImgNorm's range), (B, h, w, 3) with
    B = 1 for one pose."""
    _, Xw = render_frame(T_WC, h, w, fx, fy)
    img = torch.stack([
        torch.sin(2.1 * Xw[..., 0]) * torch.cos(1.3 * Xw[..., 1]),
        torch.sin(1.7 * Xw[..., 1] + 0.5),
        torch.cos(2.9 * Xw[..., 0] + 1.1 * Xw[..., 2]),
    ], dim=-1)
    return img.reshape(-1, h, w, 3)


def gt_trajectory(n: int, step: float = 0.06):
    """A smooth forward and lateral camera path with a mild wobble: n Sim(3)
    poses as (8,) float32 numpy arrays, computed on the host."""
    poses = []
    for i in range(n):
        xi = np.zeros(7, np.float32)
        xi[0] = step * i  # x translation
        xi[1] = 0.3 * step * np.sin(0.2 * i)
        xi[4] = 0.02 * np.sin(0.15 * i)  # small pitch/yaw wobble
        poses.append(lie.sim3_exp(torch.from_numpy(xi)).numpy())
    return poses
