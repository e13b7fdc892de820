"""The oracle scene: a known camera path over a height field, rendered exactly.

A frozen copy of the scene that `monst3r_slam_torch/utils/oracle.py` and
`tests/test_ate_regression.py` define (the surface z = f(x, y), Newton's
ray-surface intersection, random-Fourier world descriptors), written here
in plain PyTorch so that later changes to the program cannot move the
traffic or the ground truth. A pose is a Sim(3) 8-vector [t(3), q(4) xyzw,
s(1)]; every function takes leading batch dimensions and runs on the pose's
device in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qv, qw = q[..., :3], q[..., 3:4]
    uv = 2.0 * torch.linalg.cross(*torch.broadcast_tensors(qv, v), dim=-1)
    return v + qw * uv + torch.linalg.cross(*torch.broadcast_tensors(qv, uv), dim=-1)


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def sim3_act(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return T[..., 7:8] * quat_rotate(T[..., 3:7], X) + T[..., 0:3]


def sim3_rel(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """Ti^-1 o Tj."""
    ti, qi, si = Ti[..., 0:3], Ti[..., 3:7], Ti[..., 7:8]
    tj, qj, sj = Tj[..., 0:3], Tj[..., 3:7], Tj[..., 7:8]
    qi_inv = torch.cat([-qi[..., :3], qi[..., 3:4]], dim=-1)
    x1, y1, z1, w1 = qi_inv.unbind(-1)
    x2, y2, z2, w2 = qj.unbind(-1)
    q = torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2],
                    dim=-1)
    t = quat_rotate(qi_inv, tj - ti) / si
    return torch.cat([t, q, sj / si], dim=-1)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Tangent [tau(3), phi(3), 0] -> 8-vector [t, q, 1], in float64."""
    tau, phi = xi[:3], xi[3:6]
    th = float(np.linalg.norm(phi))
    if th < 1e-8:
        q = np.array([*(0.5 * phi), 1.0])
        A, B = 0.5, 1.0 / 6.0
    else:
        q = np.array([*(math.sin(th / 2) / th * phi), math.cos(th / 2)])
        A, B = (1 - math.cos(th)) / th**2, (th - math.sin(th)) / th**3
    pt = np.cross(phi, tau)
    t = tau + A * pt + B * np.cross(phi, pt)
    return np.concatenate([t, q / np.linalg.norm(q), [1.0]])


def trajectory(start: int, n: int, step: float) -> np.ndarray:
    """(n, 8) float32 poses i = start .. start + n - 1 of the path: forward
    and lateral motion with a mild pitch/yaw wobble, the oracle's
    `gt_trajectory` shifted to begin at frame `start`."""
    poses = []
    for i in range(start, start + n):
        xi = np.zeros(7)
        xi[0] = step * i
        xi[1] = 0.3 * step * math.sin(0.2 * i)
        xi[4] = 0.02 * math.sin(0.15 * i)
        poses.append(se3_exp(xi))
    return np.asarray(poses, np.float32)


def surface_z(x, y):
    return (3.0 + 0.25 * torch.sin(0.9 * x) + 0.25 * torch.cos(0.7 * y)
            + 0.1 * torch.sin(1.7 * (x + y)))


def pixel_rays(h: int, w: int, f: float, device) -> torch.Tensor:
    u = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return torch.stack([(u - w / 2) / f, (v - h / 2) / f, torch.ones_like(u)], -1).reshape(-1, 3)


def render_frame(T: torch.Tensor, h: int, w: int, f: float, newton_iters: int = 25):
    """Exact pointmaps of poses T (..., 8): (X_cam, X_world), (..., hw, 3)."""
    T = T.float()
    sR = T[..., 7:8, None] * quat_matrix(T[..., 3:7])
    t = T[..., 0:3]
    r = pixel_rays(h, w, f, T.device)
    m = r @ sR.transpose(-1, -2)
    tau = (3.0 - t[..., 2:3]) / m[..., 2]
    for _ in range(newton_iters):
        xw = t[..., 0:1] + tau * m[..., 0]
        yw = t[..., 1:2] + tau * m[..., 1]
        zw = t[..., 2:3] + tau * m[..., 2]
        g = zw - surface_z(xw, yw)
        dg = (m[..., 2] - 0.225 * torch.cos(0.9 * xw) * m[..., 0]
              + 0.175 * torch.sin(0.7 * yw) * m[..., 1]
              - 0.17 * torch.cos(1.7 * (xw + yw)) * (m[..., 0] + m[..., 1]))
        tau = tau - g / dg
    return tau[..., None] * r, t[..., None, :] + tau[..., None] * m


def make_rff(desc_dim: int, scale: float, gen: torch.Generator) -> dict:
    """Random-Fourier descriptor field keyed by the world point."""
    W = scale * torch.randn((3, desc_dim), generator=gen, device=gen.device)
    b = torch.rand((desc_dim,), generator=gen, device=gen.device) * (2.0 * math.pi)
    return {"W": W, "b": b}


def world_desc(rff: dict, X_world: torch.Tensor) -> torch.Tensor:
    d = torch.sin(X_world @ rff["W"] + rff["b"])
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def render_pair(Ti: torch.Tensor, Tj: torch.Tensor, rff: dict, h: int, w: int, f: float):
    """The exact two-view outputs of frame pairs: (X1, D1, X2, D2), view j's
    points in view i's camera frame (the decoder's convention)."""
    Xi, Xi_w = render_frame(Ti, h, w, f)
    Xj, Xj_w = render_frame(Tj, h, w, f)
    Xj_in_i = sim3_act(sim3_rel(Ti.float(), Tj.float())[..., None, :], Xj)
    return Xi, world_desc(rff, Xi_w), Xj_in_i, world_desc(rff, Xj_w)


def render_image(T: torch.Tensor, h: int, w: int, f: float) -> torch.Tensor:
    """Normalized (B, h, w, 3) images in [-1, 1]: smooth functions of the
    world point each pixel sees."""
    _, Xw = render_frame(T, h, w, f)
    img = torch.stack([torch.sin(2.1 * Xw[..., 0]) * torch.cos(1.3 * Xw[..., 1]),
                       torch.sin(1.7 * Xw[..., 1] + 0.5),
                       torch.cos(2.9 * Xw[..., 0] + 1.1 * Xw[..., 2])], dim=-1)
    return img.reshape(-1, h, w, 3)


def render_images(poses: torch.Tensor, h: int, w: int, f: float, chunk: int = 16):
    """(uint8 (n, h, w, 3) on the host, normalized (n, h, w, 3) on the
    device) for poses (n, 8), rendered in chunks; the normalized image is
    the uint8 one read back as the program's loader reads it."""
    u8 = torch.cat([torch.round((render_image(p, h, w, f) + 1.0) * 127.5).clamp(0, 255)
                    .to(torch.uint8) for p in poses.split(chunk)])
    return u8.cpu().numpy(), u8.float() / 127.5 - 1.0
