"""Ray/distance residual features, pinhole projections and point transforms
with their Jacobians.

Port of the JAX package's `core/geometry.py`: `point_to_dist`,
`point_to_ray_dist`, `act_Sim3`, and for the calibrated path
`decompose_K`, `project_calib`, `backproject`, `get_pixel_coords` and
`constrain_points_to_ray`.
"""

from __future__ import annotations

import torch

from monst3r_slam_torch.core import lie


def point_to_dist(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, dim=-1, keepdim=True)


def point_to_ray_dist(X: torch.Tensor, jacobian: bool = False):
    """4-dim residual features [unit ray (3), distance (1)] of points X; with
    ``jacobian=True`` also the 4x3 Jacobian d[r, d]/dX."""
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    d_inv_2 = d_inv * d_inv
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[:-1] + (3, 3))
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - d_inv_2[..., None] * outer)
    dd_dX = r[..., None, :]
    return rd, torch.cat([dr_dX, dd_dX], dim=-2)


def act_Sim3(T: torch.Tensor, X: torch.Tensor, jacobian: bool = False):
    """Apply Sim(3) T to points X; optionally the 3x7 Jacobian wrt a left
    perturbation of T, [I | -skew(T X) | T X]."""
    Y = lie.sim3_act(T, X)
    if not jacobian:
        return Y
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Y.shape[:-1] + (3, 3))
    return Y, torch.cat([eye, -lie.skew(Y), Y[..., :, None]], dim=-1)


def decompose_K(K: torch.Tensor):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P: torch.Tensor, K: torch.Tensor, img_size, jacobian: bool = False,
                  border: float = 0.0, z_eps: float = 0.0):
    """Pinhole projection -> [u, v, log z] and validity; returns (pz, valid)
    or (pz, dpz_dP, valid). `img_size` is (h, w)."""
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0], P[..., 1], P[..., 2]
    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    z_inv = 1.0 / z_safe
    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy
    valid_u = (u > border) & (u < w - 1 - border)
    valid_v = (v > border) & (v < h - 1 - border)
    valid = (valid_u & valid_v & valid_z)[..., None]
    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z_safe))
    pz = torch.stack([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid
    zero = torch.zeros_like(z_inv)
    row0 = torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1)
    row1 = torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1)
    row2 = torch.stack([zero, zero, z_inv], dim=-1)
    return pz, torch.stack([row0, row1, row2], dim=-2), valid


def backproject(p: torch.Tensor, z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels p (..., 2) and depth z (..., 1) -> 3D points."""
    x = (p[..., 0] - K[0, 2]) / K[0, 0]
    y = (p[..., 1] - K[1, 2]) / K[1, 1]
    return z * torch.stack([x, y, torch.ones_like(x)], dim=-1)


def get_pixel_coords(b: int, img_size, dtype=torch.float32, device=None) -> torch.Tensor:
    """(b, h, w, 2) grid of (u, v) pixel coordinates."""
    h, w = img_size
    v, u = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    uv = torch.stack([u, v], dim=-1).to(dtype)
    return uv.expand(b, h, w, 2)


def constrain_points_to_ray(img_size, Xs: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Snap points onto their pixel rays, keeping z. Xs: (b, h*w, 3)."""
    uv = get_pixel_coords(Xs.shape[0], img_size, dtype=Xs.dtype, device=Xs.device)
    return backproject(uv.reshape(*Xs.shape[:-1], 2), Xs[..., 2:3], K)
