"""Plain reference of the dynamic mask's coarse decision: the flow that
camera motion alone induces, its error against the optical flow, and the
threshold.

For each pixel p of frame i with depth d, the point d K^-1 p is moved into
frame j by the relative Sim(3) pose T_WCj^-1 T_WCi (4x4 matrices, the
rotation block carrying the scale) and projected by K; the ego-motion flow
is that projection less p (depth clamped at 1e-6 in front of frame j, as
the program clamps it). The error map is the per-pixel distance between the
optical flow and the ego-motion flow, min-max normalized over the frame
(all zero where it is constant), and a pixel is dynamic where it exceeds
the threshold (MonST3R-SLAM's `get_dynamic_mask`). `P` rounds the operands
of the products to bfloat16 for the control, as `raft.py` does.
"""

from __future__ import annotations

import torch

from benchmark.reference.raft import identity


def matrix(T8):
    """4x4 f32 matrix of a Sim(3) 8-vector [t, q (xyzw), s]."""
    T8 = T8.float()
    x, y, z, w = T8[3:7] / torch.linalg.vector_norm(T8[3:7])
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])
    M = torch.eye(4, device=T8.device)
    M[:3, :3] = T8[7] * R
    M[:3, 3] = T8[:3]
    return M


def ego_flow(T_WCi, T_WCj, depth, K, P=identity):
    """(h, w, 2) flow of frame i's pixels into frame j under camera motion alone."""
    h, w = depth.shape
    M = torch.linalg.inv(matrix(T_WCj)) @ matrix(T_WCi)
    K = K.float()
    v, u = torch.meshgrid(torch.arange(h, device=depth.device, dtype=torch.float32),
                          torch.arange(w, device=depth.device, dtype=torch.float32),
                          indexing="ij")
    ray = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], torch.ones_like(u)], -1)
    X = depth.float()[..., None] * ray
    Xj = P(X) @ P(M[:3, :3]).T + M[:3, 3]
    z = Xj[..., 2].clamp(min=1e-6)
    return torch.stack([K[0, 0] * Xj[..., 0] / z + K[0, 2] - u,
                        K[1, 1] * Xj[..., 1] / z + K[1, 2] - v], -1)


def error_map(flow, ego):
    e = torch.linalg.vector_norm(flow.float() - ego, dim=-1)
    lo, hi = e.min(), e.max()
    return (e - lo) / (hi - lo) if hi > lo else torch.zeros_like(e)


def coarse(flow, T_WCi, T_WCj, depth, K, P=identity):
    """The normalized error map (h, w) of the frame pair."""
    return error_map(flow, ego_flow(T_WCi, T_WCj, depth, K, P))


def flip_share(err_got, err_ref, threshold: float, band: float = 1e-3) -> float:
    """The share of pixels whose decision (error above the threshold)
    differs between two error maps, pixels whose reference error lies within
    `band` of the threshold left out (of every pixel; those count as equal)."""
    got = err_got.float() > threshold
    ref = err_ref.float() > threshold
    near = (err_ref.float() - threshold).abs() <= band
    return float(((got != ref) & ~near).float().mean())
