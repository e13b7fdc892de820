"""Dense pointmap matching: the matcher configuration, the pixel/linear index
helpers, and the iterative-projection (LM) matcher.

Port of the JAX package's `ops/matching.py`. `iter_proj` finds, for every
query ray of frame j, the pixel of frame i's normalized-ray image whose
bilinearly interpolated ray matches it, by a per-pixel 2x2
Levenberg-Marquardt solve of exactly `max_iter` steps (the reference's
`fori_loop`: no early exit and no host read, the accept/reject update a
`torch.where`); `refine_matches` walks dilated descriptor windows from
`dilation_max` down to 1. Both are batched over b directly where the
reference vmaps. `match` adds the 3D-distance occlusion gate. The tiled
matcher (`matching_tiled.py`) uses only the configuration and the helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monst3r_slam_torch.core.image import img_gradient


class MatchingConfig(NamedTuple):
    """Static matcher parameters (config/base.yaml `matching`)."""

    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 0.1
    radius: int = 3
    dilation_max: int = 5


def pixel_to_lin(p: torch.Tensor, w: int) -> torch.Tensor:
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx: torch.Tensor, w: int) -> torch.Tensor:
    return torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")], dim=-1)


def _bilinear(img_flat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: int):
    """Sample (b, n, c) values of img_flat (b, h*w, c) at float pixels (u, v)
    (b, n), with the reference's pairing of corners and weights: du*dv on
    (v0+1, u0+1). Callers keep u in [1, w-2] and v in [1, h-2], so every tap
    is inside."""
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    base = u0.to(torch.int64) + w * v0.to(torch.int64)
    n_pix, c = img_flat.shape[1:]

    def tap(off):
        # A NaN step (the flat-patch inf of iter_proj) has NaN weights, and
        # its index is clamped into the image as JAX clamps a gather's.
        lin = torch.clamp(base + off, 0, n_pix - 1)
        return torch.gather(img_flat, 1, lin[..., None].expand(-1, -1, c))

    w00 = ((1 - du) * (1 - dv))[..., None]
    w01 = (du * (1 - dv))[..., None]
    w10 = ((1 - du) * dv)[..., None]
    w11 = (du * dv)[..., None]
    return w00 * tap(0) + w01 * tap(1) + w10 * tap(w) + w11 * tap(w + 1)


def _normalize(r: torch.Tensor) -> torch.Tensor:
    return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)


@torch.no_grad()
def iter_proj(rays_with_grad_img: torch.Tensor, pts3d_norm: torch.Tensor,
              p_init: torch.Tensor, cfg: MatchingConfig):
    """Batched LM projective association. rays_with_grad_img (b, h, w, 9):
    unit rays and their x and y gradients; pts3d_norm (b, n, 3); p_init
    (b, n, 2) float pixels. Returns (p (b, n, 2) float, converged (b, n) bool)."""
    b, h, w, _ = rays_with_grad_img.shape
    img_flat = rays_with_grad_img.reshape(b, h * w, 9)
    rays_flat = img_flat[..., 0:3]
    u = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, cfg.lambda_init)
    conv = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for _ in range(cfg.max_iter):
        samp = _bilinear(img_flat, u, v, w)
        r = _normalize(samp[..., 0:3])
        gx = samp[..., 3:6]
        gy = samp[..., 6:9]
        err = r - pts3d_norm
        cost = torch.sum(err * err, dim=-1)

        a00 = torch.sum(gx * gx, dim=-1) + lam
        a01 = torch.sum(gx * gy, dim=-1)
        a11 = torch.sum(gy * gy, dim=-1) + lam
        b0 = -torch.sum(err * gx, dim=-1)
        b1 = -torch.sum(err * gy, dim=-1)
        det_inv = 1.0 / (a00 * a11 - a01 * a01)  # inf on a flat patch, as in the reference
        du = det_inv * (a11 * b0 - a01 * b1)
        dv = det_inv * (-a01 * b0 + a00 * b1)

        u_new = torch.clamp(u + du, 1.0, w - 2.0)
        v_new = torch.clamp(v + dv, 1.0, h - 2.0)
        err_new = _normalize(_bilinear(rays_flat, u_new, v_new, w)) - pts3d_norm
        new_cost = torch.sum(err_new * err_new, dim=-1)

        accept = new_cost < cost
        u = torch.where(accept, u_new, u)
        v = torch.where(accept, v_new, v)
        lam = torch.where(accept, lam * 0.1, lam * 10.0)
        conv = torch.where(accept, new_cost, cost) < cfg.convergence_thresh
    return torch.stack([u, v], dim=-1), conv


@torch.no_grad()
def refine_matches(D11: torch.Tensor, D21: torch.Tensor, p: torch.Tensor, cfg: MatchingConfig):
    """Coarse-to-fine descriptor refinement. D11 (b, h, w, f), D21 (b, n, f),
    p (b, n, 2) integer pixels -> refined p (b, n, 2). At each dilation d
    from `dilation_max` down to 1 the (2r+1)^2 window of offsets (u-major)
    is scored; outside the image scores -inf; the first maximum wins."""
    b, h, w, f = D11.shape
    D11_flat = D11.reshape(b, h * w, f)
    u, v = p[..., 0], p[..., 1]
    r = cfg.radius
    side = 2 * r + 1
    n = u.shape[1]
    for d in range(cfg.dilation_max, 0, -1):
        offs = (torch.arange(side, device=p.device) - r) * d
        du = offs.repeat_interleave(side)  # u-major
        dv = offs.repeat(side)
        cu = u[..., None] + du  # (b, n, k)
        cv = v[..., None] + dv
        inside = (cu >= 0) & (cu < w) & (cv >= 0) & (cv < h)
        lin = (torch.clamp(cu, 0, w - 1) + w * torch.clamp(cv, 0, h - 1)).to(torch.int64)
        cand = torch.gather(D11_flat, 1, lin.reshape(b, -1, 1).expand(-1, -1, f))
        scores = torch.einsum("bnkf,bnf->bnk", cand.reshape(b, n, side * side, f), D21)
        scores = torch.where(inside, scores, torch.full_like(scores, -torch.inf))
        best = torch.argmax(scores, dim=-1, keepdim=True)
        u = torch.gather(cu, 2, best)[..., 0]
        v = torch.gather(cv, 2, best)[..., 0]
    return torch.stack([u, v], dim=-1)


def prep_for_iter_proj(X11: torch.Tensor, X21: torch.Tensor, idx_1_to_2_init=None):
    """The 9-channel ray image (rays, x and y gradients) of X11, the unit
    query rays of X21 and the initial pixel guesses (the identity without a
    warm start). X11/X21 (b, h, w, 3)."""
    b, h, w, _ = X11.shape
    rays = _normalize(X11)
    gx, gy = img_gradient(rays)
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    pts3d_norm = _normalize(X21.reshape(b, h * w, 3))
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device).expand(b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init, w).to(torch.float32)
    return rays_with_grad, pts3d_norm, p_init


@torch.no_grad()
def match(X11, X21, D11, D21, idx_1_to_2_init=None, cfg: MatchingConfig = MatchingConfig()):
    """The LM matcher. X11/X21 (b, h, w, 3) pointmaps, D11/D21 (b, h, w, f)
    descriptors. Returns (idx_1_to_2 (b, h*w) int64, valid (b, h*w, 1) bool)."""
    b, h, w, _ = X11.shape
    X11 = X11.float()
    X21 = X21.float()
    rays_img, pts3d_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    p, valid_proj = iter_proj(rays_img, pts3d_norm, p_init, cfg)
    p = p.to(torch.int32).to(torch.int64)  # p >= 1 after the clip: truncation is floor

    # occlusion gate on the matched 3D points
    lin = pixel_to_lin(p, w)
    gathered = torch.gather(X11.reshape(b, h * w, 3), 1, lin[..., None].expand(-1, -1, 3))
    dists = torch.linalg.vector_norm(gathered - X21.reshape(b, h * w, 3), dim=-1)
    valid = valid_proj & (dists < cfg.dist_thresh)

    if cfg.radius > 0:
        p = refine_matches(D11.float(), D21.float().reshape(b, h * w, -1), p, cfg)
    return pixel_to_lin(p, w), valid[..., None]
