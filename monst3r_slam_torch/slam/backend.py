"""Backend pose-graph Gauss-Newton over dense pointmap correspondences.

Port of the JAX package's `slam/backend.py` for one device: the
pose-independent gathers and gates run once per solve (`_gather_edges`);
each iteration accumulates the per-edge 7x7 blocks A = Jj^T W Jj and
b = Jj^T W err (Ji = -Jj), on the ray/distance residual in
structure-of-arrays form (`_edge_terms_ray_soa`) or on the calibrated
reprojection or the 3D point residual (`_edge_terms_local`), and scatters
them into the dense reduced system (`_assemble_dense`). `gauss_newton` solves that with
the f32 Jacobi-preconditioned Cholesky (`_solve_dense`) and reads the step
norm on the host once per iteration; `gauss_newton_host_solve` reads the
assembled (H, g) back once per iteration and solves it in float64 with the
native solver (`native/solver.cpp`), the reference's GPU-kernel +
CPU-Eigen split. `gauss_newton_sharded` splits the edges over a device
mesh (parallel/mesh.py) and sums the shards' dense systems each iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from monst3r_slam_torch.core import geometry, lie, robust
from monst3r_slam_torch.parallel.mesh import replicate, split_rows


class BackendConfig(NamedTuple):
    """Static backend parameters (config/base.yaml `local_opt`)."""

    pin: int = 1
    C_conf: float = 0.0
    Q_conf: float = 1.5
    max_iters: int = 10
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    delta_norm: float = 1e-8
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    # Keep every S-th pixel slot in the residual set (1 = every pixel).
    pixel_subsample: int = 1
    # Pad-bucket floors for the (P poses, E edges) shapes of a solve.
    pose_pad_lo: int = 8
    edge_pad_lo: int = 8
    # Extra ridge on each keyframe's scale coordinate of the Jacobi-scaled
    # (unit-diagonal) system, a prior on the weakly determined scale gauge
    # under sigma_dist whitening; it leaves rotation and translation alone.
    # 0 = off.
    scale_gauge: float = 0.0


def _point_jac_local(P):
    """d(exp(eps) P)/d eps = [I | -skew(P) | P], (..., 3, 7)."""
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.skew(P), P[..., :, None]], dim=-1)


def _ray_residual(Xi, Xj_Ci):
    """Residual and local Jacobian of the ray/dist alignment:
    (err (..., 4), J_local (..., 4, 7)). The generic form of what
    `_edge_terms_ray_soa` accumulates in closed form."""
    rd_i = geometry.point_to_ray_dist(Xi)
    rd_j, drd_dP = geometry.point_to_ray_dist(Xj_Ci, jacobian=True)
    return rd_j - rd_i, drd_dP @ _point_jac_local(Xj_Ci)


def _calib_residual(Xi, Xj_Ci, ind_Xi, K, height, width, border, z_eps):
    """Residual, local Jacobian and validity of the calibrated reprojection
    alignment (gn_kernels.cu:1352-1430): [u, v, log z] of Xj_Ci against the
    grid position of the matched pixel ind_Xi and the log depth of Xi."""
    fx, fy, cx, cy = geometry.decompose_K(K)
    u_t = (ind_Xi % width).to(Xi.dtype)
    v_t = torch.div(ind_Xi, width, rounding_mode="floor").to(Xi.dtype)
    zj = Xj_Ci[..., 2]
    valid_z = (zj > z_eps) & (Xi[..., 2] > z_eps)
    zj_safe = torch.where(valid_z, zj, torch.ones_like(zj))
    zj_inv = 1.0 / zj_safe
    x_div_z = Xj_Ci[..., 0] * zj_inv
    y_div_z = Xj_Ci[..., 1] * zj_inv
    u = fx * x_div_z + cx
    v = fy * y_div_z + cy
    valid_uv = (u > border) & (u < width - 1 - border) & (v > border) & (v < height - 1 - border)
    logz = torch.log(zj_safe) - torch.log(torch.clamp(Xi[..., 2], min=1e-30))
    err = torch.stack([u - u_t, v - v_t, torch.where(valid_z, logz, torch.zeros_like(logz))],
                      dim=-1)
    zero = torch.zeros_like(zj_inv)
    dP = torch.stack([
        torch.stack([fx * zj_inv, zero, -fx * x_div_z * zj_inv], dim=-1),
        torch.stack([zero, fy * zj_inv, -fy * y_div_z * zj_inv], dim=-1),
        torch.stack([zero, zero, zj_inv], dim=-1),
    ], dim=-2)
    return err, dP @ _point_jac_local(Xj_Ci), valid_z & valid_uv


def _point_residual(Xi, Xj_Ci):
    """Residual and local Jacobian of the 3D point alignment
    (gn_kernels.cu:455-811 point_align_kernel; exposed by the reference but
    unused by its mains): err = Xj_Ci - Xi, J_local = [I | -skew | P]."""
    return Xj_Ci - Xi, _point_jac_local(Xj_Ci)


def _sig_inv(cfg: BackendConfig, calib, residual_kind: str, like):
    """Per-row inverse sigmas of the residual: pixel (u, v) and depth when
    calibrated, else point (x, y, z), else ray (3) and distance."""
    if calib is not None:
        sig_a, sig_b, rep_a = cfg.sigma_pixel, cfg.sigma_depth, 2
    elif residual_kind == "point":
        sig_a, sig_b, rep_a = cfg.sigma_point, cfg.sigma_point, 2
    else:
        sig_a, sig_b, rep_a = cfg.sigma_ray, cfg.sigma_dist, 3
    return like.new_tensor([1.0 / sig_a] * rep_a + [1.0 / sig_b])


class Gathered(NamedTuple):
    """Pose-independent per-pixel solve inputs, (E, n) each."""

    Xi: torch.Tensor  # (E, n, 3) matched points of frame i
    Xj: torch.Tensor  # (E, n, 3) dense-grid points of frame j
    wq: torch.Tensor  # (E, n) sqrt(max(Q, 0))
    valid: torch.Tensor  # (E, n) bool: every pose-independent gate
    ind: torch.Tensor  # (E, n) matched pixel index of frame i (calibrated u, v)


def _gather_edges(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
                  cfg: BackendConfig) -> Gathered:
    """Gather and gate everything that does not depend on the poses, once.
    `cfg.pixel_subsample` S keeps every S-th pixel slot."""
    S = max(1, cfg.pixel_subsample)
    idx = idx_ii2jj[:, ::S].long()
    vm = valid_match[:, ::S]
    Q = Q[:, ::S]
    XC = torch.cat([Xs, Cs], dim=-1)  # (P, hw, 4)
    ind_Xi = torch.where(vm, idx, torch.zeros_like(idx))
    XCi = torch.gather(XC[ii], 1, ind_Xi[..., None].expand(-1, -1, 4))
    XCj = XC[jj][:, ::S]
    valid = (
        vm & (Q > cfg.Q_conf) & (XCi[..., 3] > cfg.C_conf) & (XCj[..., 3] > cfg.C_conf)
        & edge_valid[:, None]
    )
    wq = torch.sqrt(torch.clamp(Q, min=0.0))
    return Gathered(XCi[..., 0:3], XCj[..., 0:3], wq, valid, ind_Xi)


def _edge_terms_ray_soa(Twc, ii, jj, gat: Gathered, cfg: BackendConfig):
    """Per-edge A (E, 7, 7) and b (E, 7) of the ray/dist system.

    With Y = Tij o Xj, d = |Y|, ry = Y / d, u = R_i ry and (t, q, s) = T_i,
    the rows of Jj = Adj(T_i)^-T J_local are, for p < 3 (R[:, p] a column
    of R_i),
        [ (R[:, p] - ry_p u) / (s d) | -(R[:, p] x u) + t x Rap / s | t . Rap / s ]
    with Rap = (R[:, p] - ry_p u) / d, and for the distance row
        [ u / s | t x u / s | d + t . u / s ].
    """
    Ti = Twc[ii]
    Tij = lie.sim3_rel(Ti, Twc[jj])
    y = lie.sim3_act(Tij[:, None, :], gat.Xj)  # (E, n, 3)
    d = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    dinv = 1.0 / d
    ry = y * dinv
    di = torch.linalg.vector_norm(gat.Xi, dim=-1, keepdim=True)
    e = torch.cat([ry - gat.Xi * (1.0 / di), d - di], dim=-1)  # (E, n, 4)

    Ra = lie.so3_matrix(Ti[:, 3:7])[:, None]  # (E, 1, 3, 3)
    t = Ti[:, None, 0:3]  # (E, 1, 3)
    s_inv = (1.0 / Ti[:, 7])[:, None, None]  # (E, 1, 1)
    u = (Ra @ ry[..., None])[..., 0]  # R_i ry
    Rcols = Ra.transpose(-1, -2)  # row p = R[:, p]
    Rap = (Rcols - ry[..., :, None] * u[..., None, :]) * dinv[..., None]  # (E, n, 3, 3)
    Rbp = torch.linalg.cross(Rcols.expand_as(Rap), u[..., None, :].expand_as(Rap), dim=-1)
    tt = t[..., None, :].expand_as(Rap)
    tRa = torch.linalg.cross(tt, Rap, dim=-1)
    si = s_inv[..., None]
    J_ray = torch.cat([si * Rap, -Rbp + si * tRa, si * (tt * Rap).sum(-1, keepdim=True)], dim=-1)
    tu = torch.linalg.cross(t.expand_as(u), u, dim=-1)
    J_dist = torch.cat([s_inv * u, s_inv * tu, d + s_inv * (t * u).sum(-1, keepdim=True)], dim=-1)
    J = torch.cat([J_ray, J_dist[..., None, :]], dim=-2)  # (E, n, 4, 7)

    sig = e.new_tensor([1.0 / cfg.sigma_ray] * 3 + [1.0 / cfg.sigma_dist])
    sw = torch.where(gat.valid[..., None], sig * gat.wq[..., None], torch.zeros_like(e))
    w = robust.huber(sw * e) * sw * sw  # (E, n, 4)
    wJ = w[..., None] * J
    A = torch.einsum("enrp,enrq->epq", wJ, J)
    b = torch.einsum("enrp,enr->ep", wJ, e)
    return A, b


def _edge_terms_local(Twc, ii, jj, gat: Gathered, cfg: BackendConfig, calib, residual_kind):
    """Per-edge A (E, 7, 7) and b (E, 7) of the calibrated reprojection or
    the point residual, from its local Jacobian moved to the absolute pose
    of j, Jj = Adj(T_i)^-T J_local (Ji = -Jj, gn_kernels.cu:988-1000)."""
    Ti = Twc[ii]
    Tij = lie.sim3_rel(Ti, Twc[jj])
    Xj_Ci = lie.sim3_act(Tij[:, None, :], gat.Xj)
    valid = gat.valid
    if calib is not None:
        K, img_size = calib
        err, J_local, valid_px = _calib_residual(
            gat.Xi, Xj_Ci, gat.ind, K, img_size[0], img_size[1], cfg.pixel_border,
            cfg.depth_eps)
        valid = valid & valid_px
    else:
        err, J_local = _point_residual(gat.Xi, Xj_Ci)
    sig = _sig_inv(cfg, calib, residual_kind, err)
    sqrt_w = torch.where(valid[..., None], sig * gat.wq[..., None], torch.zeros_like(err))
    w = robust.huber(sqrt_w * err) * sqrt_w * sqrt_w  # (E, n, 3)
    Jj = lie.sim3_adj_inv_T_apply(Ti[:, None, None, :], J_local)  # (E, n, 3, 7)
    wJ = w[..., None] * Jj
    return torch.einsum("enrp,enrq->epq", wJ, Jj), torch.einsum("enrp,enr->ep", wJ, err)


def _edge_terms(Twc, ii, jj, gat: Gathered, cfg: BackendConfig, calib,
                residual_kind: str = "ray"):
    """A and b of the residual: `calib` is (K, img_size) or None, and
    without it `residual_kind` picks 'ray' (the structure-of-arrays route)
    or 'point'."""
    if calib is None and residual_kind == "ray":
        return _edge_terms_ray_soa(Twc, ii, jj, gat, cfg)
    return _edge_terms_local(Twc, ii, jj, gat, cfg, calib, residual_kind)


def _assemble_dense(A, b, ii, jj, edge_valid, n_poses: int, cfg: BackendConfig):
    """Scatter H = [[A, -A], [-A, A]], g = [-b, b] of every edge into the
    dense reduced (dim, dim) system, dim = (P - pin) * 7; pinned and invalid
    blocks go to a trash block that is cut off."""
    n_opt = n_poses - cfg.pin
    dim = n_opt * 7

    def opt_idx(a):
        oi = a - cfg.pin
        return torch.where((oi < 0) | ~edge_valid, torch.full_like(oi, n_opt), oi)

    oi, oj = opt_idx(ii), opt_idx(jj)
    Hd = torch.zeros((dim + 7, dim + 7), dtype=A.dtype, device=A.device)
    gd = torch.zeros((dim + 7,), dtype=A.dtype, device=A.device)
    r7 = torch.arange(7, device=A.device)
    for a, bb, blk in ((oi, oi, A), (oi, oj, -A), (oj, oi, -A), (oj, oj, A)):
        rows = (a[:, None, None] * 7 + r7[None, :, None]).expand_as(blk)
        cols = (bb[:, None, None] * 7 + r7[None, None, :]).expand_as(blk)
        Hd.index_put_((rows, cols), blk, accumulate=True)
    for a, vec in ((oi, -b), (oj, b)):
        gd.index_put_(((a[:, None] * 7 + r7[None, :]),), vec, accumulate=True)
    return Hd[:dim, :dim], gd[:dim]


def _solve_dense(H_opt, g_opt, n_poses: int, cfg: BackendConfig):
    """Jacobi-preconditioned, damped f32 Cholesky solve -> dx (P, 7), pinned
    rows zero. A failed factorization gives dx = 0, as the reference's NaN
    filter does."""
    n_opt = n_poses - cfg.pin
    dim = n_opt * 7
    diag = torch.diagonal(H_opt)
    damp = 1e-6 * torch.clamp(torch.max(torch.abs(diag)), min=1.0)
    s = torch.rsqrt(torch.maximum(diag, damp))
    Hs = H_opt * s[:, None] * s[None, :]
    Hs = Hs + 1e-6 * torch.eye(dim, dtype=Hs.dtype, device=Hs.device)
    if cfg.scale_gauge > 0.0:
        # The prior on the scale coordinate (index 6 of each 7-block) in the
        # unit-diagonal space; see BackendConfig.scale_gauge.
        sg = torch.zeros(dim, dtype=Hs.dtype, device=Hs.device)
        sg[6::7] = cfg.scale_gauge
        Hs = Hs + torch.diag(sg)
    L, info = torch.linalg.cholesky_ex(Hs)
    dx = -(s * torch.cholesky_solve((s * g_opt)[:, None], L)[:, 0])
    dx = torch.where(torch.isfinite(dx) & (info == 0), dx, torch.zeros_like(dx))
    return torch.cat([torch.zeros((cfg.pin, 7), dtype=dx.dtype, device=dx.device),
                      dx.reshape(n_opt, 7)], dim=0)


@torch.no_grad()
def gauss_newton(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
                 cfg: BackendConfig, n_poses: int, use_calib: bool = False, K=None,
                 img_size=None, residual_kind: str = "ray"):
    """Global GN with the f32 device solve. Twc (P, 8); Xs (P, hw, 3);
    Cs (P, hw, 1); ii/jj (E,); idx_ii2jj (E, hw); valid_match (E, hw);
    Q (E, hw); edge_valid (E,); `use_calib` takes the reprojection residual
    with K (3, 3) at img_size (h, w), else `residual_kind` 'ray' or 'point'.
    Returns (new Twc, iterations)."""
    calib = (K, img_size) if use_calib else None
    gat = _gather_edges(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid, cfg)
    it = 0
    while it < cfg.max_iters:
        A, b = _edge_terms(Twc, ii, jj, gat, cfg, calib, residual_kind)
        H_opt, g_opt = _assemble_dense(A, b, ii, jj, edge_valid, n_poses, cfg)
        dx = _solve_dense(H_opt, g_opt, n_poses, cfg)
        Twc = lie.sim3_retr(Twc, dx)
        it += 1
        if float(torch.linalg.vector_norm(dx)) < cfg.delta_norm:
            break
    return Twc, it


@torch.no_grad()
def gauss_newton_sharded(mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
                         cfg: BackendConfig, n_poses: int, use_calib: bool = False, K=None,
                         img_size=None, residual_kind: str = "ray", axis: str = "dp"):
    """`gauss_newton` with the edges split over the mesh's `axis`: the
    edge tensors (E, ...) in contiguous blocks, one per shard device, with
    the poses, points and confidences (and K) copied to each distinct one.
    Each shard gathers its edges once; each iteration it linearizes and
    assembles its dense (dim, dim) system, the systems are summed in shard
    order on the home device, and the one solve and retraction there give
    the poses, copied back to the other devices. Same stop rule as
    `gauss_newton`. E must divide by the axis size (the factor graph pads
    it). Returns (new Twc on the home device, iterations)."""
    devs = mesh.shard_devices(axis)
    if ii.shape[0] % len(devs):
        raise ValueError(f"edge count {ii.shape[0]} must divide by {axis} size {len(devs)} "
                         "(pad the edges)")
    home = mesh.home
    Twc = Twc.to(home)
    Xs_r, Cs_r = replicate(mesh, Xs, axis), replicate(mesh, Cs, axis)
    K_r = replicate(mesh, K, axis) if use_calib else None
    edges = list(zip(*(split_rows(mesh, t, axis)
                       for t in (ii, jj, idx_ii2jj, valid_match, Q, edge_valid))))
    gats = [_gather_edges(Xs_r[dev], Cs_r[dev], *shard, cfg) for dev, shard in zip(devs, edges)]
    it = 0
    while it < cfg.max_iters:
        Twc_r = replicate(mesh, Twc, axis)
        H_opt = g_opt = None
        for dev, (ii_s, jj_s, _, _, _, ev_s), gat in zip(devs, edges, gats):
            calib = (K_r[dev], img_size) if use_calib else None
            A, b = _edge_terms(Twc_r[dev], ii_s, jj_s, gat, cfg, calib, residual_kind)
            H_s, g_s = _assemble_dense(A, b, ii_s, jj_s, ev_s, n_poses, cfg)
            H_s, g_s = H_s.to(home), g_s.to(home)
            H_opt = H_s if H_opt is None else H_opt + H_s
            g_opt = g_s if g_opt is None else g_opt + g_s
        dx = _solve_dense(H_opt, g_opt, n_poses, cfg)
        Twc = lie.sim3_retr(Twc, dx)
        it += 1
        if float(torch.linalg.vector_norm(dx)) < cfg.delta_norm:
            break
    return Twc, it


@torch.no_grad()
def gauss_newton_host_solve(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
                            cfg: BackendConfig, n_poses: int, use_calib: bool = False, K=None,
                            img_size=None):
    """The GN loop of `gauss_newton` with each linear solve in float64 on the
    host (the native solver): the device linearizes and assembles (H, g),
    which is read back in one transfer per iteration, and the step goes back
    as f32. A solve that fails even with jitter ends the loop, keeping the
    poses of the last good step. Returns (new Twc, steps applied)."""
    from monst3r_slam_torch.native.build import solve_spd

    calib = (K, img_size) if use_calib else None
    n_opt = n_poses - cfg.pin
    dim = n_opt * 7
    gat = _gather_edges(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid, cfg)
    pinned = torch.zeros((cfg.pin, 7), dtype=Twc.dtype, device=Twc.device)
    it = 0
    while it < cfg.max_iters:
        A, b = _edge_terms(Twc, ii, jj, gat, cfg, calib)
        H_opt, g_opt = _assemble_dense(A, b, ii, jj, edge_valid, n_poses, cfg)
        Hg = torch.cat([H_opt.reshape(-1), g_opt]).cpu().numpy().astype(np.float64)
        try:
            dx = -solve_spd(Hg[: dim * dim].reshape(dim, dim), Hg[dim * dim:], jitter=1e-12)
        except np.linalg.LinAlgError:
            break
        it += 1
        dx_t = torch.from_numpy(dx.astype(np.float32).reshape(n_opt, 7)).to(Twc.device)
        Twc = lie.sim3_retr(Twc, torch.cat([pinned, dx_t]))
        if float(np.linalg.norm(dx)) < cfg.delta_norm:
            break
    return Twc, it
