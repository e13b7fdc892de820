"""Frontend tracker: per-frame Sim(3) pose Gauss-Newton against the last
keyframe.

Port of the JAX package's `slam/tracker.py`. The JAX `lax.while_loop`s
become Python loops with one host read per iteration (the stop test), or,
with `fixed_iters` (chunked tracking, which reads nothing back inside a
chunk), masked loops of `max_iters` steps in which a stopped loop's steps
select the old pose exactly, so both give the same result; the
uncalibrated ray/distance normal equations are built from the closed-form
Jacobian rows of the reference's structure-of-arrays body, vectorized over
pixels, and the calibrated ones (`opt_pose_calib_sim3`: pixel and
log-depth residuals against the keyframe's grid) from the generic
whitened-residual form. A failed Cholesky (not positive definite) is
reported as `solver_failed`, as the reference's NaN test does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monst3r_slam_torch.core import geometry, lie, robust


class TrackingConfig(NamedTuple):
    """Static tracking parameters (config/base.yaml `tracking`)."""

    min_match_frac: float = 0.05
    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber: float = 1.345
    match_frac_thresh: float = 0.333
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    filtering_mode: str = "weighted_pointmap"
    filtering_score: str = "median"


class TrackResult(NamedTuple):
    T_WCf: torch.Tensor  # (8,) updated frame pose
    T_CkCf: torch.Tensor  # (8,) relative pose keyframe<-frame
    new_kf: torch.Tensor  # () bool — keyframe decision
    low_match: torch.Tensor  # () bool — match_frac below min => RELOC
    solver_failed: torch.Tensor  # () bool — Cholesky failed / non-finite step
    match_frac: torch.Tensor  # () float
    iters: object  # int, or a () int tensor with fixed_iters


def _cholesky_solve(H: torch.Tensor, g: torch.Tensor):
    """Solve H x = g by Cholesky; (x, ok), x zeroed where the factorization
    failed or the solution is not finite."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[..., None], L)[..., 0]
    ok = (info == 0) & torch.isfinite(x).all(dim=-1)
    return torch.where(ok[..., None], x, torch.zeros_like(x)), ok


def _normal_equations(sqrt_info, r, J, huber_k: float):
    """Whitened robust normal equations: sqrt_info, r (n, m); J (n, m, 7)
    -> (H (7, 7), g (7,), cost)."""
    w = sqrt_info * torch.sqrt(robust.huber(sqrt_info * r, huber_k))
    A = (w[..., None] * J).reshape(-1, 7)
    b = (w * r).reshape(-1)
    return A.T @ A, -(A.T @ b), 0.5 * torch.dot(b, b)


def _solve_7x7(sqrt_info, r, J, huber_k: float):
    """Whitened robust normal equations + Cholesky solve.
    sqrt_info, r: (n, m); J: (n, m, 7). Returns (tau (7,), cost, ok)."""
    H, g, cost = _normal_equations(sqrt_info, r, J, huber_k)
    tau, ok = _cholesky_solve(H, g)
    return tau, cost, ok


def _gn_loop(cfg: TrackingConfig, system, T_init: torch.Tensor, fixed_iters: bool = False):
    """GN driver with the reference's stop rule. `system(T)` returns the
    normal equations (H (7, 7), g (7,), cost). Returns (T, iters, ok)."""
    T = T_init
    old_cost = torch.full((), torch.inf, dtype=T.dtype, device=T.device)
    if fixed_iters:
        return _gn_loop_masked(cfg, system, T, old_cost)
    it = 0
    while True:
        H, g, new_cost = system(T)
        tau, ok = _cholesky_solve(H, g)
        T = torch.where(ok, lie.sim3_retr(T, tau), T)
        done = robust.converged(cfg.rel_error, cfg.delta_norm, old_cost, new_cost, tau)
        old_cost = new_cost
        it += 1
        if it >= cfg.max_iters or bool(done | ~ok):
            return T, it, ok


def _gn_loop_masked(cfg: TrackingConfig, system, T, old_cost):
    """`_gn_loop` without a host read: always `max_iters` steps; once the
    stop rule has fired, every later step keeps T and ok as they were."""
    stopped = torch.zeros((), dtype=torch.bool, device=T.device)
    ok_out = torch.ones((), dtype=torch.bool, device=T.device)
    iters = torch.zeros((), dtype=torch.int32, device=T.device)
    for _ in range(cfg.max_iters):
        H, g, new_cost = system(T)
        tau, ok = _cholesky_solve(H, g)
        T = torch.where(stopped | ~ok, T, lie.sim3_retr(T, tau))
        ok_out = torch.where(stopped, ok_out, ok)
        iters = iters + (~stopped).to(torch.int32)
        stopped = stopped | robust.converged(cfg.rel_error, cfg.delta_norm, old_cost, new_cost,
                                             tau) | ~ok
        old_cost = new_cost
    return T, iters, ok_out


def opt_pose_ray_dist_sim3(Xf, Xk, T_CkCf_init, Qk, valid, cfg: TrackingConfig,
                           fixed_iters: bool = False):
    """Uncalibrated frame-to-keyframe alignment on the ray/distance residual.

    Xf: (n, 3) frame points (gathered through idx_f2k), Xk: (n, 3),
    Qk: (n, 1), valid: (n, 1) bool. With Y = T o Xf, d = |Y|, ry = Y / d the
    Jacobian rows of r = rd(Xk) - rd(Y) are
        ray rows:  -[ (I - ry ry^T)/d | -skew(Y)/d | 0 ]
        dist row:  -[ ry^T            | 0          | d ]
    """
    sqrtQ = torch.sqrt(torch.clamp(Qk[:, 0], min=0.0))
    vf = valid[:, 0]
    zero = torch.zeros_like(sqrtQ)
    info_ray = torch.where(vf, (1.0 / cfg.sigma_ray) * sqrtQ, zero)
    info_dist = torch.where(vf, (1.0 / cfg.sigma_dist) * sqrtQ, zero)
    info = torch.stack([info_ray, info_ray, info_ray, info_dist], dim=-1)  # (n, 4)
    rd_k = geometry.point_to_ray_dist(Xk)  # (n, 4)
    eye = torch.eye(3, dtype=Xf.dtype, device=Xf.device)

    def system(T):
        y = lie.sim3_act(T, Xf)
        d = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        dinv = 1.0 / d
        ry = y * dinv
        e = rd_k - torch.cat([ry, d], dim=-1)  # (n, 4)
        J_ray = torch.cat([
            -(eye - ry[:, :, None] * ry[:, None, :]) * dinv[..., None],
            lie.skew(y) * dinv[..., None],
            torch.zeros_like(y)[..., None],
        ], dim=-1)  # (n, 3, 7)
        J_dist = torch.cat([-ry, torch.zeros_like(ry), -d], dim=-1)[:, None]  # (n, 1, 7)
        J = torch.cat([J_ray, J_dist], dim=1)  # (n, 4, 7)
        w = info * info * robust.huber(info * e, cfg.huber)
        cost = 0.5 * torch.sum(w * e * e)
        wJ = (w[..., None] * J).reshape(-1, 7)
        Jf = J.reshape(-1, 7)
        H = wJ.T @ Jf
        g = -(wJ.T @ e.reshape(-1))
        return H, g, cost

    return _gn_loop(cfg, system, T_CkCf_init, fixed_iters)


def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k, valid_meas_k, K, img_size,
                        cfg: TrackingConfig, fixed_iters: bool = False):
    """Calibrated frame-to-keyframe alignment (tracker.py:216-266): residual
    [pixel (2), log depth (1)] of the frame's points projected into the
    keyframe, against the keyframe's pixel grid and log depth `meas_k`
    (n, 3). Xf, Xk: (n, 3) points on their pixel rays; Qk, valid: (n, 1)."""
    sqrtQ = torch.sqrt(torch.clamp(Qk, min=0.0))
    info_pix = (1.0 / cfg.sigma_pixel) * valid * sqrtQ
    info_depth = (1.0 / cfg.sigma_depth) * valid * sqrtQ
    sqrt_info = torch.cat([info_pix, info_pix, info_depth], dim=-1)  # (n, 3)

    def system(T):
        Xf_Ck, dX_dT = geometry.act_Sim3(T, Xf, jacobian=True)
        pz, dpz_dX, valid_proj = geometry.project_calib(
            Xf_Ck, K, img_size, jacobian=True, border=cfg.pixel_border, z_eps=cfg.depth_eps)
        J = -(dpz_dX @ dX_dT)
        return _normal_equations(sqrt_info * (valid_proj & valid_meas_k), meas_k - pz, J, cfg.huber)

    return _gn_loop(cfg, system, T_CkCf_init, fixed_iters)


def unique_fraction(idx: torch.Tensor, valid: torch.Tensor, n_total: int) -> torch.Tensor:
    """|unique(idx[valid])| / n_total via an occupancy scatter."""
    occ = torch.zeros((n_total,), dtype=torch.int32, device=idx.device)
    occ.scatter_reduce_(0, idx.long(), valid.to(torch.int32), reduce="amax")
    return occ.sum() / n_total


@torch.no_grad()
def track_pose(
    cfg: TrackingConfig,
    img_size,
    use_calib: bool,
    idx_f2k: torch.Tensor,  # (hw,) keyframe pixel -> frame pixel
    valid_match_k: torch.Tensor,  # (hw, 1) bool
    Qff: torch.Tensor,  # (hw, 1) frame desc-conf
    Qkf: torch.Tensor,  # (hw, 1) keyframe desc-conf (in frame's decode)
    Xf_canon: torch.Tensor,  # (hw, 3) frame canonical points (post-fusion)
    Cf_avg: torch.Tensor,  # (hw, 1)
    Xk_canon: torch.Tensor,  # (hw, 3) keyframe canonical points
    Ck_avg: torch.Tensor,  # (hw, 1)
    T_WCf: torch.Tensor,  # (8,) current frame pose estimate
    T_WCk: torch.Tensor,  # (8,) keyframe pose
    K=None,  # (3, 3) intrinsics of the resized frame, with use_calib
    fixed_iters: bool = False,  # GN without host reads (chunked tracking)
) -> TrackResult:
    """Validity gates, GN, and the keyframe decision for one frame."""
    hw = idx_f2k.shape[0]
    Qk = torch.sqrt(Qff[idx_f2k] * Qkf)
    Xf = Xf_canon[idx_f2k]
    Cf = Cf_avg[idx_f2k]

    valid_Q = Qk > cfg.Q_conf
    valid_opt = valid_match_k & (Cf > cfg.C_conf) & (Ck_avg > cfg.C_conf) & valid_Q
    valid_kf = valid_match_k & valid_Q
    match_frac = valid_opt.float().mean()
    low_match = match_frac < cfg.min_match_frac

    T_CkCf_init = lie.sim3_rel(T_WCk, T_WCf)
    if use_calib:
        Xf_c = geometry.constrain_points_to_ray(img_size, Xf[None], K)[0]
        Xk_c = geometry.constrain_points_to_ray(img_size, Xk_canon[None], K)[0]
        uv_k = geometry.get_pixel_coords(1, img_size, device=Xf.device).reshape(-1, 2)
        valid_meas_k = Xk_c[..., 2:3] > cfg.depth_eps
        logz = torch.log(torch.clamp(Xk_c[..., 2:3], min=1e-30))
        meas_k = torch.cat([uv_k, torch.where(valid_meas_k, logz, torch.zeros_like(logz))], dim=-1)
        meas_k = torch.where(valid_meas_k, meas_k, torch.zeros_like(meas_k))
        T_CkCf, iters, ok = opt_pose_calib_sim3(Xf_c, Xk_c, T_CkCf_init, Qk, valid_opt, meas_k,
                                                valid_meas_k, K, img_size, cfg, fixed_iters)
    else:
        T_CkCf, iters, ok = opt_pose_ray_dist_sim3(Xf, Xk_canon, T_CkCf_init, Qk, valid_opt, cfg,
                                                   fixed_iters)
    T_WCf_new = lie.sim3_mul(T_WCk, T_CkCf)

    match_frac_k = valid_kf.float().mean()
    unique_frac_f = unique_fraction(idx_f2k, valid_match_k[:, 0], hw)
    new_kf = torch.minimum(match_frac_k, unique_frac_f) < cfg.match_frac_thresh

    keep = low_match | ~ok
    return TrackResult(
        T_WCf=torch.where(keep, T_WCf, T_WCf_new),
        T_CkCf=T_CkCf,
        new_kf=new_kf & ~keep,
        low_match=low_match,
        solver_failed=~ok,
        match_frac=match_frac,
        iters=iters,
    )
