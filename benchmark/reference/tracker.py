"""Plain reference of the tracker's pose solve: MASt3R-SLAM's frame-to-
keyframe alignment on the ray and distance residual.

The frame's points Xf (gathered through the match) are moved by the
relative Sim(3) pose T; each valid pixel gives the residual between the
keyframe point's [unit ray, distance] and the moved point's, weighted by
sqrt(Q) / sigma (rays sigma_ray, distance sigma_dist) and Huber's weight.
Gauss-Newton takes left steps T <- exp(xi) T from the normal equations and
stops after the step at which the relative cost decrease or the step's
norm falls under its threshold, at a failed solve, or at `max_iters`. Poses
are 4x4 matrices here: the exponential is `torch.linalg.matrix_exp` of the
sim(3) generator and the Jacobian comes from forward-mode autodiff, both
independent of the program's closed forms. `dtype` float64 is the
reference; bfloat16 is the control (residuals, Jacobians and normal
equations in bf16, the 7x7 solve in f32).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from benchmark.harness.scene import quat_matrix


def matrix(T8):
    """4x4 matrix of a Sim(3) 8-vector [t, q (xyzw), s]."""
    T8 = T8.double()
    M = torch.eye(4, dtype=torch.float64, device=T8.device)
    M[:3, :3] = T8[7] * quat_matrix(T8[3:7])
    M[:3, 3] = T8[:3]
    return M


def exp(xi):
    """exp of the sim(3) generator [tau, phi, sigma] as a 4x4 matrix."""
    tau, phi, sigma = xi[:3], xi[3:6], xi[6]
    z = torch.zeros((), dtype=xi.dtype, device=xi.device)
    A = torch.stack([
        torch.stack([sigma, -phi[2], phi[1], tau[0]]),
        torch.stack([phi[2], sigma, -phi[0], tau[1]]),
        torch.stack([-phi[1], phi[0], sigma, tau[2]]),
        torch.stack([z, z, z, z]),
    ])
    return torch.linalg.matrix_exp(A)


def ray_dist(X):
    d = torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    return torch.cat([X / d, d], dim=-1)


def solve_pose(Xf, Xk, M_init, Qk, valid, cfg, dtype=torch.float64):
    """(M (4x4 float64), iterations) of the Gauss-Newton alignment."""
    info = torch.sqrt(Qk[:, 0].clamp(min=0)).double() * valid[:, 0].double()
    sig = torch.tensor([cfg.sigma_ray] * 3 + [cfg.sigma_dist], dtype=torch.float64,
                       device=Xf.device)
    info = (info[:, None] / sig).to(dtype)
    Xf, rd_k = Xf.to(dtype), ray_dist(Xk.double()).to(dtype)
    M = M_init.double()
    old_cost = torch.tensor(float("inf"), dtype=torch.float64, device=Xf.device)
    for it in range(1, cfg.max_iters + 1):
        Md = M.to(dtype)

        def residual(xi):
            E = exp(xi.double()).to(dtype) @ Md
            return rd_k - ray_dist(Xf @ E[:3, :3].T + E[:3, 3])

        zero = torch.zeros(7, dtype=dtype, device=Xf.device)
        e = residual(zero)
        J = jacfwd(residual)(zero)  # (n, 4, 7)
        wr = info * e
        w = info * info * torch.where(wr.abs() < cfg.huber, torch.ones_like(wr),
                                      cfg.huber / wr.abs().clamp(min=1e-30))
        wJ = (w[..., None] * J).reshape(-1, 7)
        H = (wJ.T @ J.reshape(-1, 7)).double()
        g = -(wJ.T @ e.reshape(-1)).double()
        cost = 0.5 * (w * e * e).double().sum()
        L, bad = torch.linalg.cholesky_ex(H.float() if dtype != torch.float64 else H)
        xi = torch.cholesky_solve(g.to(L.dtype)[:, None], L)[:, 0].double()
        ok = bool(bad == 0) and bool(torch.isfinite(xi).all())
        if ok:
            M = exp(xi) @ M
        done = (abs((old_cost - cost) / old_cost) < cfg.rel_error
                or float(torch.linalg.vector_norm(xi)) < cfg.delta_norm)
        old_cost = cost
        if done or not ok:
            return M, it
    return M, cfg.max_iters


def track(args: dict, dtype=torch.float64):
    """The relative pose keyframe <- frame (4x4) that the tracker's gates
    and solve give for one frame's captured inputs (`track_pose`'s)."""
    cfg = args["cfg"]
    idx = args["idx_f2k"].long()
    Qk = torch.sqrt(args["Qff"][idx].double() * args["Qkf"].double())
    Cf = args["Cf_avg"][idx]
    valid = (args["valid_match_k"] & (Cf > cfg.C_conf) & (args["Ck_avg"] > cfg.C_conf)
             & (Qk > cfg.Q_conf))
    M_init = torch.linalg.solve(matrix(args["T_WCk"]), matrix(args["T_WCf"]))
    return solve_pose(args["Xf_canon"][idx], args["Xk_canon"], M_init, Qk, valid, cfg, dtype)


def pose_gap(T8_got, M_ref) -> float:
    """Largest entry of the difference of the two poses' 3x4 matrices."""
    return float((matrix(T8_got) - M_ref)[:3].abs().max())
