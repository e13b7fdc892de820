"""Lie groups on tensors: SO(3), SE(3), Sim(3).

Same conventions as the JAX package's `core/lie.py`:
  * quaternions are (x, y, z, w);
  * a Sim(3) element is an 8-vector ``[t(3), q(4), s(1)]`` acting on points
    as ``Y = s * R(q) @ X + t``;
  * the tangent is a 7-vector ``[tau(3), phi(3), sigma(1)]``;
  * retraction is left composition, ``retr(T, xi) = exp(xi) o T``.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(qi: torch.Tensor, qj: torch.Tensor) -> torch.Tensor:
    """Hamilton product qi * qj, xyzw layout."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    return torch.stack(
        [
            wi * xj + xi * wj + yi * zj - zi * yj,
            wi * yj - xi * zj + yi * wj + zi * xj,
            wi * zj + xi * yj - yi * xj + zi * wj,
            wi * wj - xi * xj - yi * yj - zi * zj,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    # built on the device: a host-made sign vector would be a blocking copy
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v by unit quaternions q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (4th-order Taylor below 1e-6)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    theta_p4 = theta_sq * theta_sq
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_small = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag = torch.where(small, imag_small, torch.sin(0.5 * theta) / theta)
    real = torch.where(small, real_small, torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (inverse of so3_exp)."""
    w0 = q[..., 3:4]
    q = q * torch.sign(torch.where(w0 == 0.0, torch.ones_like(w0), w0))
    qv = q[..., :3]
    w = torch.clamp(q[..., 3:4], -1.0, 1.0)
    n_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n_sq < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    theta = 2.0 * torch.atan2(n, w)
    wc = torch.clamp(w, min=0.5)
    k_small = 2.0 / wc * (1.0 + n_sq / (3.0 * wc**2))
    k = torch.where(small, k_small, theta / n)
    return k * qv


def so3_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    rows = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def sim3_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return ident.expand(tuple(batch_shape) + (8,)).clone()


def sim3_act(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = s * R X + t, broadcasting T over X's point dimensions."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    return s * quat_rotate(q, X) + t


def sim3_mul(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """Composition Ti o Tj (apply Tj first)."""
    ti, qi, si = Ti[..., 0:3], Ti[..., 3:7], Ti[..., 7:8]
    tj, qj, sj = Tj[..., 0:3], Tj[..., 3:7], Tj[..., 7:8]
    q = quat_mul(qi, qj)
    s = si * sj
    t = si * quat_rotate(qi, tj) + ti
    return torch.cat(_bcat(t, q, s), dim=-1)


def _bcat(*parts):
    """Broadcast the leading dims of `parts` (last dims kept) for cat."""
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return [p.expand(lead + p.shape[-1:]) for p in parts]


def sim3_inv(T: torch.Tensor) -> torch.Tensor:
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    q_inv = quat_inv(q)
    s_inv = 1.0 / s
    t_inv = -s_inv * quat_rotate(q_inv, t)
    return torch.cat([t_inv, q_inv, s_inv], dim=-1)


def sim3_rel(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """Relative transform Ti^-1 o Tj."""
    return sim3_mul(sim3_inv(Ti), Tj)


def _sim3_W_coeffs(theta_sq: torch.Tensor, sigma: torch.Tensor):
    """Coefficients (A, B, C) of W = C I + A Phi + B Phi^2, with the same EPS
    switches as the reference; inputs/outputs have a trailing singleton."""
    one = torch.ones_like(sigma)
    small_theta = theta_sq < _EPS
    small_sigma = torch.abs(sigma) < _EPS
    theta = torch.sqrt(torch.where(small_theta, one, theta_sq))
    scale = torch.exp(sigma)
    sigma_safe = torch.where(small_sigma, one, sigma)
    sigma_sq = sigma_safe * sigma_safe
    th_sq_safe = torch.where(small_theta, one, theta_sq)

    A11 = torch.full_like(sigma, 0.5)
    B11 = torch.full_like(sigma, 1.0 / 6.0)
    A12 = (1.0 - torch.cos(theta)) / th_sq_safe
    B12 = (theta - torch.sin(theta)) / torch.where(small_theta, one, theta_sq * theta)
    C1 = one
    A21 = ((sigma_safe - 1.0) * scale + 1.0) / sigma_sq
    B21 = (scale * 0.5 * sigma_sq + scale - 1.0 - sigma_safe * scale) / (sigma_sq * sigma_safe)
    a = scale * torch.sin(theta)
    b = scale * torch.cos(theta)
    c = theta_sq + sigma_safe * sigma_safe
    A22 = (a * sigma_safe + (1.0 - b) * theta) / torch.where(small_theta, one, theta * c)
    C2 = (scale - 1.0) / sigma_safe
    B22 = (C2 - ((b - 1.0) * sigma_safe + a * theta) / c) / th_sq_safe

    A = torch.where(small_sigma, torch.where(small_theta, A11, A12),
                    torch.where(small_theta, A21, A22))
    B = torch.where(small_sigma, torch.where(small_theta, B11, B12),
                    torch.where(small_theta, B21, B22))
    C = torch.where(small_sigma, C1, C2)
    return A, B, C


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent 7-vector -> Sim(3) 8-vector."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]
    q = so3_exp(phi)
    s = torch.exp(sigma)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, C = _sim3_W_coeffs(theta_sq, sigma)
    phi_x_tau = _cross(phi, tau)
    phi_x_phi_x_tau = _cross(phi, phi_x_tau)
    t = C * tau + A * phi_x_tau + B * phi_x_phi_x_tau
    return torch.cat([t, q, s], dim=-1)


def sim3_log(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) 8-vector -> tangent 7-vector, with the closed-form inverse of
    W = a I + b Phi + c phi phi^T (see the reference module)."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, C = _sim3_W_coeffs(theta_sq, sigma)
    a = C - B * theta_sq
    b = A
    c = B
    denom_perp = a * a + b * b * theta_sq
    p = a / denom_perp
    qc = -b / denom_perp
    ax = a + c * theta_sq
    small = theta_sq < _EPS
    r = (1.0 / ax - p) / torch.where(small, torch.ones_like(theta_sq), theta_sq)
    r = torch.where(small, torch.zeros_like(r), r)
    phi_dot_t = torch.sum(phi * t, dim=-1, keepdim=True)
    tau = p * t + qc * _cross(phi, t) + r * phi_dot_t * phi
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_retr(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction: exp(xi) o T."""
    return sim3_mul(sim3_exp(xi), T)


def sim3_matrix(T: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix with sR in the top-left block."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    R = so3_matrix(q) * s[..., None]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(s)], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def sim3_adj_inv_T_apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = Adj(T)^{-T} X for tangent row-vectors X = [a, b, c] (7-dim):
        Y[0:3] = (1/s) R a
        Y[3:6] = (1/s) [t]x R a + R b
        Y[6]   = (1/s) t . (R a) + c
    """
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    a, b, c = X[..., 0:3], X[..., 3:6], X[..., 6:7]
    s_inv = 1.0 / s
    Ra = quat_rotate(q, a)
    y0 = s_inv * Ra
    y1 = quat_rotate(q, b) + s_inv * _cross(t, Ra)
    y2 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat(_bcat(y0, y1, y2), dim=-1)


def sim3_to_se3(T: torch.Tensor) -> torch.Tensor:
    """Drop the scale."""
    return T[..., 0:7]


def se3_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return ident.expand(tuple(batch_shape) + (7,)).clone()


def se3_mul(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    ti, qi = Ti[..., 0:3], Ti[..., 3:7]
    tj, qj = Tj[..., 0:3], Tj[..., 3:7]
    return torch.cat(_bcat(quat_rotate(qi, tj) + ti, quat_mul(qi, qj)), dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    t, q = T[..., 0:3], T[..., 3:7]
    q_inv = quat_inv(q)
    return torch.cat([-quat_rotate(q_inv, t), q_inv], dim=-1)


def se3_act(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return quat_rotate(T[..., 3:7], X) + T[..., 0:3]
