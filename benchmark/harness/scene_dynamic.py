"""The dynamic oracle scene: the oracle scene of `scene.py` with one rigid
moving object, rendered exactly.

The object is a sphere of radius `radius` whose centre in the world at path
index i (the index of `scene.trajectory`, so that it moves with the camera
path whatever the episode's start) is

    c(i) = (x_cam(i) + amp_x sin(freq_x i), amp_y sin(freq_y i + phase_y), z),

x_cam(i) the camera's world x at that index, and which turns about its own
z axis by `spin` radians a frame. It lies in front of the surface (z <=
2.3 < 2.4 <= the surface) and in view. Its points carry a descriptor field
and an image texture of their own, keyed by the point in the sphere's body
frame, so that a point of the object keeps its descriptor and colour as it
moves and its matches, left in, pull the pose.

Every function takes poses (..., 8) as `scene.py` does ([t, q xyzw, s]),
path indices (...) as a float tensor, and runs on the pose's device in
float32.
"""

from __future__ import annotations

import torch

from benchmark.harness import scene


def centre(obj: dict, idx: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """c(i) (..., 3) of path indices `idx` (...) with the camera poses T (..., 8) there."""
    idx = idx.float()
    return torch.stack([T[..., 0].float() + obj["amp_x"] * torch.sin(obj["freq_x"] * idx),
                        obj["amp_y"] * torch.sin(obj["freq_y"] * idx + obj["phase_y"]),
                        torch.full_like(idx, obj["z"])], dim=-1)


def spin(obj: dict, idx: torch.Tensor) -> torch.Tensor:
    """The body-to-world rotation (..., 3, 3) at path indices `idx`: about z."""
    a = obj["spin"] * idx.float()
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(a.shape + (3, 3))


def render_frame(T: torch.Tensor, idx: torch.Tensor, obj: dict, h: int, w: int, f: float):
    """(X_cam, X_world, on_object, X_body) of poses T (..., 8) at path
    indices idx (...): camera-frame and world points (..., hw, 3), the
    object's mask (..., hw) and each pixel's point in the sphere's body
    frame (..., hw, 3; meaningful on the mask only)."""
    T = T.float()
    Xc, Xw = scene.render_frame(T, h, w, f)
    tau_s = Xc[..., 2]  # the surface's depth along each ray (the ray's z is 1)
    sR = T[..., 7:8, None] * scene.quat_matrix(T[..., 3:7])
    t = T[..., 0:3]
    m = scene.pixel_rays(h, w, f, T.device) @ sR.transpose(-1, -2)  # world ray of unit depth
    c = centre(obj, idx, T)
    oc = (t - c)[..., None, :]
    a = (m * m).sum(-1)
    b = (m * oc).sum(-1)
    c0 = (oc * oc).sum(-1) - obj["radius"] ** 2
    disc = b * b - a * c0
    tau_o = (-b - torch.sqrt(disc.clamp(min=0.0))) / a
    on = (disc > 0) & (tau_o > 0) & (tau_o < tau_s)
    tau = torch.where(on, tau_o, tau_s)
    r = scene.pixel_rays(h, w, f, T.device)
    Xc = tau[..., None] * r
    Xw = t[..., None, :] + tau[..., None] * m
    Xb = (Xw - c[..., None, :]) @ spin(obj, idx)  # R^T (Xw - c), row vectors
    return Xc, Xw, on, Xb


def descriptors(rff: dict, rff_obj: dict, Xw, on, Xb) -> torch.Tensor:
    """Unit descriptors: the world field on the surface, the object's own
    field of its body point on the object."""
    return torch.where(on[..., None], scene.world_desc(rff_obj, Xb), scene.world_desc(rff, Xw))


def render_pair(Ti, Tj, idx_i, idx_j, obj: dict, rff: dict, rff_obj: dict, h: int, w: int,
                f: float):
    """The exact two-view outputs of frame pairs (X1, D1, X2, D2), view j's
    points (where they are at time j) in view i's camera frame."""
    Xi, Xwi, oni, Xbi = render_frame(Ti, idx_i, obj, h, w, f)
    Xj, Xwj, onj, Xbj = render_frame(Tj, idx_j, obj, h, w, f)
    Xj_in_i = scene.sim3_act(scene.sim3_rel(Ti.float(), Tj.float())[..., None, :], Xj)
    return (Xi, descriptors(rff, rff_obj, Xwi, oni, Xbi), Xj_in_i,
            descriptors(rff, rff_obj, Xwj, onj, Xbj))


def object_mask(T: torch.Tensor, idx: torch.Tensor, obj: dict, h: int, w: int,
                f: float) -> torch.Tensor:
    """The object's pixels of poses T (..., 8): bool (..., h, w)."""
    return render_frame(T, idx, obj, h, w, f)[2].reshape(T.shape[:-1] + (h, w))


def flow(Ti, Tj, idx_i, idx_j, obj: dict, h: int, w: int, f: float) -> torch.Tensor:
    """The exact optical flow (h, w, 2) from view i to view j of one pose
    pair: each pixel's point of view i where it is at time j (a surface
    point stays, an object point moves with the object), projected into
    view j, less the pixel. Occlusion is not modelled: a point hidden at
    time j still has its flow."""
    _, Xw, on, Xb = render_frame(Ti, idx_i, obj, h, w, f)
    moved = centre(obj, idx_j, Tj)[..., None, :] + Xb @ spin(obj, idx_j).transpose(-1, -2)
    Xw_j = torch.where(on[..., None], moved, Xw)
    Tj = Tj.float()
    sR = Tj[..., 7:8, None] * scene.quat_matrix(Tj[..., 3:7])
    Xc_j = (Xw_j - Tj[..., None, 0:3]) @ sR / (Tj[..., 7:8, None] ** 2)  # (sR)^-1 = R^T / s
    z = Xc_j[..., 2].clamp(min=1e-6)
    u = f * Xc_j[..., 0] / z + w / 2
    v = f * Xc_j[..., 1] / z + h / 2
    p = scene.pixel_rays(h, w, f, Ti.device)
    u0, v0 = p[:, 0] * f + w / 2, p[:, 1] * f + h / 2
    return torch.stack([u - u0, v - v0], dim=-1).reshape(h, w, 2)


def render_image(T: torch.Tensor, idx: torch.Tensor, obj: dict, h: int, w: int,
                 f: float) -> torch.Tensor:
    """Normalized (B, h, w, 3) images in [-1, 1]: the oracle scene's texture
    on the surface, a texture of the body point on the object."""
    _, Xw, on, Xb = render_frame(T, idx, obj, h, w, f)
    surf = torch.stack([torch.sin(2.1 * Xw[..., 0]) * torch.cos(1.3 * Xw[..., 1]),
                        torch.sin(1.7 * Xw[..., 1] + 0.5),
                        torch.cos(2.9 * Xw[..., 0] + 1.1 * Xw[..., 2])], dim=-1)
    body = torch.stack([0.6 + 0.4 * torch.sin(9.0 * Xb[..., 0]) * torch.sin(9.0 * Xb[..., 1]),
                        -0.5 + 0.4 * torch.cos(7.0 * Xb[..., 2] + 3.0 * Xb[..., 0]),
                        0.3 * torch.sin(11.0 * Xb[..., 1] + 1.0)], dim=-1)
    return torch.where(on[..., None], body, surf).reshape(-1, h, w, 3)


def render_images(poses: torch.Tensor, idx: torch.Tensor, obj: dict, h: int, w: int, f: float,
                  chunk: int = 16):
    """(uint8 (n, h, w, 3) on the host, normalized (n, h, w, 3) on the
    device) for poses (n, 8) at path indices idx (n,), as
    `scene.render_images`."""
    u8 = torch.cat([torch.round((render_image(p, i, obj, h, w, f) + 1.0) * 127.5).clamp(0, 255)
                    .to(torch.uint8) for p, i in zip(poses.split(chunk), idx.split(chunk))])
    return u8.cpu().numpy(), u8.float() / 127.5 - 1.0


def intrinsics(h: int, w: int, f: float, device) -> torch.Tensor:
    """The pinhole K of the rendered frames: focal f, principal point (w/2, h/2)."""
    return torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)
