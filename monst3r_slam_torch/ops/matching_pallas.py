"""Tile matcher: kernel B (`csrc/tile_match.cu`) and its plain version.

Port of the JAX package's `ops/matching_pallas.py` with the Pallas kernel's
semantics (see the CUDA source's header). `tile_match` is the dispatch:
kernel B for CUDA tensors (or an error), the plain version for CPU tensors.
Both compute the ray dot and the descriptor dot with the same elementwise
operations in the same order, so on one device they agree bit for bit.

`tile_match_phase_kernel` launches kernel B cut after one of its steps
(`PHASES`), the counterpart of the TPU phase profiler
`scripts/profile_pallas_phases.py`; `tile_match_plain(..., phase=)` stops at
the same points.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from monst3r_slam_torch.ops import build

_FDS = (16, 24, 32)
_MAX_TSZ = 256
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {
    "tile_match_forward": (_ARGTYPES, ctypes.c_int),
    "tile_match_phase_forward": (_ARGTYPES + [ctypes.c_int], ctypes.c_int),
}
# Kernel B cut after each step: stage the crop; + ray argmax; + convergence
# test; the whole kernel.
PHASES = ("stage", "ray", "stencil", "full")


class PallasTileConfig(NamedTuple):
    crop: int = 64
    window: int = 15  # refine search radius (= radius * dilation_max)


def quantize_corners(corners: torch.Tensor, h: int, w: int, crop: int) -> torch.Tensor:
    """Clip crop corners (x, y) into the image, then round down to 16."""
    cx = torch.clamp(corners[:, 0], 0, w - crop) & ~15
    cy = torch.clamp(corners[:, 1], 0, h - crop) & ~15
    return torch.stack([cx, cy], dim=-1).to(torch.int32).contiguous()


def tile_match_plain(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
                     conv_thresh: float, chunk: int = 32, phase: str = "full"):
    """Plain PyTorch version; corners already quantized. Returns (u, v
    (T, tsz) int32, converged (T, tsz) bool). `phase` stops where kernel B's
    phase instantiation does: "stage" gives the corner and conv False, "ray"
    the corner plus the ray match and conv False, "stencil" that with the
    convergence test, "full" the descriptor refinement too."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    h, w, _ = rays_img.shape
    T, tsz, _ = q_rays.shape
    fd = desc_img.shape[-1]
    dev = rays_img.device
    m = crop * crop
    rays_flat = rays_img.reshape(h * w, 3).float()
    desc_flat = desc_img.reshape(h * w, fd).to(torch.bfloat16).float()
    qd_all = q_desc.to(torch.bfloat16).float()
    off = torch.arange(m, device=dev)
    ox, oy = off % crop, torch.div(off, crop, rounding_mode="floor")
    off_c = torch.arange(crop, device=dev)
    us, vs, convs = [], [], []
    for t0 in range(0, T, chunk):
        c = corners[t0 : t0 + chunk].long()
        if phase == "stage":
            tc = c.shape[0]
            us.append(c[:, 0, None].expand(tc, tsz))
            vs.append(c[:, 1, None].expand(tc, tsz))
            convs.append(torch.zeros((tc, tsz), dtype=torch.bool, device=dev))
            continue
        lin = (c[:, 1, None] + oy) * w + (c[:, 0, None] + ox)  # (tc, m)
        rc = rays_flat[lin][:, None]  # (tc, 1, m, 3)
        dc = desc_flat[lin][:, None]  # (tc, 1, m, fd)
        q = q_rays[t0 : t0 + chunk].float()[..., None, :]  # (tc, tsz, 1, 3)
        qd = qd_all[t0 : t0 + chunk][..., None, :]  # (tc, tsz, 1, fd)

        s = (q[..., 0] * rc[..., 0] + q[..., 1] * rc[..., 1]) + q[..., 2] * rc[..., 2]
        best = torch.argmax(s, dim=-1)  # (tc, tsz)
        pu, pv = best % crop, torch.div(best, crop, rounding_mode="floor")
        if phase == "ray":
            us.append(c[:, 0, None] + pu)
            vs.append(c[:, 1, None] + pv)
            convs.append(torch.zeros_like(best, dtype=torch.bool))
            continue
        s0 = s.gather(-1, best[..., None])[..., 0]

        def at(d, s=s, best=best):
            idx = best + d
            val = s.gather(-1, idx.clamp(0, m - 1)[..., None])[..., 0]
            return torch.where((idx >= 0) & (idx < m), val, torch.zeros_like(val))

        def gain(sp, sm, s0=s0):
            diff, tot = sp - sm, sp + sm
            denom = 2.0 * s0 - tot
            g = torch.where(denom > 1e-12, diff * diff / (8.0 * torch.clamp(denom, min=1e-12)),
                            torch.zeros_like(denom))
            return torch.clamp(g, min=0.0)

        peak = s0 + gain(at(1), at(-1)) + gain(at(crop), at(-crop))
        convs.append((2.0 - 2.0 * peak) < conv_thresh)
        if phase == "stencil":
            us.append(c[:, 0, None] + pu)
            vs.append(c[:, 1, None] + pv)
            continue

        # Channel by channel, as the kernel sums. A product of two bf16
        # values is exact in f32, so the fused multiply-add rounds as the
        # kernel's separate multiply and add do.
        qd_c = qd[..., 0, :].permute(2, 0, 1).contiguous()[..., None]  # (fd, tc, tsz, 1)
        dc_c = dc[:, 0].permute(2, 0, 1).contiguous()[:, :, None]  # (fd, tc, 1, m)
        sd = qd_c[0] * dc_c[0]
        for ch in range(1, fd):
            sd.addcmul_(qd_c[ch], dc_c[ch])
        # the window is separable: row test (y) x column test (x)
        in_win = (((off_c - pv[..., None]).abs() <= window)[..., :, None]
                  & ((off_c - pu[..., None]).abs() <= window)[..., None, :]).flatten(-2)
        bd = torch.argmax(sd.masked_fill(~in_win, -torch.inf), dim=-1)
        us.append(c[:, 0, None] + bd % crop)
        vs.append(c[:, 1, None] + torch.div(bd, crop, rounding_mode="floor"))
    return (torch.cat(us).to(torch.int32), torch.cat(vs).to(torch.int32), torch.cat(convs))


def _launch(entry: str, rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
            conv_thresh: float, *extra):
    """Check the arguments kernel B takes and launch its C entry `entry`."""
    h, w, _ = rays_img.shape
    T, tsz, _ = q_rays.shape
    fd = desc_img.shape[-1]
    tensors = (rays_img, desc_img, q_rays, q_desc, corners)
    if not all(t.is_cuda and t.device == rays_img.device for t in tensors):
        raise ValueError("tile_match_kernel takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tile_match_kernel takes contiguous tensors")
    if (rays_img.dtype, q_rays.dtype, corners.dtype) != (torch.float32,) * 2 + (torch.int32,):
        raise ValueError("rays must be float32 and corners int32")
    if desc_img.dtype != torch.bfloat16 or q_desc.dtype != torch.bfloat16:
        raise ValueError("descriptors must be bfloat16")
    if fd not in _FDS or q_desc.shape != (T, tsz, fd) or corners.shape != (T, 2):
        raise ValueError(f"unsupported shapes: desc {tuple(desc_img.shape)}, "
                         f"q_desc {tuple(q_desc.shape)}, corners {tuple(corners.shape)}")
    if tsz > _MAX_TSZ or not 0 < crop <= min(h, w):
        raise ValueError(f"tile of {tsz} queries or crop {crop} not supported")
    if crop * crop * (12 + 2 * fd) > _SMEM_LIMIT:
        raise ValueError(f"crop {crop} with {fd} descriptor channels exceeds shared memory")
    lib = build.load("tile_match", _SIGNATURES)
    u = torch.empty((T, tsz), dtype=torch.int32, device=rays_img.device)
    v = torch.empty_like(u)
    conv = torch.empty_like(u)
    stream = torch.cuda.current_stream(rays_img.device).cuda_stream
    err = getattr(lib, entry)(
        rays_img.data_ptr(), desc_img.data_ptr(), q_rays.data_ptr(), q_desc.data_ptr(),
        corners.data_ptr(), u.data_ptr(), v.data_ptr(), conv.data_ptr(),
        T, tsz, h, w, fd, crop, window, conv_thresh, stream, *extra,
    )
    if err != 0:
        raise RuntimeError(f"tile_match kernel launch failed: error {err}")
    return u, v, conv.bool()


def tile_match_kernel(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
                      conv_thresh: float):
    """Kernel B on CUDA tensors; corners already quantized."""
    out = _launch("tile_match_forward", rays_img, desc_img, q_rays, q_desc, corners, crop,
                  window, conv_thresh)
    tile_match_kernel.launches += 1
    return out


tile_match_kernel.launches = 0


def tile_match_phase_kernel(rays_img, desc_img, q_rays, q_desc, corners, crop: int,
                            window: int, conv_thresh: float, *, phase: str):
    """Kernel B cut after `phase` (one of `PHASES`), on CUDA tensors; corners
    already quantized. Its outputs are `tile_match_plain(..., phase=phase)`'s."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    out = _launch("tile_match_phase_forward", rays_img, desc_img, q_rays, q_desc, corners, crop,
                  window, conv_thresh, PHASES.index(phase))
    tile_match_phase_kernel.launches += 1
    return out


tile_match_phase_kernel.launches = 0


def tile_match(rays_img, desc_img, q_rays, q_desc, corners,
               tcfg: PallasTileConfig = PallasTileConfig(), conv_thresh: float = 1e-6):
    """rays_img (h, w, 3) f32 unit rays, desc_img (h, w, fd), q_rays (T, tsz, 3),
    q_desc (T, tsz, fd), corners (T, 2) int (x, y). Returns (u_abs, v_abs
    (T, tsz) int32, converged (T, tsz) bool). Descriptors are rounded to
    bf16 first, as the reference packs them."""
    h, w, _ = rays_img.shape
    corners = quantize_corners(corners, h, w, tcfg.crop)
    if rays_img.device.type == "cpu":
        return tile_match_plain(rays_img, desc_img, q_rays, q_desc, corners,
                                tcfg.crop, tcfg.window, conv_thresh)
    return tile_match_kernel(
        rays_img.float().contiguous(), desc_img.to(torch.bfloat16).contiguous(),
        q_rays.float().contiguous(), q_desc.to(torch.bfloat16).contiguous(),
        corners, tcfg.crop, tcfg.window, conv_thresh,
    )
