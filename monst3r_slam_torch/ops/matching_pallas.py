"""Tile matcher: kernel B (`csrc/tile_match.cu`) and its plain version.

Port of the JAX package's `ops/matching_pallas.py` with the Pallas kernel's
semantics (see the CUDA source's header). `tile_match` is the dispatch:
kernel B for CUDA tensors (or an error), the plain version for CPU tensors.
Both compute the ray dot with the same elementwise operations in the same
order, so the ray match and the convergence flag agree bit for bit. Kernel B
sums the descriptor dot on the tensor cores, in their order;
`rounding_check` states how far its descriptor match may differ from the
plain version's.

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

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {
    "tile_match_forward": (_ARGTYPES, ctypes.c_int),
    "tile_match_phase_forward": (_ARGTYPES + [ctypes.c_int], ctypes.c_int),
}
# Kernel B cut after each step: stage the crop; + ray argmax; + convergence
# test; the whole kernel.
PHASES = ("stage", "ray", "stencil", "full")


# The descriptor step's rounding allowance, in units of 2^-24 of the largest
# window sum of |q_c d_jc|: the bound on how far below the plain window
# maximum kernel B's descriptor match may score in the plain version's own
# arithmetic. A bf16 x bf16 product is exact in f32, so each score is a sum of
# fd <= 32 exact products, S_j = sum_c |q_c d_jc|. The plain version adds them
# one by one, rounding to nearest: error <= (fd - 1) 2^-24 S_j <= 31 2^-24 S.
# The tensor cores align the products of one mma (and its accumulator input)
# to the largest and may truncate each by up to one unit in the last place,
# 2^-23 S, then round the sum (NVIDIA does not document Hopper's adder; this
# is the behaviour measured on earlier tensor cores): two mma of k + 2 such
# terms at most, error <= 2 (16 + 2) 2^-23 S = 72 2^-24 S. The kernel's match
# jk beats the plain match jp in its own arithmetic, so in the plain one
# plain(jp) - plain(jk) <= 2 (31 + 72) 2^-24 S = 206 2^-24 S; 256 rounds that
# up to a power of two. The check is sound while each tensor-core sum lies
# within ROUNDING_C / 2 units of the plain one, which
# `tests/test_torch_cuda.py` measures on the card with kernel B's mma
# sequence (`test_tensor_core_descriptor_sums_stay_within_the_rounding_allowance`).
ROUNDING_C = 256
_CHECK_CHUNK = 64  # queries `rounding_check` re-scores at once


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

        # Channel by channel, in channel order. A product of two bf16 values
        # is exact in f32, so only the sums round. Kernel B sums on the
        # tensor cores in their own order; `rounding_check` bounds how far
        # its match may differ from this one.
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


def rounding_check(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
                   conv_thresh: float, got):
    """Kernel B's output `got` = (u, v, conv) against the plain version on the
    same arguments (corners already quantized). Returns (passes, exact), each
    (T, tsz) bool: `exact` where u, v and conv equal the plain version's;
    `passes` where they do, or where conv does and the descriptor match that
    differs is one the tensor cores' rounding admits:
      * it lies in the query's window (around the plain ray match, clipped
        to the crop);
      * its plain score is within delta = ROUNDING_C 2^-24 max_j sum_c
        |q_c d_jc| (j over the window) of the plain window maximum;
      * no lower-index window position holds the same descriptor vector
        (equal vectors sum equally in any order, so the lowest-index tie rule
        stays exact there)."""
    u, v, conv = got
    u0, v0, c0 = tile_match_plain(rays_img, desc_img, q_rays, q_desc, corners, crop, window,
                                  conv_thresh)
    conv_ok = conv.bool() == c0
    exact = (u == u0) & (v == v0) & conv_ok
    passes = exact.clone()
    cand = (~exact & conv_ok).nonzero()
    if len(cand) == 0:
        return passes, exact
    ru, rv, _ = tile_match_plain(rays_img, desc_img, q_rays, q_desc, corners, crop, window,
                                 conv_thresh, phase="stencil")
    h, w, fd = desc_img.shape
    m = crop * crop
    desc_flat = desc_img.reshape(h * w, fd).to(torch.bfloat16).float()
    qd_all = q_desc.to(torch.bfloat16).float()
    off = torch.arange(m, device=desc_img.device)
    ox, oy = off % crop, torch.div(off, crop, rounding_mode="floor")
    for idx in cand.split(_CHECK_CHUNK):
        t, i = idx[:, 0], idx[:, 1]
        cx, cy = corners[t, 0].long(), corners[t, 1].long()
        in_win = (((ox - (ru[t, i] - cx)[:, None]).abs() <= window)
                  & ((oy - (rv[t, i] - cy)[:, None]).abs() <= window))  # (n, m)
        dc = desc_flat[(cy[:, None] + oy) * w + (cx[:, None] + ox)]  # (n, m, fd)
        q = qd_all[t, i][:, None, :]  # (n, 1, fd)
        sd = q[..., 0] * dc[..., 0]  # the plain version's order, channel by channel
        for ch in range(1, fd):
            sd.addcmul_(q[..., ch], dc[..., ch])
        smax = sd.masked_fill(~in_win, -torch.inf).amax(-1)
        scale = (q.abs() * dc.abs()).sum(-1).masked_fill(~in_win, 0.0).amax(-1)
        ku, kv = u[t, i].long() - cx, v[t, i].long() - cy
        jk = (kv * crop + ku).clamp(0, m - 1)
        inside = (ku >= 0) & (ku < crop) & (kv >= 0) & (kv < crop)
        inside &= in_win.gather(1, jk[:, None])[:, 0]
        near = sd.gather(1, jk[:, None])[:, 0] >= smax - ROUNDING_C * 2.0**-24 * scale
        same = (dc == dc.gather(1, jk[:, None, None].expand(-1, 1, fd))).all(-1)
        dup = (same & in_win & (off < jk[:, None])).any(-1)
        passes[t, i] = inside & near & ~dup
    return passes, exact


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
    if q_desc.shape != (T, tsz, fd) or corners.shape != (T, 2):
        raise ValueError(f"unsupported shapes: desc {tuple(desc_img.shape)}, "
                         f"q_desc {tuple(q_desc.shape)}, corners {tuple(corners.shape)}")
    lib = build.load("tile_match", _SIGNATURES)
    u = torch.empty((T, tsz), dtype=torch.int32, device=rays_img.device)
    v = torch.empty_like(u)
    conv = torch.empty_like(u)
    stream = torch.cuda.current_stream(rays_img.device).cuda_stream
    with build.on_card(rays_img.get_device()):
        err = getattr(lib, entry)(
            rays_img.data_ptr(), desc_img.data_ptr(), q_rays.data_ptr(), q_desc.data_ptr(),
            corners.data_ptr(), u.data_ptr(), v.data_ptr(), conv.data_ptr(),
            T, tsz, h, w, fd, crop, window, conv_thresh, stream, *extra,
        )
    if err == 1000:
        raise ValueError(
            f"tile_match_kernel does not take fd {fd}, {tsz} queries a tile, crop {crop} on a "
            f"{h}x{w} image, or images {rays_img.data_ptr() % 16} / {desc_img.data_ptr() % 16} / "
            f"{q_desc.data_ptr() % 16} bytes past 16-byte alignment: it takes fd 16, 24 or 32, at "
            "most 256 queries, a crop and an image width that are multiples of 4 (its bulk "
            "copies move whole 16-byte crop rows), and crops that fit a block's shared memory")
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
