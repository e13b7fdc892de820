"""Tile matcher: kernel B (`csrc/tile_match.cu`) and its plain version.

Port of the JAX package's `ops/matching_pallas.py` with the Pallas kernel's
semantics (see the CUDA source's header). `tile_match` is the dispatch:
kernel B for CUDA tensors (or an error), the plain version for CPU tensors.
Both compute the ray dot with the same elementwise operations in the same
order, so the ray match and the convergence flag agree bit for bit. Kernel B
sums the descriptor dot on the tensor cores, in their order;
`rounding_check` states how far its descriptor match may differ from the
plain version's.

Kernel B has two variants, chosen by shape in its C entry: the whole-crop
kernel where a crop's slots fit shared memory whole (the main path's crop
48, fd 24, 256 queries a tile), and the banded variant for every other crop,
tile size and descriptor width the reference takes (`variant` says which
runs a shape; each launch is counted per variant). Descriptors of any width
up to 119, the reference's limit, are zero-padded to the next instantiated
width (`DESC_DIMS`). The kernel addresses the images' rows by a pitch of
its own, so an image of any width and start is taken: one whose width is no
multiple of 4, or whose start is not 16-byte aligned, is first copied into
a zero-padded pitched buffer (`pad_pitch`).

`tile_match_phase_kernel` launches kernel B cut after one of its steps
(`PHASES`), the counterpart of the TPU phase profiler
`scripts/profile_pallas_phases.py`; `tile_match_plain(..., phase=)` stops at
the same points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from monst3r_slam_torch.ops import build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {
    "tile_match_forward": (_ARGTYPES, ctypes.c_int),
    "tile_match_phase_forward": (_ARGTYPES + [ctypes.c_int], ctypes.c_int),
    "tile_match_variant": ([ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int),
}
# Kernel B cut after each step: stage the crop; + ray argmax; + convergence
# test; the whole kernel.
PHASES = ("stage", "ray", "stencil", "full")
_CHECK_CHUNK = 64  # queries `rounding_check` re-scores at once
# Descriptor widths kernel B is instantiated at; any other width up to
# MAX_FD is zero-padded to the next of them (`pad_descriptors`).
DESC_DIMS = (16, 24, 32, 48, 64, 96, 128)
MAX_FD = 119  # the reference's own limit: fd + 9 <= 128 channels in its packed image


# The descriptor step's rounding allowance, in units of 2^-24 of the largest
# window sum of |q_c d_jc|: the bound on how far below the plain window
# maximum kernel B's descriptor match may score in the plain version's own
# arithmetic, for descriptors kernel B runs at width W (an instantiation,
# `DESC_DIMS`). A bf16 x bf16 product is exact in f32, so each score is a
# sum of at most W exact products, S_j = sum_c |q_c d_jc|. The plain version
# adds them one by one, rounding to nearest: error <= (W - 1) 2^-24 S_j <=
# (W - 1) 2^-24 S. The tensor cores align the products of one mma (and its
# accumulator input) to the largest and may truncate each by up to one unit
# in the last place, 2^-23 S, then round the sum (NVIDIA does not document
# Hopper's adder; this is the behaviour measured on earlier tensor cores):
# n = ceil(W / 16) mma of k + 2 <= 18 such terms, error <= 18 n 2^-23 S =
# 36 n 2^-24 S. The kernel's match jk beats the plain match jp in its own
# arithmetic, so in the plain one plain(jp) - plain(jk) <= 2 ((W - 1) +
# 36 n) 2^-24 S: 206 at W = 32, 414 at 64, 830 at 128, rounded up to a
# power of two and never below 256 (the widths up to 32 share 256). The
# check is sound while each tensor-core sum lies within half the allowance
# of the plain one, which `tests/test_torch_cuda.py` measures on the card
# with kernel B's mma sequence at fd 24, 64 and 128
# (`test_tensor_core_descriptor_sums_stay_within_the_rounding_allowance`).
def rounding_allowance(fd: int) -> int:
    """The rounding allowance (units of 2^-24 S) for descriptors of width
    `fd`, which kernel B runs at the narrowest instantiation that holds it."""
    width = next((n for n in DESC_DIMS if fd <= n), fd)
    bound = 2 * ((width - 1) + 36 * -(-width // 16))
    return max(256, 1 << (bound - 1).bit_length())


def padded_fd(fd: int) -> int:
    """The instantiation kernel B runs descriptors of width `fd` at: the
    narrowest of `DESC_DIMS` that holds it. Raises above `MAX_FD`."""
    if 1 <= fd <= MAX_FD:
        return next(n for n in DESC_DIMS if fd <= n)
    raise ValueError(f"tile_match takes descriptor widths from 1 to {MAX_FD} (the reference's "
                     f"fd + 9 <= 128), got {fd}")


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
      * its plain score is within delta = rounding_allowance(fd) 2^-24
        max_j sum_c |q_c d_jc| (j over the window) of the plain window
        maximum;
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
    allowance = rounding_allowance(fd)
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
        near = sd.gather(1, jk[:, None])[:, 0] >= smax - allowance * 2.0**-24 * scale
        same = (dc == dc.gather(1, jk[:, None, None].expand(-1, 1, fd))).all(-1)
        dup = (same & in_win & (off < jk[:, None])).any(-1)
        passes[t, i] = inside & near & ~dup
    return passes, exact


def pad_descriptors(desc_img, q_desc):
    """(desc_img, q_desc) zero-padded along their last dimension to
    `padded_fd` (the inputs themselves at an instantiated width). Exact: a
    zero channel adds an exact zero to every descriptor score, in the plain
    version's sums and on the tensor cores alike, so matches and
    `rounding_check` do not move. Raises above `MAX_FD`."""
    fd = desc_img.shape[-1]
    width = padded_fd(fd)
    if width == fd:
        return desc_img, q_desc
    return (torch.nn.functional.pad(desc_img, (0, width - fd)),
            torch.nn.functional.pad(q_desc, (0, width - fd)))


def pad_pitch(rays_img, desc_img) -> tuple:
    """(rays_img, desc_img, pitch) as kernel B reads them: its bulk copies
    read 16-byte rows, so each image must start 16-byte aligned and its rows
    lie a multiple of 4 pixels apart. The inputs themselves (pitch w) where
    they do; else an image that is not aligned is copied, and where w is no
    multiple of 4 both are copied into zero-padded (h, pitch, c) buffers,
    pitch w rounded up to 4. Exact: the columns past w lie outside every
    crop, whose corners are clipped to w - crop."""
    h, w, _ = rays_img.shape
    pitch = -(-w // 4) * 4
    if pitch == w:
        return (*(t if t.data_ptr() % 16 == 0 else t.clone() for t in (rays_img, desc_img)), w)

    def pitched(t):
        out = t.new_zeros((h, pitch, t.shape[-1]))
        out[:, :w] = t
        return out

    return pitched(rays_img), pitched(desc_img), pitch


@functools.lru_cache(maxsize=256)
def variant(T: int, tsz: int, h: int, w: int, fd: int, crop: int) -> tuple:
    """(which kernel takes these arguments, its rows per ray band and per
    descriptor band): ("whole", 0, 0) for the whole-crop kernel, ("banded",
    rr, rd) for the banded variant, (None, 0, 0) for neither. `fd` is the
    padded width. Asks the kernel library's C entry, which `dispatch`
    follows."""
    bands = (ctypes.c_int * 2)()
    which = build.load("tile_match", _SIGNATURES).tile_match_variant(T, tsz, h, w, fd, crop, bands)
    return ({0: "whole", 1: "banded"}.get(which), bands[0], bands[1])


def _launch(entry: str, rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
            conv_thresh: float, *extra):
    """Check the arguments kernel B takes, zero-pad descriptors to an
    instantiated width and the images to a pitch it reads (`pad_pitch`),
    and launch its C entry `entry`. Returns ((u, v, conv), the variant that
    ran: "whole" or "banded", whether `pad_pitch` copied an image)."""
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
    desc_img, q_desc = pad_descriptors(desc_img, q_desc)
    width = desc_img.shape[-1]
    images = rays_img.data_ptr(), desc_img.data_ptr()
    rays_img, desc_img, pitch = pad_pitch(rays_img, desc_img)
    copied = (rays_img.data_ptr(), desc_img.data_ptr()) != images
    if q_desc.data_ptr() % 16:
        q_desc = q_desc.clone()
    which = variant(T, tsz, h, w, width, crop)[0]
    lib = build.load("tile_match", _SIGNATURES)
    u = torch.empty((T, tsz), dtype=torch.int32, device=rays_img.device)
    v = torch.empty_like(u)
    conv = torch.empty_like(u)
    stream = torch.cuda.current_stream(rays_img.device).cuda_stream
    with build.on_card(rays_img.get_device()):
        err = getattr(lib, entry)(
            rays_img.data_ptr(), desc_img.data_ptr(), q_rays.data_ptr(), q_desc.data_ptr(),
            corners.data_ptr(), u.data_ptr(), v.data_ptr(), conv.data_ptr(),
            T, tsz, h, w, pitch, width, crop, window, conv_thresh, stream, *extra,
        )
    if err == 1000:
        raise ValueError(
            f"tile_match_kernel does not take crop {crop} on a {h}x{w} image at fd {fd}: it "
            "takes any crop up to min(h, w) of which one row of rays and of descriptors, "
            "twice, fits a block's shared memory, and any number of queries")
    if err != 0:
        raise RuntimeError(f"tile_match kernel launch failed: error {err}")
    return (u, v, conv.bool()), which, copied


def tile_match_kernel(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
                      conv_thresh: float):
    """Kernel B on CUDA tensors; corners already quantized. Counts its
    launches, per variant in `variant_launches`, and in `pitched_launches`
    those whose images `pad_pitch` copied."""
    out, which, copied = _launch("tile_match_forward", rays_img, desc_img, q_rays, q_desc,
                                 corners, crop, window, conv_thresh)
    tile_match_kernel.launches += 1
    tile_match_kernel.variant_launches[which] += 1
    tile_match_kernel.pitched_launches += copied
    return out


tile_match_kernel.launches = 0
tile_match_kernel.variant_launches = {"whole": 0, "banded": 0}
tile_match_kernel.pitched_launches = 0


def tile_match_phase_kernel(rays_img, desc_img, q_rays, q_desc, corners, crop: int,
                            window: int, conv_thresh: float, *, phase: str):
    """Kernel B cut after `phase` (one of `PHASES`), on CUDA tensors; corners
    already quantized. Its outputs are `tile_match_plain(..., phase=phase)`'s."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    out, which, _ = _launch("tile_match_phase_forward", rays_img, desc_img, q_rays, q_desc,
                            corners, crop, window, conv_thresh, PHASES.index(phase))
    tile_match_phase_kernel.launches += 1
    tile_match_phase_kernel.variant_launches[which] += 1
    return out


tile_match_phase_kernel.launches = 0
tile_match_phase_kernel.variant_launches = {"whole": 0, "banded": 0}


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
