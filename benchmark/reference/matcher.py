"""Plain reference of kernel B, the tile matcher, and the gap that judges it.

The semantics are those of the reference's Pallas tile matcher: each tile
of queries searches one crop of the target image, placed at the tile's
corner (clipped into the image, rounded down to 16). A query's ray match
is the crop position whose unit ray has the largest dot with the query's
ray, summed as (q0 r0 + q1 r1) + q2 r2 in f32; it converged when the
parabolic peak through its 4-neighbourhood lies within the threshold of 1.
Its final match is the position of largest descriptor dot within +-window
of the ray match (clipped to the crop), descriptors rounded to bf16 and
summed channel by channel in f32, the lowest index winning a tie.

`match_gap` judges a matcher's (u, v, converged): for each query, how far
the descriptor score of its pick lies below the window's best, in units of
2^-24 of the window's largest sum of |q_c d_c| (the scale of one rounding
of that sum). A query whose flag differs, or whose pick lies outside the
reference's window, reads 2^24: a whole scale.
"""

from __future__ import annotations

import torch

WHOLE = float(2**24)


def quantize_corners(corners, h: int, w: int, crop: int):
    cx = torch.clamp(corners[:, 0].long(), 0, w - crop) & ~15
    cy = torch.clamp(corners[:, 1].long(), 0, h - crop) & ~15
    return torch.stack([cx, cy], dim=-1)


def _cast(x, kind: str):
    """Rounding of an operand: f32 as given, bf16, or float8 e4m3 with one
    scale over the tensor."""
    x = x.float()
    if kind == "f32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    scale = (x.abs().amax() / 448.0).clamp(min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _chunk_scores(rays, desc, q_rays, q_desc, c, crop: int, w: int):
    off = torch.arange(crop * crop, device=rays.device)
    lin = (c[:, 1, None] + off // crop) * w + (c[:, 0, None] + off % crop)  # (t, m)
    rc = rays[lin][:, None]  # (t, 1, m, 3)
    q = q_rays[..., None, :]  # (t, s, 1, 3)
    s = (q[..., 0] * rc[..., 0] + q[..., 1] * rc[..., 1]) + q[..., 2] * rc[..., 2]
    dc = desc[lin]  # (t, m, fd)
    sd = q_desc[..., 0, None] * dc[:, None, :, 0]
    sa = (q_desc[..., 0, None] * dc[:, None, :, 0]).abs()
    for ch in range(1, desc.shape[-1]):
        sd = sd + q_desc[..., ch, None] * dc[:, None, :, ch]
        sa = sa + (q_desc[..., ch, None] * dc[:, None, :, ch]).abs()
    return s, sd, sa


def _ray_stage(s, crop: int, conv_thresh: float):
    m = crop * crop
    best = torch.argmax(s, dim=-1)
    s0 = s.gather(-1, best[..., None])[..., 0]

    def at(d):
        idx = best + d
        val = s.gather(-1, idx.clamp(0, m - 1)[..., None])[..., 0]
        return torch.where((idx >= 0) & (idx < m), val, torch.zeros_like(val))

    def gain(sp, sm):
        diff, tot = sp - sm, sp + sm
        den = 2.0 * s0 - tot
        g = torch.where(den > 1e-12, diff * diff / (8.0 * den.clamp(min=1e-12)),
                        torch.zeros_like(den))
        return g.clamp(min=0.0)

    peak = s0 + gain(at(1), at(-1)) + gain(at(crop), at(-crop))
    return best % crop, best // crop, (2.0 - 2.0 * peak) < conv_thresh


def _window(pu, pv, crop: int, window: int):
    off = torch.arange(crop, device=pu.device)
    return (((off - pv[..., None]).abs() <= window)[..., :, None]
            & ((off - pu[..., None]).abs() <= window)[..., None, :]).flatten(-2)


def tile_match(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
               conv_thresh: float, rays: str = "f32", desc: str = "bf16", chunk: int = 16):
    """(u, v, converged), each (T, tsz), computed with the rays and the
    descriptors rounded as `rays` and `desc` say ("f32", "bf16", "fp8")."""
    h, w, _ = rays_img.shape
    c_all = quantize_corners(corners, h, w, crop)
    r = _cast(rays_img, rays).reshape(h * w, 3)
    d = _cast(desc_img, desc).reshape(h * w, -1)
    qr, qd = _cast(q_rays, rays), _cast(q_desc, desc)
    us, vs, cs = [], [], []
    for t0 in range(0, c_all.shape[0], chunk):
        c = c_all[t0:t0 + chunk]
        s, sd, _ = _chunk_scores(r, d, qr[t0:t0 + chunk], qd[t0:t0 + chunk], c, crop, w)
        pu, pv, conv = _ray_stage(s, crop, conv_thresh)
        bd = torch.argmax(sd.masked_fill(~_window(pu, pv, crop, window), -torch.inf), dim=-1)
        us.append(c[:, 0, None] + bd % crop)
        vs.append(c[:, 1, None] + bd // crop)
        cs.append(conv)
    return torch.cat(us), torch.cat(vs), torch.cat(cs)


def match_gap(rays_img, desc_img, q_rays, q_desc, corners, crop: int, window: int,
              conv_thresh: float, got, chunk: int = 16) -> float:
    """The widest gap, over every query, of the matcher's answer `got` =
    (u, v, converged) below the reference's window maximum (module
    docstring)."""
    h, w, _ = rays_img.shape
    c_all = quantize_corners(corners, h, w, crop)
    r = rays_img.float().reshape(h * w, 3)
    d = desc_img.to(torch.bfloat16).float().reshape(h * w, -1)
    qr, qd = q_rays.float(), q_desc.to(torch.bfloat16).float()
    gu, gv, gc = (t.long() if t.dtype != torch.bool else t for t in got)
    worst = 0.0
    for t0 in range(0, c_all.shape[0], chunk):
        c = c_all[t0:t0 + chunk]
        s, sd, sa = _chunk_scores(r, d, qr[t0:t0 + chunk], qd[t0:t0 + chunk], c, crop, w)
        pu, pv, conv = _ray_stage(s, crop, conv_thresh)
        win = _window(pu, pv, crop, window)
        smax = sd.masked_fill(~win, -torch.inf).amax(-1)
        scale = sa.masked_fill(~win, 0.0).amax(-1).clamp(min=1e-30)
        ku = gu[t0:t0 + chunk] - c[:, 0, None]
        kv = gv[t0:t0 + chunk] - c[:, 1, None]
        inside = (ku >= 0) & (ku < crop) & (kv >= 0) & (kv < crop)
        jk = (kv * crop + ku).clamp(0, crop * crop - 1)
        inside &= win.gather(-1, jk[..., None])[..., 0]
        gap = (smax - sd.gather(-1, jk[..., None])[..., 0]) / (scale * 2.0**-24)
        ok = inside & (gc[t0:t0 + chunk].bool() == conv)
        gap = torch.where(ok, gap.clamp(min=0.0), torch.full_like(gap, WHOLE))
        worst = max(worst, float(gap.nan_to_num(nan=WHOLE).max()))
    return worst


def window_positions(rays_img, q_rays, corners, crop: int, window: int, chunk: int = 16) -> int:
    """Descriptor positions kernel B scores for these inputs: the +-window
    box around each query's ray match, clipped to its crop."""
    h, w, _ = rays_img.shape
    c_all = quantize_corners(corners, h, w, crop)
    r = rays_img.float().reshape(h * w, 3)
    off = torch.arange(crop * crop, device=r.device)
    total = 0
    for t0 in range(0, c_all.shape[0], chunk):
        c = c_all[t0:t0 + chunk]
        lin = (c[:, 1, None] + off // crop) * w + (c[:, 0, None] + off % crop)
        best = torch.argmax(q_rays[t0:t0 + chunk].float() @ r[lin].transpose(1, 2), dim=-1)
        pu, pv = best % crop, best // crop
        su = (pu + window).clamp(max=crop - 1) - (pu - window).clamp(min=0) + 1
        sv = (pv + window).clamp(max=crop - 1) - (pv - window).clamp(min=0) + 1
        total += int((su * sv).sum())
    return total
