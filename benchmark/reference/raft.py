"""Plain reference of RAFT optical flow (Teed & Deng, ECCV 2020), as the
dynamic mask runs it: 20 refinement iterations at 1/8 resolution and the
learned convex 8x upsampling.

Written from the published architecture in plain PyTorch, independent of
the program, reading the weight tree of `harness/weights_dynamic.py`
(convolutions OIHW) in float32 with TF32 off (`model.exact_f32`). Where the
program follows the reference package's semantics rather than torch RAFT's,
so does this file, and the departures are these:

* every convolution pads as XLA's SAME rule does: with stride 2 on an even
  size the extra row and column go after (7x7 stem (2, 3), 3x3 (0, 1));
* both encoders use instance normalization with an affine (torch RAFT's
  context encoder uses batch normalization);
* the correlation lookup takes, for each pyramid level, the bilinear taps
  of a corner clipped into [0, w_l - 2] x [0, h_l - 2] with its weights
  clipped into [0, 1] (outside the volume the border is extended, where
  torch RAFT's `grid_sample` reads zeros), and on a level one cell wide or
  high the missing tap weighs nothing.

`Precision` (`model.Precision`'s rule for bf16: both operands of every
convolution and matrix product rounded to bfloat16, f32 accumulation) is
the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def identity(x):
    return x.float()


def bf16(x):
    return x.to(torch.bfloat16).float()


def _pad_same(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(p, x, P, stride: int = 1):
    kh, kw = p["w"].shape[2:]
    top, bottom = _pad_same(x.shape[2], kh, stride)
    left, right = _pad_same(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(P(x), P(p["w"]), p["b"].float(), stride=stride)


def inorm(p, x, eps: float = 1e-5):
    return F.instance_norm(x, weight=p["w"].float(), bias=p["b"].float(), eps=eps)


def residual(p, x, P, stride: int):
    y = F.relu(inorm(p["norm1"], conv(p["conv1"], x, P, stride)))
    y = F.relu(inorm(p["norm2"], conv(p["conv2"], y, P)))
    if "downsample" in p:
        x = inorm(p["norm3"], conv(p["downsample"], x, P, stride))
    return F.relu(x + y)


def encode(p, x, P):
    """(B, 3, H, W) in [-1, 1] -> (B, C, H/8, W/8)."""
    x = F.relu(inorm(p["norm1"], conv(p["conv1"], x, P, 2)))
    for blk, stride in zip(p["layers"], (1, 1, 2, 1, 2, 1)):
        x = residual(blk, x, P, stride)
    return conv(p["conv2"], x, P)


def pyramid(f1, f2, levels: int, P):
    """f1, f2 (C, h, w) -> [(h*w, h_l, w_l)]: the all-pairs correlation
    over sqrt(C) and its 2x2 average pools."""
    c, h, w = f1.shape
    vol = (P(f1.reshape(c, h * w)).T @ P(f2.reshape(c, h * w))) / math.sqrt(c)
    out = [vol.reshape(h * w, h, w)]
    for _ in range(levels - 1):
        out.append(F.avg_pool2d(out[-1][:, None], 2)[:, 0])
    return out


def lookup(pyr, flow, radius: int):
    """The (2r+1)^2 bilinear taps of each level around each pixel's target
    (pixel + flow, flow (2, h, w)) -> ((levels (2r+1)^2), h, w), per level
    row offset major."""
    _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32),
                            indexing="ij")
    tx = (xs + flow[0]).reshape(-1, 1)
    ty = (ys + flow[1]).reshape(-1, 1)
    d = torch.arange(-radius, radius + 1, device=flow.device, dtype=torch.float32)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    ox, oy = ox.reshape(1, -1), oy.reshape(1, -1)
    feats = []
    for lvl, vol in enumerate(pyr):
        n, hl, wl = vol.shape
        x = tx / 2 ** lvl + ox
        y = ty / 2 ** lvl + oy
        x0 = x.floor().clamp(0, max(wl - 2, 0))
        y0 = y.floor().clamp(0, max(hl - 2, 0))
        ax = (x - x0).clamp(0, 1)
        ay = (y - y0).clamp(0, 1)
        flat = vol.reshape(n, hl * wl)
        acc = torch.zeros_like(x)
        for dy, wy in ((0, 1 - ay), (1, ay)):
            if dy and hl < 2:
                continue
            for dx, wx in ((0, 1 - ax), (1, ax)):
                if dx and wl < 2:
                    continue
                idx = ((y0 + dy) * wl + (x0 + dx)).long()
                acc = acc + wy * wx * flat.gather(1, idx)
        feats.append(acc)
    return torch.cat(feats, 1).T.reshape(-1, h, w)


def update(p, net, inp, corr, flow, P):
    """One refinement: the motion encoder, the separable ConvGRU, the flow
    head's increment. All (1, C, h, w)."""
    e = p["encoder"]
    c = F.relu(conv(e["convc2"], F.relu(conv(e["convc1"], corr, P)), P))
    f = F.relu(conv(e["convf2"], F.relu(conv(e["convf1"], flow, P)), P))
    x = torch.cat([inp, F.relu(conv(e["conv"], torch.cat([c, f], 1), P)), flow], 1)
    g = p["gru"]
    for sfx in ("1", "2"):
        hx = torch.cat([net, x], 1)
        z = torch.sigmoid(conv(g["convz" + sfx], hx, P))
        r = torch.sigmoid(conv(g["convr" + sfx], hx, P))
        q = torch.tanh(conv(g["convq" + sfx], torch.cat([r * net, x], 1), P))
        net = (1 - z) * net + z * q
    fh = p["flow_head"]
    return net, conv(fh["conv2"], F.relu(conv(fh["conv1"], net, P)), P)


def upsample(flow, mask):
    """Convex 8x upsampling: flow (1, 2, h, w), mask (1, 576, h, w) ->
    (1, 2, 8h, 8w), each fine pixel a softmax-weighted mix of the 3x3
    coarse neighbours of 8 x flow."""
    _, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(1, 1, 9, 8, 8, h, w), dim=2)
    nb = F.unfold(8 * flow, 3, padding=1).reshape(1, 2, 9, 1, 1, h, w)
    up = (m * nb).sum(2)  # (1, 2, 8, 8, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(1, 2, 8 * h, 8 * w)


def flow(params, rc: dict, img1, img2, P=identity):
    """img1, img2 (H, W, 3) in [0, 255], H and W multiples of 8 -> the flow
    from 1 to 2, (H, W, 2), after `rc["iters"]` refinements."""
    x = torch.stack([img1, img2]).float().permute(0, 3, 1, 2) / 255.0 * 2.0 - 1.0
    fmap = encode(params["fnet"], x, P)
    ctx = encode(params["cnet"], x[:1], P)
    hd = rc["hidden_dim"]
    net, inp = torch.tanh(ctx[:, :hd]), F.relu(ctx[:, hd:])
    pyr = pyramid(fmap[0], fmap[1], rc["corr_levels"], P)
    fl = torch.zeros((1, 2) + fmap.shape[2:], device=x.device)
    for _ in range(rc["iters"]):
        corr = lookup(pyr, fl[0], rc["corr_radius"])[None]
        net, delta = update(params["update"], net, inp, corr, fl, P)
        fl = fl + delta
    mk = params["update"]["mask"]
    mask = 0.25 * conv(mk["conv2"], F.relu(conv(mk["conv1"], net, P)), P)
    return upsample(fl, mask)[0].permute(1, 2, 0)


def rel_rms(got, ref) -> float:
    """||got - ref|| / ||ref||, NaN read as an infinite error."""
    diff = (got.float() - ref.float()).nan_to_num(nan=math.inf)
    return float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref.float()))
