"""RAFT optical flow (Teed & Deng, ECCV 2020) for the dynamic mask.

Port of the JAX package's `dynamic/raft.py`, the same architecture and
parameter tree with convolutions in NCHW and weights OIHW:

  * feature/context encoders: conv7x7/s2 + 6 residual blocks (1/8 res, 256ch)
  * all-pairs 4-level correlation pyramid with radius-4 bilinear lookup
  * SepConvGRU update block with motion encoder + flow head
  * convex 8x upsampling of the final flow

Every convolution pads as XLA's SAME does (`_same_pad`): with stride 2 on an
even size the extra row and column go after, not before, so the 7x7 stem
pads (2, 3) and the stride-2 3x3 convolutions (0, 1). This follows the
reference's semantics, not torch RAFT's symmetric padding. f32 throughout,
the reference's default; the correlation volume is one matrix product. The
lookup gathers its four taps, weighted as the reference's default one-hot
matmul form weighs them: that form and the reference's own gather form
agree within 1e-5 except on a pyramid level one cell wide or high, where
the matmul form drops the missing tap (`_bilinear_lookup`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class RAFTConfig(NamedTuple):
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20


# ---------------------------------------------------------------------------
# Primitives (NCHW)
# ---------------------------------------------------------------------------


def _same_pad(n: int, k: int, s: int):
    """(before, after) padding of XLA's SAME rule for one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(p, x: torch.Tensor, stride: int = 1, padding="SAME") -> torch.Tensor:
    """A convolution padded as XLA pads: "SAME", "VALID" or
    ((top, bottom), (left, right))."""
    kh, kw = p["w"].shape[2:]
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pad(x.shape[2], kh, stride),
                                        _same_pad(x.shape[3], kw, stride))
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        (top, bottom), (left, right) = padding
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    b = p.get("b")
    return F.conv2d(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype), stride)


def instance_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if "w" in p:
        y = y * p["w"][:, None, None] + p["b"][:, None, None]
    return y.to(x.dtype)


def res_block(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    y = F.relu(instance_norm(p["norm1"], conv(p["conv1"], x, stride)))
    y = F.relu(instance_norm(p["norm2"], conv(p["conv2"], y)))
    if "downsample" in p:
        x = instance_norm(p["norm3"], conv(p["downsample"], x, stride))
    return F.relu(x + y)


def encoder(p, x: torch.Tensor) -> torch.Tensor:
    """BasicEncoder: (B, 3, H, W) -> (B, C, H/8, W/8)."""
    x = F.relu(instance_norm(p["norm1"], conv(p["conv1"], x, stride=2)))
    for i, blk in enumerate(p["layers"]):
        x = res_block(blk, x, 2 if i in (2, 4) else 1)
    return conv(p["conv2"], x)


# ---------------------------------------------------------------------------
# Correlation pyramid
# ---------------------------------------------------------------------------


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int):
    """f1/f2: (H, W, C) 1/8-res features -> list of (H*W, hl, wl) volumes."""
    h, w, c = f1.shape
    corr = (f1.reshape(h * w, c) @ f2.reshape(h * w, c).T) / math.sqrt(c)
    pyr = [corr.reshape(h * w, h, w)]
    for _ in range(levels - 1):
        hh, ww = pyr[-1].shape[1] // 2, pyr[-1].shape[2] // 2
        pooled = pyr[-1][:, : 2 * hh, : 2 * ww].reshape(h * w, hh, 2, ww, 2).mean((2, 4))
        pyr.append(pooled)
    return pyr


def _bilinear_lookup(vol: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """vol: (N, hl, wl); u, v: (N, K) float coords -> (N, K). The taps'
    corner is clipped to [0, wl-2] x [0, hl-2] and the weights to [0, 1]:
    outside the volume the border taps are extrapolated by clipping, which is
    not `grid_sample`'s zero padding. On a level one cell wide (or high) the
    second column (row) does not exist and its tap weighs nothing, as in the
    reference's one-hot matmul form (its gather form repeats the first)."""
    n, hl, wl = vol.shape
    flat = vol.reshape(n, hl * wl)
    u0 = torch.clamp(torch.floor(u), 0, max(wl - 2, 0))
    v0 = torch.clamp(torch.floor(v), 0, max(hl - 2, 0))
    du = torch.clamp(u - u0, 0.0, 1.0)
    dv = torch.clamp(v - v0, 0.0, 1.0)
    base = (u0 + wl * v0).long()

    def tap(offset):
        return torch.gather(flat, 1, torch.clamp(base + offset, 0, hl * wl - 1))

    out = tap(0) * (1 - du) * (1 - dv)
    if wl > 1:
        out = out + tap(1) * du * (1 - dv)
    if hl > 1:
        out = out + tap(wl) * (1 - du) * dv
    if wl > 1 and hl > 1:
        out = out + tap(wl + 1) * du * dv
    return out


def corr_lookup(pyr, flow: torch.Tensor, radius: int) -> torch.Tensor:
    """flow: (H, W, 2) current 1/8-res flow -> (H, W, levels*(2r+1)^2), per
    level the taps row offset major, column offset minor."""
    h, w = flow.shape[:2]
    n = h * w
    dev = flow.device
    gx = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    gy = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    cx = gx + flow.reshape(n, 2)[:, 0]
    cy = gy + flow.reshape(n, 2)[:, 1]
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    du = d.repeat(2 * radius + 1)
    dv = d.repeat_interleave(2 * radius + 1)
    out = []
    for lvl, vol in enumerate(pyr):
        scale = 2.0**lvl
        out.append(_bilinear_lookup(vol, cx[:, None] / scale + du[None, :],
                                    cy[:, None] / scale + dv[None, :]))
    return torch.cat(out, dim=-1).reshape(h, w, -1)


# ---------------------------------------------------------------------------
# Update block (NCHW)
# ---------------------------------------------------------------------------


def motion_encoder(p, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    c = F.relu(conv(p["convc1"], corr))
    c = F.relu(conv(p["convc2"], c))
    f = F.relu(conv(p["convf1"], flow))
    f = F.relu(conv(p["convf2"], f))
    m = F.relu(conv(p["conv"], torch.cat([c, f], dim=1)))
    return torch.cat([m, flow], dim=1)


def sep_conv_gru(p, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv(p["convz1"], hx))
    r = torch.sigmoid(conv(p["convr1"], hx))
    q = torch.tanh(conv(p["convq1"], torch.cat([r * h, x], dim=1)))
    h = (1 - z) * h + z * q
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv(p["convz2"], hx))
    r = torch.sigmoid(conv(p["convr2"], hx))
    q = torch.tanh(conv(p["convq2"], torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


def flow_head(p, h: torch.Tensor) -> torch.Tensor:
    return conv(p["conv2"], F.relu(conv(p["conv1"], h)))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Convex combination 8x upsampling (RAFT's learned upsampler): flow
    (h, w, 2), mask (h, w, 9*factor^2) -> (h*factor, w*factor, 2)."""
    h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(h, w, 9, factor, factor), dim=2)
    fp = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fp[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
                        dim=2)  # (h, w, 9, 2)
    up = torch.sum(mask[..., None] * neigh[:, :, :, None, None, :], dim=2)
    return up.permute(0, 2, 1, 3, 4).reshape(h * factor, w * factor, 2)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1)[None]


def _hwc(x: torch.Tensor) -> torch.Tensor:
    return x[0].permute(1, 2, 0)


@torch.no_grad()
def raft_flow(params, img1: torch.Tensor, img2: torch.Tensor,
              cfg: RAFTConfig = RAFTConfig()) -> torch.Tensor:
    """img1/img2: (H, W, 3) float in [0, 255] -> flow (H, W, 2) at full res.
    H and W must be multiples of 8."""
    x = (torch.stack([img1, img2]).float() / 255.0) * 2.0 - 1.0
    x = x.permute(0, 3, 1, 2)
    fmap = encoder(params["fnet"], x)  # both images in one batch
    ctx = encoder(params["cnet"], x[:1])
    net = torch.tanh(ctx[:, : cfg.hidden_dim])
    inp = F.relu(ctx[:, cfg.hidden_dim :])

    pyr = corr_pyramid(_hwc(fmap[:1]), _hwc(fmap[1:]), cfg.corr_levels)
    h, w = fmap.shape[2:]
    flow = torch.zeros((h, w, 2), device=x.device)
    up = params["update"]
    for _ in range(cfg.iters):
        corr = corr_lookup(pyr, flow, cfg.corr_radius)
        motion = motion_encoder(up["encoder"], _nchw(flow), _nchw(corr))
        net = sep_conv_gru(up["gru"], net, torch.cat([inp, motion], dim=1))
        flow = flow + _hwc(flow_head(up["flow_head"], net))
    mask = conv(up["mask"]["conv2"], F.relu(conv(up["mask"]["conv1"], net)))
    return convex_upsample(flow, _hwc(mask) * 0.25)


# ---------------------------------------------------------------------------
# Weights: random init, a torch RAFT state dict, the reference's tree
# ---------------------------------------------------------------------------

_ENC_DIMS = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1), (96, 128, 2), (128, 128, 1))
_TORCH_LAYERS = ((1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1))
_ENCODER_CONVS = ("convc1", "convc2", "convf1", "convf2", "conv")
_GRU_CONVS = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")


def init_raft_params(gen: torch.Generator, cfg: RAFTConfig = RAFTConfig(), device=None):
    """Random RAFT weights from `gen` (He-normal convolutions, zero biases,
    unit instance-norm affines), float32 on `device` (default: the
    generator's). The reference's tree and shapes; other numbers."""
    dev = gen.device if device is None else torch.device(device)

    def conv_p(kh, kw, ci, co):
        w = torch.randn((co, ci, kh, kw), generator=gen, device=gen.device).to(dev)
        return {"w": math.sqrt(2.0 / (kh * kw * ci)) * w, "b": torch.zeros(co, device=dev)}

    def in_p(c):
        return {"w": torch.ones(c, device=dev), "b": torch.zeros(c, device=dev)}

    def enc(out_dim):
        layers = []
        for ci, co, s in _ENC_DIMS:
            blk = {"conv1": conv_p(3, 3, ci, co), "norm1": in_p(co),
                   "conv2": conv_p(3, 3, co, co), "norm2": in_p(co)}
            if s > 1 or ci != co:
                blk["downsample"] = conv_p(1, 1, ci, co)
                blk["norm3"] = in_p(co)
            layers.append(blk)
        return {"conv1": conv_p(7, 7, 3, 64), "norm1": in_p(64), "layers": layers,
                "conv2": conv_p(1, 1, 128, out_dim)}

    cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    hd = cfg.hidden_dim
    gru_in = hd + 128 + cfg.context_dim
    return {
        "fnet": enc(256),
        "cnet": enc(cfg.hidden_dim + cfg.context_dim),
        "update": {
            "encoder": {
                "convc1": conv_p(1, 1, cor_planes, 256), "convc2": conv_p(3, 3, 256, 192),
                "convf1": conv_p(7, 7, 2, 128), "convf2": conv_p(3, 3, 128, 64),
                "conv": conv_p(3, 3, 256, 128 - 2),
            },
            "gru": {k: conv_p(1, 5, gru_in, hd) if k.endswith("1") else conv_p(5, 1, gru_in, hd)
                    for k in _GRU_CONVS},
            "flow_head": {"conv1": conv_p(3, 3, hd, 256), "conv2": conv_p(3, 3, 256, 2)},
            "mask": {"conv1": conv_p(3, 3, hd, 256), "conv2": conv_p(1, 1, 256, 64 * 9)},
        },
    }


def raft_params_from_numpy(tree, device="cpu"):
    """The reference's RAFT tree (numpy leaves, convolutions HWIO) -> the
    port's (OIHW) on `device`."""
    if isinstance(tree, dict):
        return {k: raft_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [raft_params_from_numpy(v, device) for v in tree]
    x = np.array(tree, dtype=np.float32)
    if x.ndim == 4:
        x = x.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def raft_params_from_torch(path: str, device="cpu"):
    """A standard torch RAFT checkpoint (fnet/cnet/update_block.*, with or
    without a `module.` prefix) -> the port's tree, mapped as the reference
    maps it: every `norm*` with a weight becomes an affine instance norm,
    so the batch-norm statistics of a checkpoint's context net are dropped.
    The file is unpickled in full: load only trusted checkpoints."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in sd:
        sd = sd["model"]
    sd = {k.replace("module.", ""): v.float().to(device) for k, v in sd.items()}

    def cw(name):
        p = {"w": sd[f"{name}.weight"].contiguous()}
        if f"{name}.bias" in sd:
            p["b"] = sd[f"{name}.bias"]
        return p

    def iw(name):
        if f"{name}.weight" in sd:
            return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}
        return {}

    def enc(pfx):
        layers = []
        for li, bi in _TORCH_LAYERS:
            name = f"{pfx}.layer{li}.{bi}"
            blk = {"conv1": cw(f"{name}.conv1"), "norm1": iw(f"{name}.norm1"),
                   "conv2": cw(f"{name}.conv2"), "norm2": iw(f"{name}.norm2")}
            if f"{name}.downsample.0.weight" in sd:
                blk["downsample"] = cw(f"{name}.downsample.0")
                blk["norm3"] = iw(f"{name}.downsample.1")
            layers.append(blk)
        return {"conv1": cw(f"{pfx}.conv1"), "norm1": iw(f"{pfx}.norm1"), "layers": layers,
                "conv2": cw(f"{pfx}.conv2")}

    return {
        "fnet": enc("fnet"),
        "cnet": enc("cnet"),
        "update": {
            "encoder": {k: cw(f"update_block.encoder.{k}") for k in _ENCODER_CONVS},
            "gru": {k: cw(f"update_block.gru.{k}") for k in _GRU_CONVS},
            "flow_head": {"conv1": cw("update_block.flow_head.conv1"),
                          "conv2": cw("update_block.flow_head.conv2")},
            "mask": {"conv1": cw("update_block.mask.0"), "conv2": cw("update_block.mask.2")},
        },
    }


def _device_of(params) -> torch.device:
    return params["fnet"]["conv1"]["w"].device


# ---------------------------------------------------------------------------
# Adapters for dynamic.mask
# ---------------------------------------------------------------------------


def make_raft_flow_estimator(params, cfg: RAFTConfig = RAFTConfig()):
    """Adapter for dynamic.mask.set_flow_estimator: (h, w, 3) uint8 images
    -> (h, w, 2) float32 numpy flow, computed on the weights' device."""
    dev = _device_of(params)

    def estimator(img_i_u8, img_j_u8):
        a, b = (torch.tensor(np.asarray(x, np.uint8), device=dev).float()
                for x in (img_i_u8, img_j_u8))
        return raft_flow(params, a, b, cfg).cpu().numpy()

    return estimator


def _to_255(img: torch.Tensor) -> torch.Tensor:
    """RAFT's [0, 255] input from a uint8 image, or from the ImgNorm-
    normalized float image the encoder consumed: round((x + 1) * 127.5)
    cancels the normalize's f32 rounding, so the float path equals uploading
    the uint8 image bit for bit. A leading batch dim is dropped."""
    if img.dim() == 4:
        img = img[0]
    if img.dtype == torch.uint8:
        return img.float()
    return torch.round((img.float() + 1.0) * 127.5)


def make_fused_flow_error_program(params, cfg: RAFTConfig = RAFTConfig(), out_u8: bool = True):
    """Adapter for dynamic.mask.set_flow_error_program: RAFT flow, the
    ego-motion flow and the min-max-normalized error map on the weights'
    device, with only the (h, w) map read back (as uint8 steps of 1/255 with
    `out_u8`; every consumer thresholds it).

    Images may be tensors already on the device (the pipeline passes the
    normalized frame the encoder consumed) or host arrays; host arrays are
    uploaded once and kept by identity in a 4-entry LRU (the keyframe image
    recurs every frame), so a cached array must not be changed in place.

    On CUDA the map's copy into pinned host memory is enqueued behind the
    program with an event, then `overlap_cb` (the pipeline's MASt3R decode)
    is called, and only that event is waited on: the decode runs on the card
    while the host refines the mask. A plain read after the callback would
    wait behind the decode, one stream being in order."""
    from monst3r_slam_torch.dynamic import mask as _mask

    dev = _device_of(params)
    dev_cache: dict = {}  # id -> (host array, device tensor)

    def to_device(img):
        if isinstance(img, torch.Tensor):
            return img.to(dev)
        key = id(img)
        hit = dev_cache.get(key)
        if hit is not None and hit[0] is img:
            dev_cache[key] = dev_cache.pop(key)  # refresh LRU recency
            return hit[1]
        t = torch.tensor(np.asarray(img), device=dev)  # a copy: host images may be read-only
        if len(dev_cache) >= 4:
            dev_cache.pop(next(iter(dev_cache)))
        dev_cache[key] = (img, t)
        return t

    def as_f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    @torch.no_grad()
    def adapter(img_i, img_j, T_WCi, T_WCj, depth_i, K, overlap_cb=None):
        flow = raft_flow(params, _to_255(to_device(img_i)), _to_255(to_device(img_j)), cfg)
        ego = _mask.ego_motion_flow(as_f32(T_WCi), as_f32(T_WCj), as_f32(depth_i), as_f32(K))
        err = _mask.flow_error_map(flow, ego)
        if out_u8:
            err = torch.clamp(torch.round(err * 255.0), 0, 255).to(torch.uint8)
        if dev.type == "cuda":
            host = torch.empty(err.shape, dtype=err.dtype, pin_memory=True)
            host.copy_(err, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            if overlap_cb is not None:
                overlap_cb()
            done.synchronize()
        else:
            if overlap_cb is not None:
                overlap_cb()
            host = err
        out = host.numpy()
        return out.astype(np.float32) / 255.0 if out_u8 else out.copy()

    return adapter
