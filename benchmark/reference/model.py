"""Plain reference of the two-view model: CroCo ViT encoder, twin
cross-attention decoder, DPT heads and the catMLP descriptor head.

Written from the published architecture (CroCo v2 / DUSt3R / MASt3R) in
plain PyTorch, independent of the program: the patch embedding is a
strided convolution, attention is two matmuls and a softmax, the x2
upsampling is `F.interpolate(..., align_corners=True)`, the pixel shuffle
is `F.pixel_shuffle`. It reads the weight tree of `harness/weights.py` and
computes in float32 with TF32 off (`exact_f32`), whatever type the weights
are stored in.

`Precision("fp8")` rounds both operands of every matmul and convolution to
float8 e4m3 with one scale per tensor (amax / 448), as an fp8 deployment of
a bf16 model would; accumulation stays f32 and gradients pass straight
through the rounding. It is the control: the reference one precision step
below the bf16 the configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}: f32 or fp8")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "f32":
            return x
        scale = (x.detach().abs().amax() / FP8_MAX).clamp(min=1e-30)
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach() if x.requires_grad else q


F32 = Precision("f32")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(p, x, P: Precision):
    y = P(x) @ P(p["w"]).transpose(0, 1)
    return y + p["b"].float() if "b" in p else y


def conv(p, x, P: Precision, stride: int = 1, padding: int = 0):
    b = p["b"].float() if "b" in p else None
    return F.conv2d(P(x), P(p["w"]), b, stride=stride, padding=padding)


def conv_transpose(p, x, P: Precision, k: int):
    return F.conv_transpose2d(P(x), P(p["w"]), p["b"].float(), stride=k)


def layernorm(p, x, eps: float):
    return F.layer_norm(x.float(), x.shape[-1:], p["w"].float(), p["b"].float(), eps)


def rope(x, pos, freq: float):
    """RoPE2D: the first half of each head rotated by the patch row, the
    second by its column. x (B, H, N, hd), pos (B, N, 2)."""
    hd = x.shape[-1]
    half = hd // 2
    out = []
    for part, p in zip(x.chunk(2, dim=-1), (pos[..., 0], pos[..., 1])):
        inv = 1.0 / freq ** (torch.arange(0, half // 2, device=x.device).float() * 2.0 / half)
        ang = p[..., None].float() * inv
        ang = torch.cat([ang, ang], dim=-1)[:, None]
        a, b = part.chunk(2, dim=-1)
        out.append(part * torch.cos(ang) + torch.cat([-b, a], dim=-1) * torch.sin(ang))
    return torch.cat(out, dim=-1)


def attention(q, k, v, P: Precision):
    s = (P(q) @ P(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    return P(torch.softmax(s, dim=-1)) @ P(v)


def split_heads(x, n):
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def self_attn(p, x, pos, heads: int, freq: float, P):
    q, k, v = (split_heads(t, heads) for t in linear(p["qkv"], x, P).chunk(3, dim=-1))
    return linear(p["proj"], merge_heads(attention(rope(q, pos, freq), rope(k, pos, freq), v, P)),
                  P)


def cross_attn(p, x, y, xpos, ypos, heads: int, freq: float, P):
    q = rope(split_heads(linear(p["q"], x, P), heads), xpos, freq)
    k = rope(split_heads(linear(p["k"], y, P), heads), ypos, freq)
    v = split_heads(linear(p["v"], y, P), heads)
    return linear(p["proj"], merge_heads(attention(q, k, v, P)), P)


def mlp(p, x, P):
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x, P)), P)


def positions(n_h: int, n_w: int, b: int, device):
    y, x = torch.meshgrid(torch.arange(n_h, device=device), torch.arange(n_w, device=device),
                          indexing="ij")
    return torch.stack([y, x], -1).reshape(1, n_h * n_w, 2).expand(b, -1, -1)


def encode(params, cfg: dict, img, P: Precision = F32):
    """img (B, H, W, 3) normalized -> (tokens (B, N, enc_dim), positions)."""
    ps, e, eps = cfg["patch_size"], cfg["enc_dim"], cfg["ln_eps"]
    w = params["patch_embed"]["proj"]["w"].float().reshape(e, ps, ps, 3).permute(0, 3, 1, 2)
    x = F.conv2d(P(img.permute(0, 3, 1, 2)), P(w), params["patch_embed"]["proj"]["b"].float(),
                 stride=ps)
    b, _, n_h, n_w = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = positions(n_h, n_w, b, img.device)
    for blk in params["enc_blocks"]:
        x = x + self_attn(blk["attn"], layernorm(blk["norm1"], x, eps), pos, cfg["enc_heads"],
                          cfg["rope_freq"], P)
        x = x + mlp(blk["mlp"], layernorm(blk["norm2"], x, eps), P)
    return layernorm(params["enc_norm"], x, eps), pos


def decode(params, cfg: dict, f1, p1, f2, p2, P: Precision = F32):
    """The twin decoder; each stream's four DPT hooks: (encoder tokens, block
    depth/2, block 3 depth/4, the normed last block)."""
    eps, heads, freq, depth = cfg["ln_eps"], cfg["dec_heads"], cfg["rope_freq"], cfg["dec_depth"]
    x1, x2 = linear(params["decoder_embed"], f1, P), linear(params["decoder_embed"], f2, P)
    hooks = (depth * 2 // 4, depth * 3 // 4)
    mids1, mids2 = [], []

    def block(p, x, y, xpos, ypos):
        x = x + self_attn(p["attn"], layernorm(p["norm1"], x, eps), xpos, heads, freq, P)
        x = x + cross_attn(p["cross"], layernorm(p["norm2"], x, eps),
                           layernorm(p["norm_y"], y, eps), xpos, ypos, heads, freq, P)
        return x + mlp(p["mlp"], layernorm(p["norm3"], x, eps), P)

    for i, (b1, b2) in enumerate(zip(params["dec_blocks"], params["dec_blocks2"]), 1):
        x1, x2 = block(b1, x1, x2, p1, p2), block(b2, x2, x1, p2, p1)
        if i in hooks:
            mids1.append(x1)
            mids2.append(x2)
    return ((f1, *mids1, layernorm(params["dec_norm"], x1, eps)),
            (f2, *mids2, layernorm(params["dec_norm"], x2, eps)))


def _rcu(p, x, P):
    out = conv(p["conv1"], F.relu(x), P, padding=1)
    return conv(p["conv2"], F.relu(out), P, padding=1) + x


def _fusion(p, x, skip, P):
    if skip is not None:
        x = x + _rcu(p["res1"], skip, P)
    x = _rcu(p["res2"], x, P)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    return conv(p["out_conv"], x, P)


def dpt(p, hooks, n_h: int, n_w: int, P):
    feats = []
    for i, t in enumerate(hooks):
        x = t.float().reshape(t.shape[0], n_h, n_w, -1).permute(0, 3, 1, 2)
        act = p["act"][i]
        x = conv(act["conv"], x, P)
        if i == 0:
            x = conv_transpose(act["up"], x, P, 4)
        elif i == 1:
            x = conv_transpose(act["up"], x, P, 2)
        elif i == 3:
            x = conv(act["down"], x, P, stride=2, padding=1)
        feats.append(conv(p["layer_rn"][i], x, P, padding=1))
    path = _fusion(p["refine4"], feats[3], None, P)[..., : feats[2].shape[2], : feats[2].shape[3]]
    path = _fusion(p["refine3"], path, feats[2], P)
    path = _fusion(p["refine2"], path, feats[1], P)
    path = _fusion(p["refine1"], path, feats[0], P)
    h = conv(p["head"]["conv1"], path, P, padding=1)
    h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
    h = F.relu(conv(p["head"]["conv2"], h, P, padding=1))
    return conv(p["head"]["conv3"], h, P).permute(0, 2, 3, 1)


def _conf(x, mode):
    vmin, vmax = float(mode[1]), float(mode[2])
    return vmin + torch.clamp(torch.exp(x), max=vmax - vmin)


def head(hp, cfg: dict, hooks, n_h: int, n_w: int, P: Precision = F32) -> dict:
    """Pointmap (exp depth mode), confidence and, with a descriptor head,
    unit descriptors and their confidence, (B, H, W, ...) f32."""
    f = dpt(hp["dpt"], hooks, n_h, n_w, P)
    xyz = f[..., 0:3]
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    out = {"pts3d": xyz / d.clamp(min=1e-8) * torch.expm1(d.clamp(max=40.0)),
           "conf": _conf(f[..., 3], cfg["conf_mode"])}
    if cfg["desc_dim"] is None:
        return out
    ps, fd = cfg["patch_size"], cfg["desc_dim"]
    x = torch.cat([hooks[0].float(), hooks[3].float()], dim=-1)
    local = mlp(hp["local_feat"], x, P)
    b = local.shape[0]
    local = F.pixel_shuffle(local.reshape(b, n_h, n_w, -1).permute(0, 3, 1, 2), ps)
    local = local.permute(0, 2, 3, 1)
    desc = local[..., :fd]
    out["desc"] = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    out["desc_conf"] = (_conf(local[..., fd], cfg["desc_conf_mode"]) if cfg["two_confs"]
                        else out["conf"])
    return out


def pair(params, cfg: dict, img1, img2, P: Precision = F32):
    """Both views' head outputs for the ordered image pair."""
    n_h, n_w = img1.shape[1] // cfg["patch_size"], img1.shape[2] // cfg["patch_size"]
    f1, p1 = encode(params, cfg, img1, P)
    f2, p2 = encode(params, cfg, img2, P)
    h1, h2 = decode(params, cfg, f1, p1, f2, p2, P)
    return head(params["head1"], cfg, h1, n_h, n_w, P), head(params["head2"], cfg, h2, n_h, n_w, P)


def rel_errors(got: dict, ref: dict) -> dict:
    """Per output: (relative RMS, largest error over the largest reference
    magnitude) of `got` against `ref`, both f32."""
    out = {}
    for k, r in ref.items():
        g, r = got[k].float(), r.float()
        diff = (g - r).nan_to_num(nan=math.inf)
        out[k] = (float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(r)),
                  float(diff.abs().max() / r.abs().max()))
    return out
