"""Plain reference of SAM2's image path as the dynamic mask's refiner runs
it: the Hiera image encoder, the FPN neck, the point-prompt encoder, the
two-way mask decoder, and the selection of each prompt's mask.

Written from the published architecture (Ravi et al. 2024, SAM2's
`hieradet.py`, `image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`
and `transformer.py`) in plain PyTorch, independent of the program, reading
the weight tree of `harness/weights_dynamic.py` (linears (in, out),
convolutions HWIO) on NHWC maps in float32 with TF32 off. Windowed
attention pads each map with zeros to a multiple of the window, and a
pooling block pools its queries inside each window, as `hieradet.py` does.
Where the program follows the reference package's semantics rather than
the official code's, so does this file; the departures are these:

* the absolute position embedding is resized as JAX's `image.resize`
  resizes (Keys' cubic with a = -0.5, its weights renormalized over the
  samples inside the image), where the official code calls
  `F.interpolate(mode="bicubic")` (a = -0.75, border clamped);
* every layer norm takes eps 1e-6, and the two-way transformer's MLP
  takes GELU (the official one ReLU);
* a point prompt's coordinates are given in [0, 1] of the frame (the
  official predictor adds half a pixel and divides by the input size).

`Precision` as in `raft.py`: `bf16` rounds both operands of every matrix
product and convolution to bfloat16 (the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.raft import identity

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS = 1e-6


def lin(p, x, P):
    return P(x) @ P(p["w"]) + p["b"].float()


def ln(p, x):
    return F.layer_norm(x, x.shape[-1:], p["w"].float(), p["b"].float(), EPS)


def conv(p, x, P, stride: int = 1, pad: int = 0):
    """NHWC convolution, HWIO weights, symmetric zero padding."""
    y = F.conv2d(P(x.permute(0, 3, 1, 2)), P(p["w"].permute(3, 2, 0, 1)), p["b"].float(),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def up2(p, x, P):
    """The 2x2 stride-2 transposed convolution, NHWC, (2, 2, I, O) weights."""
    y = F.conv_transpose2d(P(x.permute(0, 3, 1, 2)), P(p["w"].permute(2, 3, 0, 1)),
                           p["b"].float(), stride=2)
    return y.permute(0, 2, 3, 1)


def mha(q, k, v, heads: int, P):
    """Softmax attention of (B, Nq, C) queries over (B, Nk, C) keys and values."""
    b, nq, c = q.shape
    hd = c // heads
    q = q.reshape(b, nq, heads, hd).transpose(1, 2)
    k = k.reshape(b, -1, heads, hd).transpose(1, 2)
    v = v.reshape(b, -1, heads, hd).transpose(1, 2)
    a = torch.softmax((P(q) @ P(k).transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return (P(a) @ P(v)).transpose(1, 2).reshape(b, nq, c)


# ---------------------------------------------------------------------------
# Hiera
# ---------------------------------------------------------------------------


def cubic(x):
    """Keys' cubic convolution kernel, a = -0.5."""
    x = x.abs()
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1, near, torch.where(x < 2, far, torch.zeros_like(x)))


def resize_axis(x, dim: int, n_out: int):
    """JAX's cubic resize of one axis (upsampling or downsampling with the
    kernel widened by the ratio)."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    scale = n_out / n_in
    centres = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) / scale - 0.5
    stretch = max(1.0 / scale, 1.0)
    src = torch.arange(n_in, dtype=torch.float32, device=x.device)
    wt = cubic((centres[:, None] - src[None, :]) / stretch)  # (n_out, n_in)
    tot = wt.sum(1, keepdim=True)
    wt = torch.where(tot.abs() > 1000 * torch.finfo(torch.float32).eps,
                     wt / torch.where(tot == 0, torch.ones_like(tot), tot), torch.zeros_like(wt))
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    wt = wt * inside[:, None]
    return torch.movedim(torch.movedim(x, dim, -1) @ wt.T, -1, dim)


def pool(x):
    """2x2 stride-2 max pool of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def windows(x, ws: int):
    """(B, H, W, C) -> (B * n, ws, ws, C) of the zero-padded map, and the padded size."""
    b, h, w, c = x.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def unwindows(x, ws: int, padded, size, b: int):
    hp, wp = padded
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :size[0], :size[1]]


def block(p, x, heads: int, ws: int, pooled: bool, P):
    """A Hiera block: (windowed) attention with pooled queries where
    `pooled`, the projected and pooled shortcut where the width changes,
    then the MLP."""
    b, h, w, _ = x.shape
    xn = ln(p["norm1"], x)
    short = x
    if "proj" in p:
        short = lin(p["proj"], xn, P)
        if pooled:
            short = pool(short)
    co = p["attn"]["qkv"]["w"].shape[1] // 3
    if ws:
        t, padded = windows(xn, ws)
    else:
        t, padded = xn, (h, w)
    nb, th, tw, _ = t.shape
    qkv = lin(p["attn"]["qkv"], t, P).reshape(nb, th, tw, 3, co)
    q, k, v = qkv.unbind(3)
    if pooled:
        q = pool(q)
    qh, qw = q.shape[1:3]
    o = mha(q.reshape(nb, qh * qw, co), k.reshape(nb, th * tw, co), v.reshape(nb, th * tw, co),
            heads, P).reshape(nb, qh, qw, co)
    o = lin(p["attn"]["proj"], o, P)
    s = 2 if pooled else 1
    if ws:
        o = unwindows(o, ws // s, (padded[0] // s, padded[1] // s), (h // s, w // s), b)
    x = short + o
    return x + lin(p["mlp"]["fc2"], F.gelu(lin(p["mlp"]["fc1"], ln(p["norm2"], x), P)), P)


def hiera(p, sc: dict, x, P):
    """x (1, S, S, 3) normalized -> the four stages' last outputs."""
    x = conv(p["patch_embed"], x, P, stride=4, pad=3)
    _, h, w, _ = x.shape
    pe = resize_axis(resize_axis(p["pos_embed"].float(), 1, h), 2, w)
    win = p["pos_embed_window"].float()
    pe = pe + win.repeat(1, -(-h // win.shape[1]), -(-w // win.shape[2]), 1)[:, :h, :w]
    x = x + pe
    outs, i = [], 0
    heads = sc["num_heads"]
    for stage, n in enumerate(sc["stages"]):
        for j in range(n):
            pooled = stage > 0 and j == 0
            if pooled:
                heads *= 2
            # a pooling block still attends in the previous stage's windows
            ws = sc["window_spec"][stage - 1 if pooled else stage]
            if i in sc["global_att_blocks"]:
                ws = 0
            x = block(p["blocks"][i], x, heads, ws, pooled, P)
            i += 1
        outs.append(x)
    return outs


def encode(params, sc: dict, img01, P=identity):
    """img01 (1, S, S, 3) in [0, 1] -> (the 1/16 embedding with SAM2's
    no-memory embedding added, the 1/4 and 1/8 skips)."""
    mean = torch.tensor(MEAN, device=img01.device)
    std = torch.tensor(STD, device=img01.device)
    feats = hiera(params["trunk"], sc, (img01.float() - mean) / std, P)
    lat = [conv(c, f, P) for c, f in zip(params["neck"]["convs"], feats)]
    # top-down fusion into the two coarsest levels only
    top = lat[3]
    lat[2] = lat[2] + top.repeat_interleave(2, 1).repeat_interleave(2, 2)
    dec = params["dec"]
    return (lat[2] + params["no_mem_embed"].float(), conv(dec["skip0"], lat[0], P),
            conv(dec["skip1"], lat[1], P))


# ---------------------------------------------------------------------------
# Prompts and the mask decoder
# ---------------------------------------------------------------------------


def fourier(g, xy01):
    c = 2 * math.pi * ((2 * xy01 - 1) @ g.float())
    return torch.cat([c.sin(), c.cos()], -1)


def prompt_tokens(pp, pts01, labels):
    """(B, N, 2) points in [0, 1] and their labels (1, 0, -1) -> (B, N + 1,
    d): the points' Fourier codes plus their label's embedding, then the
    padding point SAM appends without a box."""
    b = pts01.shape[0]
    pts = torch.cat([pts01.float(), torch.zeros((b, 1, 2), device=pts01.device)], 1)
    lab = torch.cat([labels, torch.full((b, 1), -1, dtype=labels.dtype,
                                        device=labels.device)], 1)[..., None]
    code = fourier(pp["pe_gaussian"], pts)
    code = torch.where(lab == -1, pp["not_a_point"].float().expand_as(code), code)
    return code + (lab == 1) * pp["point_pos"].float() + (lab == 0) * pp["point_neg"].float()


def grid_code(pp, h: int, w: int, device):
    y = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
    x = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return fourier(pp["pe_gaussian"], torch.stack([xx, yy], -1))


def attend(p, q, k, v, heads, P):
    return lin(p["out"], mha(lin(p["q"], q, P), lin(p["k"], k, P), lin(p["v"], v, P), heads, P),
               P)


def mlp(layers, x, P):
    for i, p in enumerate(layers):
        x = lin(p, x, P)
        x = F.relu(x) if i + 1 < len(layers) else x
    return x


def decode(params, sc: dict, emb, hr0, hr1, pts01, labels, P=identity):
    """The mask decoder for a batch of prompts on one image's features ->
    (mask logits (B, M, 4 h, 4 w), IoU predictions (B, M))."""
    d, heads, dec = sc["d_model"], sc["dec_heads"], params["dec"]
    b = pts01.shape[0]
    _, h, w, _ = emb.shape
    out_tok = torch.cat([dec["obj_token"], dec["iou_token"], dec["mask_tokens"]]).float()
    tok = torch.cat([out_tok.expand(b, -1, -1), prompt_tokens(params["prompt"], pts01, labels)],
                    1)
    pe_tok = tok
    img = (emb.float() + params["prompt"]["no_mask_embed"].float()).reshape(1, h * w, d)
    img = img.expand(b, -1, -1)
    pe_img = grid_code(params["prompt"], h, w, emb.device).reshape(1, h * w, d).expand(b, -1, -1)
    for i, lp in enumerate(dec["layers"]):
        if i == 0:
            tok = attend(lp["self_attn"], tok, tok, tok, heads, P)
        else:
            q = tok + pe_tok
            tok = tok + attend(lp["self_attn"], q, q, tok, heads, P)
        tok = ln(lp["norm1"], tok)
        tok = ln(lp["norm2"], tok + attend(lp["cross_t2i"], tok + pe_tok, img + pe_img, img,
                                           heads, P))
        tok = ln(lp["norm3"], tok + lin(lp["mlp"]["fc2"], F.gelu(lin(lp["mlp"]["fc1"], tok, P)),
                                        P))
        img = ln(lp["norm4"], img + attend(lp["cross_i2t"], img + pe_img, tok + pe_tok, tok,
                                           heads, P))
    tok = ln(dec["norm_final"], tok + attend(dec["final_t2i"], tok + pe_tok, img + pe_img, img,
                                             heads, P))
    x = img.reshape(b, h, w, d)
    x = F.gelu(ln(dec["up_norm"], up2(dec["up1"], x, P) + hr1.float()))
    x = F.gelu(up2(dec["up2"], x, P) + hr0.float())
    m = sc["num_mask_tokens"]
    hyper = torch.stack([mlp(dec["hyper"][i], tok[:, 2 + i], P) for i in range(m)], 1)
    logits = torch.einsum("bmc,bhwc->bmhw", P(hyper), P(x))
    return logits, mlp(dec["iou_head"], tok[:, 1], P)


def select(logits, iou):
    """Each prompt's mask: the first of the highest IoU among the multimask
    outputs 1..M-1, thresholded at 0 -> (bool (B, 4h, 4w), its IoU (B,))."""
    best = iou[:, 1:].argmax(1) + 1
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, best] > 0, iou[rows, best]
