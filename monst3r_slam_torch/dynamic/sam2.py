"""SAM2 (Segment Anything 2) image segmentation: the refinement of the
dynamic mask by point prompts.

Port of the JAX package's `dynamic/sam2.py`, with the same architecture and
parameter tree (linear weights (in, out), convolutions HWIO, transposed
convolutions (kh, kw, in, out)) on NHWC feature maps, f32 throughout, the
reference's type:

  * the Hiera-Det image encoder: a 7x7/s4 patch embed with (3, 3) padding;
    four stages of windowed attention blocks, q-pooling (2x2 max) at stage
    transitions, designated global-attention blocks; the absolute
    `pos_embed` resized bicubically plus the tiled `pos_embed_window`;
  * the FPN neck: a 1x1 convolution per scale to `d_model`, top-down sum
    fusion of the two lowest-resolution levels;
  * the prompt encoder: random-Fourier encoding of point prompts plus
    learned per-label embeddings (positive, negative and the not-a-point
    padding token);
  * the mask decoder: a two-way transformer, transposed-convolution
    upscaling with the two high-resolution skips, per-token hypernetwork
    MLPs and the IoU head.

Resizes follow JAX's image resize, not `F.interpolate` (`resize`): bicubic is
Keys' kernel with a = -0.5 whose weights are renormalized over the samples
inside the image, where torch uses a = -0.75 and clamps at the border.
Convolutions pad as XLA's SAME (asymmetric on stride 2). Attention is plain
softmax attention, as in the reference: Hiera-B+'s head width is 56, no
hand-written kernel runs here.

`Sam2Refiner` is the mask refiner (`dynamic.mask.set_mask_refiner`): one
positive point per connected component of the raw flow-error mask, all
components decoded as one batch on one encoder pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from monst3r_slam_torch.dynamic.raft import _same_pad


class SAM2Config(NamedTuple):
    # Hiera trunk
    embed_dim: int = 112
    num_heads: int = 2  # heads in stage 1 (doubles per stage)
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    # neck / decoder
    d_model: int = 256
    num_mask_tokens: int = 4
    dec_depth: int = 2
    dec_heads: int = 8
    dec_mlp_dim: int = 2048
    iou_head_depth: int = 3
    img_size: int = 1024  # SAM2's input resolution (multiple of 32)


# Hiera-B+ (sam2_hiera_base_plus.pt / sam2_hiera_b+.yaml)
SAM2_BASE_PLUS = SAM2Config()
# Hiera-S (sam2_hiera_small.pt)
SAM2_SMALL = SAM2Config(embed_dim=96, stages=(1, 2, 11, 2), global_att_blocks=(7, 10, 13))
# Hiera-T (sam2_hiera_tiny.pt)
SAM2_TINY = SAM2Config(embed_dim=96, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9))
# Test-size config
SAM2_TEST = SAM2Config(
    embed_dim=16, num_heads=1, stages=(1, 1, 2, 1), global_att_blocks=(2,),
    window_spec=(4, 2, 4, 2), d_model=32, dec_heads=2, dec_mlp_dim=64, img_size=128,
)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Primitives (NHWC)
# ---------------------------------------------------------------------------


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _layer_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], p["w"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def _conv2d(p, x: torch.Tensor, stride: int = 1, padding="SAME", groups: int = 1) -> torch.Tensor:
    """NHWC convolution with an HWIO kernel; `padding` is "SAME" (XLA's rule,
    the extra row and column after) or ((top, bottom), (left, right))."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        padding = (_same_pad(x.shape[1], kh, stride), _same_pad(x.shape[2], kw, stride))
    (top, bottom), (left, right) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _conv2d_transpose(p, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d with kernel == stride == 2: y[2i+di, 2j+dj] = x[i, j]
    @ w[di, dj], w (2, 2, I, O) as a torch checkpoint's (I, O, 2, 2) moved."""
    w = p["w"].to(x.dtype)
    B, H, W, _ = x.shape
    y = torch.einsum("bhwi,dkio->bhdwko", x, w).reshape(B, 2 * H, 2 * W, w.shape[-1])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    return _linear(p["fc2"], F.gelu(_linear(p["fc1"], x), approximate="none"))


def _resize_weights(n_in: int, n_out: int, method: str, device) -> torch.Tensor:
    """The (n_in, n_out) weight matrix of JAX's image resize for one axis
    (its `compute_weight_mat`, antialiased): the kernel at each output sample's
    distance from every input position, widened when downsampling,
    renormalized over the input, and zero for a sample outside the image."""
    scale = n_out / n_in
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    x = x / max(1.0 / scale, 1.0)
    if method == "bilinear":
        wts = torch.clamp(1.0 - x, min=0.0)
    elif method == "bicubic":  # Keys, a = -0.5
        wts = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                          ((1.5 * x - 2.5) * x) * x + 1.0)
        wts = torch.where(x >= 2.0, 0.0, wts)
    else:
        raise ValueError(f"resize method {method}")
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str, axes=(1, 2)) -> torch.Tensor:
    """JAX's image resize of `x`'s two spatial `axes` to `out_hw`: "nearest"
    (source index floor((i + 0.5) n_in / n_out)), "bilinear" or "bicubic"
    (a weight matrix per axis, applied as a product)."""
    for ax, n_out in zip(axes, out_hw):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            src = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
            x = x.index_select(ax, torch.floor(src).long())
        else:
            wts = _resize_weights(n_in, n_out, method, x.device).to(x.dtype)
            x = torch.tensordot(x.movedim(ax, -1), wts, dims=1).movedim(-1, ax)
    return x


# ---------------------------------------------------------------------------
# Hiera trunk
# ---------------------------------------------------------------------------


def _window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C), zero-padded to a multiple of ws."""
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head softmax attention: q (B, Nq, C), k/v (B, Nk, C) -> (B, Nq, C)."""
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // heads
    q = q.reshape(B, Nq, heads, hd).transpose(1, 2)
    k = k.reshape(B, Nk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Nk, heads, hd).transpose(1, 2)
    a = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return (a @ v).transpose(1, 2).reshape(B, Nq, C)


def _q_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max over (B, H, W, C) with XLA's SAME padding (-inf after an
    odd edge), which is max_pool2d's ceil mode."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def _hiera_block(p, x: torch.Tensor, heads: int, ws: int, q_stride: int) -> torch.Tensor:
    """One HieraBlock on (B, H, W, C_in); q_stride 2 at a stage transition
    (q-pooling and the channel-doubling projection of the shortcut)."""
    B, H, W, _ = x.shape
    shortcut = x
    xn = _layer_norm(p["norm1"], x)
    if "proj" in p:
        shortcut = _linear(p["proj"], xn)
        if q_stride > 1:
            shortcut = _q_pool(shortcut)
    C_out = p["attn"]["qkv"]["w"].shape[-1] // 3
    qkv = _linear(p["attn"]["qkv"], xn).reshape(B, H * W, 3, C_out)
    q, k, v = (qkv[:, :, i].reshape(B, H, W, C_out) for i in range(3))
    if q_stride > 1:
        q = _q_pool(q)
    Hq, Wq = q.shape[1], q.shape[2]
    if ws > 0:
        # windowed attention: k/v windows of ws, q windows of ws // q_stride
        wq = ws // q_stride if q_stride > 1 else ws
        qw, pad_q = _window_partition(q, wq)
        kw, _ = _window_partition(k, ws)
        vw, _ = _window_partition(v, ws)
        nq = qw.shape[0]
        ow = _attention(qw.reshape(nq, -1, C_out), kw.reshape(nq, -1, C_out),
                        vw.reshape(nq, -1, C_out), heads).reshape(nq, wq, wq, C_out)
        o = _window_unpartition(ow, wq, pad_q, (Hq, Wq))
    else:
        o = _attention(q.reshape(B, Hq * Wq, C_out), k.reshape(B, H * W, C_out),
                       v.reshape(B, H * W, C_out), heads).reshape(B, Hq, Wq, C_out)
    x = shortcut + _linear(p["attn"]["proj"], o)
    return x + _mlp_block(p["mlp"], _layer_norm(p["norm2"], x))


def _q_pool_blocks(cfg: SAM2Config):
    stage_ends = np.cumsum(cfg.stages) - 1
    return [int(e) for e in stage_ends], {int(e) + 1 for e in stage_ends[:-1]}


def hiera_forward(p, cfg: SAM2Config, x: torch.Tensor):
    """x (B, H, W, 3) normalized -> the 4 stage outputs (1/4 .. 1/32)."""
    # 7x7/s4 with (3, 3) padding, as torch's PatchEmbed (SAME would pad (1, 2))
    x = _conv2d(p["patch_embed"], x, stride=4, padding=((3, 3), (3, 3)))
    B, H, W, C = x.shape
    pe = resize(p["pos_embed"], (H, W), "bicubic")
    pw = p["pos_embed_window"]
    wh, ww = pw.shape[1], pw.shape[2]
    pe = pe + pw.repeat(1, -(-H // wh), -(-W // ww), 1)[:, :H, :W]
    x = x + pe

    stage_ends, q_pool_blocks = _q_pool_blocks(cfg)
    outs, heads, stage = [], cfg.num_heads, 0
    for idx, blk in enumerate(p["blocks"]):
        q_stride = 2 if idx in q_pool_blocks else 1
        # the window size lags the stage by a block, as in the official
        # hieradet.py: a transition block keeps the previous stage's window
        ws_stage = stage
        if q_stride > 1:
            stage += 1
            heads *= 2
        ws = 0 if idx in cfg.global_att_blocks else cfg.window_spec[ws_stage]
        x = _hiera_block(blk, x, heads, ws, q_stride)
        if idx in stage_ends:
            outs.append(x)
    return outs


def neck_forward(p, cfg: SAM2Config, feats):
    """FPN neck: a 1x1 convolution per scale to d_model, top-down sum fusion
    into the two lowest-resolution levels (1/16 and 1/32). Returns [1/4, 1/8,
    1/16, 1/32] at d_model channels. `p["convs"]` is ascending (convs[i]
    takes feats[i]); the official checkpoint's is descending."""
    lat = [_conv2d(pc, f) for pc, f in zip(p["convs"], feats)]
    out = [None] * len(lat)
    prev = None
    for i in range(len(lat) - 1, -1, -1):
        x = lat[i]
        if prev is not None and i >= len(lat) - 2:
            x = x + resize(prev, x.shape[1:3], "nearest")
        out[i] = prev = x
    return out


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------


def _pe_encode(pe_gaussian: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of coords01 (..., 2) in [0, 1]."""
    c = 2.0 * math.pi * ((coords01 * 2.0 - 1.0) @ pe_gaussian)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def encode_points(p, cfg: SAM2Config, points01: torch.Tensor, labels: torch.Tensor):
    """points01 (B, N, 2) in [0, 1], labels (B, N) (1 positive, 0 negative,
    -1 padding) -> sparse prompt embeddings (B, N + 1, d_model): SAM appends
    a padding point when no box is given."""
    B = points01.shape[0]
    pts = torch.cat([points01, points01.new_zeros((B, 1, 2))], dim=1)
    lbs = torch.cat([labels, -torch.ones((B, 1), dtype=labels.dtype, device=labels.device)], dim=1)
    emb = _pe_encode(p["pe_gaussian"], pts)
    lbs = lbs[..., None]
    emb = torch.where(lbs == -1, p["not_a_point"], emb)
    emb = emb + torch.where(lbs == 1, p["point_pos"], 0.0)
    return emb + torch.where(lbs == 0, p["point_neg"], 0.0)


def dense_pe(p, hw) -> torch.Tensor:
    """Positional encoding grid of the image embedding, (h, w, d)."""
    h, w = hw
    dev = p["pe_gaussian"].device
    gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1)  # (h, w, 2) as (x, y)
    return _pe_encode(p["pe_gaussian"], grid)


# ---------------------------------------------------------------------------
# Mask decoder (two-way transformer)
# ---------------------------------------------------------------------------


def _attn_block(p, q, k, v, heads: int) -> torch.Tensor:
    return _linear(p["out"], _attention(_linear(p["q"], q), _linear(p["k"], k),
                                        _linear(p["v"], v), heads))


def _twoway_layer(p, cfg: SAM2Config, tokens, img, tok_pe, img_pe, skip_first_pe: bool):
    q = tokens if skip_first_pe else tokens + tok_pe
    attn_out = _attn_block(p["self_attn"], q, q, tokens, cfg.dec_heads)
    # the skip_first_layer_pe layer replaces the queries by the attention
    # output (no residual); later layers add it
    tokens = attn_out if skip_first_pe else tokens + attn_out
    tokens = _layer_norm(p["norm1"], tokens)
    tokens = tokens + _attn_block(p["cross_t2i"], tokens + tok_pe, img + img_pe, img, cfg.dec_heads)
    tokens = _layer_norm(p["norm2"], tokens)
    tokens = _layer_norm(p["norm3"], tokens + _mlp_block(p["mlp"], tokens))
    img = img + _attn_block(p["cross_i2t"], img + img_pe, tokens + tok_pe, tokens, cfg.dec_heads)
    return tokens, _layer_norm(p["norm4"], img)


def _head_mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = _linear(lp, x)
        if i < len(layers) - 1:
            x = F.relu(x)
    return x


def mask_decoder(p, cfg: SAM2Config, img_emb, img_pe, sparse_prompts, high_res_feats):
    """img_emb (B, H16, W16, d); img_pe (H16, W16, d); sparse_prompts (B, Np,
    d); high_res_feats [(B, H4, W4, d/8), (B, H8, W8, d/4)].

    Returns (masks (B, num_mask_tokens, H4, W4) logits, iou (B,
    num_mask_tokens), tokens_f (B, n_out + Np, d)): the final token states,
    [:, 0] the object-score token and [:, 2 + m] the m-th mask token."""
    B, H, W, C = img_emb.shape
    # token order of SAM2's predict_masks: [obj_score, iou, mask_0..M-1, prompts]
    out_tokens = torch.cat([p["obj_token"], p["iou_token"], p["mask_tokens"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse_prompts], dim=1)
    img = img_emb.reshape(B, H * W, C)
    pe = img_pe.reshape(1, H * W, C).expand(B, -1, -1)
    tok_pe = tokens  # SAM uses the initial tokens as their own positional code
    for i, layer in enumerate(p["layers"]):
        tokens, img = _twoway_layer(layer, cfg, tokens, img, tok_pe, pe, skip_first_pe=i == 0)
    tokens_f = tokens + _attn_block(p["final_t2i"], tokens + tok_pe, img + pe, img, cfg.dec_heads)
    tokens_f = _layer_norm(p["norm_final"], tokens_f)

    # upscaling with the high-resolution skips (two transposed convolutions)
    src = img.reshape(B, H, W, C)
    up1 = _conv2d_transpose(p["up1"], src) + high_res_feats[1]
    up1 = F.gelu(_layer_norm(p["up_norm"], up1), approximate="none")
    up2 = F.gelu(_conv2d_transpose(p["up2"], up1) + high_res_feats[0], approximate="none")

    mask_toks = tokens_f[:, 2 : 2 + cfg.num_mask_tokens]
    hyper = torch.stack([_head_mlp(p["hyper"][m], mask_toks[:, m])
                         for m in range(cfg.num_mask_tokens)], dim=1)  # (B, M, C/8)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, up2)
    iou = _head_mlp(p["iou_head"], tokens_f[:, 1])
    return masks, iou, tokens_f


# ---------------------------------------------------------------------------
# Full image pipeline
# ---------------------------------------------------------------------------


def _normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def encode_features(params, cfg: SAM2Config, img: torch.Tensor):
    """img (1, H, W, 3) in [0, 1] -> (the raw 1/16 FPN feature, hr0 at 1/4,
    hr1 at 1/8): Hiera, the neck and the decoder's two skip projections."""
    fpn = neck_forward(params["neck"], cfg, hiera_forward(params["trunk"], cfg, _normalize(img)))
    hr0 = _conv2d(params["dec"]["skip0"], fpn[0])  # 1/4 -> d/8
    hr1 = _conv2d(params["dec"]["skip1"], fpn[1])  # 1/8 -> d/4
    return fpn[2], hr0, hr1


def sam2_encode(params, cfg: SAM2Config, img: torch.Tensor):
    """img (1, H, W, 3) in [0, 1] -> (img_emb at 1/16, hr0 at 1/4, hr1 at
    1/8): the expensive half, once per frame however many objects are
    prompted. The image predictor adds the learned no-memory embedding to
    the 1/16 level (SAM2's `directly_add_no_mem_embed`)."""
    fpn2, hr0, hr1 = encode_features(params, cfg, img)
    return fpn2 + params["no_mem_embed"], hr0, hr1


def _decode(params, cfg: SAM2Config, img_emb, hr0, hr1, points01, labels):
    """The prompt decode shared by `sam2_decode` and `sam2_decode_select`:
    image features (1, ...) broadcast over the object batch."""
    B = points01.shape[0]

    def bcast(t):
        return t.expand(B, *t.shape[1:])

    pe = dense_pe(params["prompt"], img_emb.shape[1:3])
    sparse = encode_points(params["prompt"], cfg, points01, labels)
    # without a mask prompt the dense prompt is the learned no_mask_embed
    src = img_emb + params["prompt"]["no_mask_embed"]
    return mask_decoder(params["dec"], cfg, bcast(src), pe, sparse, [bcast(hr0), bcast(hr1)])


def sam2_decode(params, cfg: SAM2Config, img_emb, hr0, hr1, points01, labels):
    """points01 (B_obj, N, 2) in [0, 1], labels (B_obj, N) -> (masks (B_obj,
    M, 4 H4, 4 W4) logits at the encoder's input resolution, iou (B_obj, M))."""
    masks, iou, _ = _decode(params, cfg, img_emb, hr0, hr1, points01, labels)
    h4, w4 = masks.shape[2:]
    return resize(masks, (4 * h4, 4 * w4), "bilinear", axes=(2, 3)), iou


def sam2_image_forward(params, cfg: SAM2Config, img, points01, labels):
    """Encode + decode: img (1, H, W, 3), points01 (B_obj, N, 2) -> (masks
    (B_obj, M, H, W) logits, iou (B_obj, M))."""
    return sam2_decode(params, cfg, *sam2_encode(params, cfg, img), points01, labels)


def sam2_decode_select(params, cfg: SAM2Config, img_emb, hr0, hr1, points01, labels):
    """Decode and select each object's best mask on the device: among the
    multimask tokens 1..3 (token 0, the single-mask output, never competes),
    the first of the highest IoU, thresholded at logit 0. Only the (B, H4, W4)
    bool masks and the (B,) IoUs need cross to the host.

    Returns (best_mask (B, H4, W4) bool, best_iou (B,))."""
    masks, iou, _ = _decode(params, cfg, img_emb, hr0, hr1, points01, labels)
    multi, miou = masks[:, 1:], iou[:, 1:]
    best = torch.argmax(miou, dim=1)  # the first maximum on ties
    rows = torch.arange(best.shape[0], device=best.device)
    return multi[rows, best] > 0.0, miou[rows, best]


def _device_of(params) -> torch.device:
    return params["no_mem_embed"].device


# ---------------------------------------------------------------------------
# SLAM refiner (dynamic.mask.set_mask_refiner)
# ---------------------------------------------------------------------------


class Sam2Refiner:
    """Per-frame SAM2 refinement of the flow-error mask: one positive point
    at the centroid of each connected component of at least `min_area`
    pixels (8-connected, largest first, at most `max_objects`), all decoded
    as one batch of fixed size on one encoder pass. A component whose best
    multimask clears `iou_floor` is replaced by its SAM2 mask; a rejected or
    unprompted one keeps its raw pixels, so a moving object never returns to
    the static set because the prompt budget ran out.

    `calls`, `replaced` and `rejected` count the refiner's calls and the
    components it replaced or rejected."""

    def __init__(self, params, cfg: SAM2Config = SAM2_BASE_PLUS, max_objects: int = 8,
                 iou_floor: float = 0.3):
        self.params = params
        self.cfg = cfg
        self.max_objects = max_objects
        self.iou_floor = iou_floor
        self.calls = self.replaced = self.rejected = 0

    def __call__(self, img_u8, err_norm, raw_mask, threshold, min_area):
        import cv2

        self.calls += 1
        h, w = raw_mask.shape
        raw_mask = np.asarray(raw_mask, bool)
        n_lbl, labels, stats, cents = cv2.connectedComponentsWithStats(
            raw_mask.astype(np.uint8), connectivity=8)
        comp = [(int(stats[i, cv2.CC_STAT_AREA]), i, cents[i]) for i in range(1, n_lbl)
                if stats[i, cv2.CC_STAT_AREA] >= min_area]
        comp.sort(reverse=True)
        if not comp:
            return raw_mask
        B = self.max_objects
        if len(comp) > B:
            print(f"Sam2Refiner: {len(comp)} components exceed the prompt budget ({B}); the "
                  f"smallest {len(comp) - B} keep their raw flow-error pixels")
        S = self.cfg.img_size
        img01 = cv2.resize(np.asarray(img_u8[..., :3], np.uint8), (S, S),
                           interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0
        # a fixed object batch, padded with not-a-point rows
        pts = np.zeros((B, 1, 2), np.float32)
        lbs = -np.ones((B, 1), np.int64)
        for i, (_, _, (cx, cy)) in enumerate(comp[:B]):
            pts[i, 0] = (cx / w, cy / h)
            lbs[i, 0] = 1
        dev = _device_of(self.params)
        emb = sam2_encode(self.params, self.cfg, torch.from_numpy(img01)[None].to(dev))
        sel, iou = sam2_decode_select(self.params, self.cfg, *emb, torch.from_numpy(pts).to(dev),
                                      torch.from_numpy(lbs).to(dev))
        sel, iou = sel.cpu().numpy(), iou.cpu().numpy()
        out = raw_mask.copy()
        for i, (_, comp_id, _) in enumerate(comp[:B]):
            if iou[i] < self.iou_floor:
                self.rejected += 1
                continue  # the component keeps its raw pixels
            m = cv2.resize(sel[i].astype(np.uint8), (w, h),
                           interpolation=cv2.INTER_NEAREST).astype(bool)
            out &= labels != comp_id  # replace this component
            out |= m  # by its SAM2 segmentation
            self.replaced += 1
        return out


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _lin_p(gen, ci, co, device):
    return {"w": math.sqrt(2.0 / ci) * torch.randn((ci, co), generator=gen, device=device),
            "b": torch.zeros(co, device=device)}


def _ln_p(c, device):
    return {"w": torch.ones(c, device=device), "b": torch.zeros(c, device=device)}


def _cv_p(gen, kh, kw, ci, co, device):
    return {"w": math.sqrt(2.0 / (kh * kw * ci))
            * torch.randn((kh, kw, ci, co), generator=gen, device=device),
            "b": torch.zeros(co, device=device)}


def _attn_p(gen, c, device, kv_c=None, internal=None):
    """q/k/v/out projections; the decoder's cross-attention downscales the
    internal width."""
    kv_c, internal = kv_c or c, internal or c
    return {"q": _lin_p(gen, c, internal, device), "k": _lin_p(gen, kv_c, internal, device),
            "v": _lin_p(gen, kv_c, internal, device), "out": _lin_p(gen, internal, c, device)}


def _small(gen, shape, device):
    return 0.02 * torch.randn(shape, generator=gen, device=device)


def init_sam2_params(gen: torch.Generator, cfg: SAM2Config = SAM2_BASE_PLUS, device=None):
    """Random weights of the reference's `init_sam2_params` layout and scale,
    drawn from `gen` on `device` (the generator's by default)."""
    device = gen.device if device is None else device
    C, d = cfg.embed_dim, cfg.d_model
    _, q_pool_blocks = _q_pool_blocks(cfg)
    blocks, dim = [], C
    for i in range(int(sum(cfg.stages))):
        dim_out = dim * 2 if i in q_pool_blocks else dim
        blk = {
            "norm1": _ln_p(dim, device),
            "attn": {"qkv": _lin_p(gen, dim, 3 * dim_out, device),
                     "proj": _lin_p(gen, dim_out, dim_out, device)},
            "norm2": _ln_p(dim_out, device),
            "mlp": {"fc1": _lin_p(gen, dim_out, 4 * dim_out, device),
                    "fc2": _lin_p(gen, 4 * dim_out, dim_out, device)},
        }
        if dim_out != dim:
            blk["proj"] = _lin_p(gen, dim, dim_out, device)
        blocks.append(blk)
        dim = dim_out
    bh, bw = cfg.window_pos_embed_bkg_spatial_size
    ws0 = cfg.window_spec[0]
    trunk = {"patch_embed": _cv_p(gen, 7, 7, 3, C, device),
             "pos_embed": _small(gen, (1, bh, bw, C), device),
             "pos_embed_window": _small(gen, (1, ws0, ws0, C), device),
             "blocks": blocks}
    neck = {"convs": [_cv_p(gen, 1, 1, C * 2**i, d, device) for i in range(len(cfg.stages))]}
    prompt = {"pe_gaussian": torch.randn((2, d // 2), generator=gen, device=device),
              **{k: _small(gen, (d,), device)
                 for k in ("point_neg", "point_pos", "not_a_point", "no_mask_embed")}}

    def twoway_layer():
        return {"self_attn": _attn_p(gen, d, device), "norm1": _ln_p(d, device),
                "cross_t2i": _attn_p(gen, d, device, internal=d // 2), "norm2": _ln_p(d, device),
                "mlp": {"fc1": _lin_p(gen, d, cfg.dec_mlp_dim, device),
                        "fc2": _lin_p(gen, cfg.dec_mlp_dim, d, device)},
                "norm3": _ln_p(d, device),
                "cross_i2t": _attn_p(gen, d, device, internal=d // 2), "norm4": _ln_p(d, device)}

    M = cfg.num_mask_tokens
    dec = {
        "iou_token": _small(gen, (1, d), device),
        "mask_tokens": _small(gen, (M, d), device),
        "obj_token": _small(gen, (1, d), device),
        "layers": [twoway_layer() for _ in range(cfg.dec_depth)],
        "final_t2i": _attn_p(gen, d, device, internal=d // 2),
        "norm_final": _ln_p(d, device),
        "up1": _cv_p(gen, 2, 2, d, d // 4, device),
        "up_norm": _ln_p(d // 4, device),
        "up2": _cv_p(gen, 2, 2, d // 4, d // 8, device),
        "skip0": _cv_p(gen, 1, 1, d, d // 8, device),
        "skip1": _cv_p(gen, 1, 1, d, d // 4, device),
        "hyper": [[_lin_p(gen, d, d, device), _lin_p(gen, d, d, device),
                   _lin_p(gen, d, d // 8, device)] for _ in range(M)],
        "iou_head": [_lin_p(gen, d, d, device), _lin_p(gen, d, d, device),
                     _lin_p(gen, d, M, device)],
    }
    return {"trunk": trunk, "neck": neck, "prompt": prompt, "dec": dec,
            "no_mem_embed": _small(gen, (1, 1, 1, d), device)}


def sam2_params_from_numpy(tree, device="cpu"):
    """The reference's SAM2 (or video) parameter tree with numpy leaves ->
    the port's, the same layout, float32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: sam2_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sam2_params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _load_state_dict(path: str, device):
    """An official SAM2 checkpoint's state dict (under "model"), f32 on
    `device`. The file is unpickled in full: load only trusted checkpoints."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in sd:
        sd = sd["model"]
    return {k: v.float().to(device) for k, v in sd.items()}


class _Reader:
    """Reads a SAM2 state dict into the reference's layouts: linear (out,
    in) -> (in, out), convolution OIHW -> HWIO, transposed convolution (I, O,
    kh, kw) -> (kh, kw, I, O)."""

    def __init__(self, sd):
        self.sd = sd

    def lin(self, name):
        return {"w": self.sd[f"{name}.weight"].t().contiguous(), "b": self.sd[f"{name}.bias"]}

    def ln(self, name):
        return {"w": self.sd[f"{name}.weight"], "b": self.sd[f"{name}.bias"]}

    def _with_bias(self, name, w):
        p = {"w": w.contiguous()}
        if f"{name}.bias" in self.sd:
            p["b"] = self.sd[f"{name}.bias"]
        return p

    def cv(self, name):
        return self._with_bias(name, self.sd[f"{name}.weight"].permute(2, 3, 1, 0))

    def cvt(self, name):
        return self._with_bias(name, self.sd[f"{name}.weight"].permute(2, 3, 0, 1))

    def attn(self, name):
        return {"q": self.lin(f"{name}.q_proj"), "k": self.lin(f"{name}.k_proj"),
                "v": self.lin(f"{name}.v_proj"), "out": self.lin(f"{name}.out_proj")}


def _image_params(r: _Reader, cfg: SAM2Config):
    sd = r.sd
    tk = "image_encoder.trunk"
    _, q_pool_blocks = _q_pool_blocks(cfg)
    blocks = []
    for i in range(int(sum(cfg.stages))):
        b = f"{tk}.blocks.{i}"
        blk = {"norm1": r.ln(f"{b}.norm1"),
               "attn": {"qkv": r.lin(f"{b}.attn.qkv"), "proj": r.lin(f"{b}.attn.proj")},
               "norm2": r.ln(f"{b}.norm2"),
               "mlp": {"fc1": r.lin(f"{b}.mlp.layers.0"), "fc2": r.lin(f"{b}.mlp.layers.1")}}
        if i in q_pool_blocks:
            blk["proj"] = r.lin(f"{b}.proj")
        blocks.append(blk)
    trunk = {"patch_embed": r.cv(f"{tk}.patch_embed.proj"),
             "pos_embed": sd[f"{tk}.pos_embed"].permute(0, 2, 3, 1).contiguous(),
             "pos_embed_window": sd[f"{tk}.pos_embed_window"].permute(0, 2, 3, 1).contiguous(),
             "blocks": blocks}
    # the checkpoint's neck convolutions are descending (convs.0 takes 1/32)
    n_lv = len(cfg.stages)
    neck = {"convs": [r.cv(f"image_encoder.neck.convs.{n_lv - 1 - i}.conv") for i in range(n_lv)]}
    pk = "sam_prompt_encoder"
    prompt = {"pe_gaussian": sd[f"{pk}.pe_layer.positional_encoding_gaussian_matrix"],
              # point_embeddings: 0 negative, 1 positive (2 and 3 are box corners)
              "point_neg": sd[f"{pk}.point_embeddings.0.weight"][0],
              "point_pos": sd[f"{pk}.point_embeddings.1.weight"][0],
              "not_a_point": sd[f"{pk}.not_a_point_embed.weight"][0],
              "no_mask_embed": sd[f"{pk}.no_mask_embed.weight"][0]}
    dk = "sam_mask_decoder"
    layers = []
    for i in range(cfg.dec_depth):
        L = f"{dk}.transformer.layers.{i}"
        layers.append({"self_attn": r.attn(f"{L}.self_attn"), "norm1": r.ln(f"{L}.norm1"),
                       "cross_t2i": r.attn(f"{L}.cross_attn_token_to_image"),
                       "norm2": r.ln(f"{L}.norm2"),
                       "mlp": {"fc1": r.lin(f"{L}.mlp.layers.0"),
                               "fc2": r.lin(f"{L}.mlp.layers.1")},
                       "norm3": r.ln(f"{L}.norm3"),
                       "cross_i2t": r.attn(f"{L}.cross_attn_image_to_token"),
                       "norm4": r.ln(f"{L}.norm4")})
    dec = {
        "iou_token": sd[f"{dk}.iou_token.weight"],
        "mask_tokens": sd[f"{dk}.mask_tokens.weight"],
        "obj_token": sd[f"{dk}.obj_score_token.weight"],
        "layers": layers,
        "final_t2i": r.attn(f"{dk}.transformer.final_attn_token_to_image"),
        "norm_final": r.ln(f"{dk}.transformer.norm_final_attn"),
        "up1": r.cvt(f"{dk}.output_upscaling.0"),
        "up_norm": r.ln(f"{dk}.output_upscaling.1"),
        "up2": r.cvt(f"{dk}.output_upscaling.3"),
        "skip0": r.cv(f"{dk}.conv_s0"),
        "skip1": r.cv(f"{dk}.conv_s1"),
        "hyper": [[r.lin(f"{dk}.output_hypernetworks_mlps.{m}.layers.{j}") for j in range(3)]
                  for m in range(cfg.num_mask_tokens)],
        "iou_head": [r.lin(f"{dk}.iou_prediction_head.layers.{j}") for j in range(3)],
    }
    return {"trunk": trunk, "neck": neck, "prompt": prompt, "dec": dec,
            # (1, 1, d) in the checkpoint
            "no_mem_embed": sd["no_mem_embed"].reshape(1, 1, 1, -1)}


def sam2_params_from_torch(path: str, cfg: SAM2Config = SAM2_BASE_PLUS, device="cpu"):
    """An official SAM2 checkpoint (facebookresearch/sam2,
    `sam2_hiera_base_plus.pt` etc., the state dict under "model") -> the
    image pipeline's parameters on `device`, as the reference converts it.
    The memory modules are left out (`sam2_video.video_params_from_torch`
    reads them)."""
    return _image_params(_Reader(_load_state_dict(path, device)), cfg)
