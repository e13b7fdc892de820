"""SAM2 video predictor: memory encoder, memory attention and object
pointers.

Port of the JAX package's `dynamic/sam2_video.py`, the path the reference
drives through `build_sam2_video_predictor` / `propagate_in_video`
(`sam2_hiera_b+.yaml`), with the same parameter tree:

  * memory encoder: a 1x1 `pix_feat_proj` on the raw 1/16 feature, a
    strided-convolution mask downsampler (1 -> 4 -> 16 -> 64 -> 256
    channels, 16x spatially) on the scaled sigmoid of the predicted mask,
    additive fusion, two ConvNeXt blocks, a 1x1 `out_proj` to the memory
    width, and the sine positional code of the memory grid;
  * memory attention: pre-norm layers of RoPE self-attention over the
    current frame's 1/16 tokens and RoPE cross-attention into the memory
    bank (the spatial memories of up to `num_maskmem` frames, each with a
    learned temporal embedding, then up to `max_obj_ptrs` object-pointer
    tokens that RoPE skips), a ReLU MLP and a final layernorm; the current
    tokens enter with `0.1 * sine_pe` added;
  * object pointers: a 3-layer MLP on the selected mask token, blended with
    the learned `no_obj_ptr` by the hard object-present indicator.

The memory bank has a fixed capacity (`num_maskmem` spatial slots and
`max_obj_ptrs` pointer slots with validity flags), as in the reference:
empty slots take a -1e9 logit bias, so every frame runs at the same shapes.
The reference's per-frame program is branch-free (it runs memory attention
on the conditioning frame too and then discards it); here `is_cond` is a
host boolean and the conditioning frame skips memory attention, which gives
the same result: every refiner call in the reference's mode (a one-frame
video per SLAM frame) is a conditioning frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from monst3r_slam_torch.dynamic import sam2 as S


class VideoConfig(NamedTuple):
    mem_dim: int = 64  # memory channel width (b+: 64)
    num_maskmem: int = 7  # 1 conditioning + 6 recent frames
    max_obj_ptrs: int = 16  # max_obj_ptrs_in_encoder
    mem_layers: int = 4
    mem_heads: int = 1
    mem_mlp: int = 2048
    rope_theta: float = 10000.0
    sigmoid_scale: float = 20.0  # sigmoid_scale_for_mem_enc
    sigmoid_bias: float = -10.0  # sigmoid_bias_for_mem_enc


VIDEO_BASE_PLUS = VideoConfig()
# paired with sam2.SAM2_TEST (d_model 32)
VIDEO_TEST = VideoConfig(mem_dim=16, mem_layers=2, mem_mlp=64, max_obj_ptrs=4)


# ---------------------------------------------------------------------------
# Positional codes
# ---------------------------------------------------------------------------


def sine_pe_2d(h: int, w: int, dim: int, temperature: float = 10000.0, device=None):
    """The official `PositionEmbeddingSine` (normalize, scale 2 pi): (h, w,
    dim), dim/2 y-channels then dim/2 x-channels, sin/cos interleaved."""
    npf = dim // 2
    eps, scale = 1e-6, 2.0 * math.pi
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y, x = ones.cumsum(0), ones.cumsum(1)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2.0 * torch.div(torch.arange(npf, dtype=torch.float32, device=device),
                                            2, rounding_mode="floor") / npf)
    py, px = y[..., None] / dim_t, x[..., None] / dim_t
    py, px = (torch.stack([torch.sin(t[..., 0::2]), torch.cos(t[..., 1::2])], dim=-1)
              .reshape(h, w, npf) for t in (py, px))
    return torch.cat([py, px], dim=-1)


def axial_rope_freqs(h: int, w: int, head_dim: int, theta: float, device=None):
    """The official `compute_axial_cis`: per-token rotations, the first half
    of the (complex) head driven by x, the second by y. Returns cos and sin,
    each (h*w, head_dim // 2)."""
    quarter = head_dim // 4
    exps = torch.arange(0, head_dim, 4, dtype=torch.float32, device=device)[:quarter] / head_dim
    freqs = 1.0 / theta**exps
    t_x = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    t_y = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w)
    ang = torch.cat([t_x[:, None] * freqs[None], t_y[:, None] * freqs[None]], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, head_dim) as complex pairs (x[2i], x[2i+1]); cos/sin (N,
    head_dim // 2)."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Memory encoder
# ---------------------------------------------------------------------------


def memory_encoder_forward(p, feat_16: torch.Tensor, mask_hi: torch.Tensor):
    """feat_16 (1, H16, W16, d_model) raw backbone feature; mask_hi (1, H, W,
    1) the mask probabilities, already scaled and biased. Returns (mem (1,
    H16, W16, mem_dim), pos (H16, W16, mem_dim))."""
    x = S._conv2d(p["pix_feat_proj"], feat_16)
    m = mask_hi
    for conv, ln in p["downsampler"]:
        m = F.gelu(S._layer_norm(ln, S._conv2d(conv, m, stride=2)), approximate="none")
    x = x + S._conv2d(p["down_out"], m)
    for blk in p["fuser"]:
        # CXBlock: depthwise 7x7, layernorm, pointwise 4x (linear), GELU,
        # pointwise back, gamma
        y = S._layer_norm(blk["norm"], S._conv2d(blk["dwconv"], x, groups=x.shape[-1]))
        y = S._linear(blk["pwconv2"], F.gelu(S._linear(blk["pwconv1"], y), approximate="none"))
        x = x + blk["gamma"] * y
    mem = S._conv2d(p["out_proj"], x)
    return mem, sine_pe_2d(mem.shape[1], mem.shape[2], mem.shape[3], device=mem.device)


# ---------------------------------------------------------------------------
# Memory attention
# ---------------------------------------------------------------------------


def _rope_attn(p, q_in, k_in, v_in, heads: int, q_rope, k_rope, bias=None) -> torch.Tensor:
    """RoPEAttention: project, rotate q and the first `n_rope` keys, attend.
    q_rope (cos, sin) for every query; k_rope (cos, sin, n_rope); bias
    additive logits broadcast over the queries, or None."""
    q, k, v = S._linear(p["q"], q_in), S._linear(p["k"], k_in), S._linear(p["v"], v_in)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // heads
    q = apply_rope(q.reshape(B, Nq, heads, hd).transpose(1, 2), *q_rope)
    k = k.reshape(B, Nk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Nk, heads, hd).transpose(1, 2)
    cos_k, sin_k, n_rope = k_rope
    if n_rope >= Nk:
        k = apply_rope(k, cos_k, sin_k)
    else:
        k = torch.cat([apply_rope(k[:, :, :n_rope], cos_k, sin_k), k[:, :, n_rope:]], dim=2)
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    out = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B, Nq, C)
    return S._linear(p["out"], out)


def memory_attention_forward(p, vcfg: VideoConfig, tokens, tok_pe, mem_tokens, mem_pos, mem_bias,
                             hw: Tuple[int, int], n_spatial: int) -> torch.Tensor:
    """tokens (1, N, d) the current frame's 1/16 features; tok_pe (N, d) its
    sine code; mem_tokens / mem_pos (1, M, mem_dim) the fixed-capacity bank;
    mem_bias (M,) 0 for a live slot, -1e9 for an empty one; the first
    `n_spatial` memory tokens are spatial (RoPE, repeated per memory frame),
    the pointer tokens after them are not rotated."""
    h, w = hw
    heads = vcfg.mem_heads
    hd = tokens.shape[-1] // heads
    cos_q, sin_q = axial_rope_freqs(h, w, hd, vcfg.rope_theta, device=tokens.device)
    n_rep = max(n_spatial // (h * w), 1)
    cos_k, sin_k = cos_q.repeat(n_rep, 1), sin_q.repeat(n_rep, 1)
    bias = mem_bias[None, None, None, :]
    x = tokens + 0.1 * tok_pe[None]  # pos_enc_at_input
    for layer in p["layers"]:
        xn = S._layer_norm(layer["norm1"], x)
        x = x + _rope_attn(layer["self_attn"], xn, xn, xn, heads, (cos_q, sin_q),
                           (cos_q, sin_q, xn.shape[1]))
        # cross-attention into the memory: the code on the keys, not the queries
        xn = S._layer_norm(layer["norm2"], x)
        x = x + _rope_attn(layer["cross_attn"], xn, mem_tokens + mem_pos, mem_tokens, heads,
                           (cos_q, sin_q), (cos_k, sin_k, n_spatial), bias=bias)
        xn = S._layer_norm(layer["norm3"], x)
        x = x + S._linear(layer["linear2"], F.relu(S._linear(layer["linear1"], xn)))
    return S._layer_norm(p["norm"], x)


# ---------------------------------------------------------------------------
# Object pointers
# ---------------------------------------------------------------------------


def obj_ptr_from_tokens(p, tokens_f: torch.Tensor, best_mask_idx: int, obj_score_logit):
    """The pointer MLP on the selected mask token's state, blended with
    `no_obj_ptr` by the hard object-present indicator (fixed_no_obj_ptr,
    soft_no_obj_ptr off). tokens_f (1, n_tok, d) -> (1, d)."""
    ptr = S._head_mlp(p["obj_ptr_proj"], tokens_f[:, 2 + best_mask_idx])
    lam = (obj_score_logit > 0).to(ptr.dtype)
    return lam * ptr + (1.0 - lam) * p["no_obj_ptr"][None]


def obj_score_from_tokens(p, tokens_f: torch.Tensor) -> torch.Tensor:
    return S._head_mlp(p["obj_score_head"], tokens_f[:, 0])[:, 0]  # (1,)


# ---------------------------------------------------------------------------
# The per-frame step (fixed shapes whatever the bank holds)
# ---------------------------------------------------------------------------


def _condition_and_decode(params, vparams, cfg: S.SAM2Config, vcfg: VideoConfig, fpn2_raw, hr0,
                          hr1, mem_feat, mem_pos, mem_valid, mem_tpos, obj_ptrs, ptr_valid,
                          points01, labels, is_cond: bool, multimask: bool):
    """Condition the current features on the memory (the no-memory embedding
    on the conditioning frame), decode the mask, select the output token,
    compute the object score and pointer and encode the new memory.

    mem_feat / mem_pos (num_maskmem, hw16, mem_dim), mem_valid
    (num_maskmem,) bool, mem_tpos (num_maskmem,) the index into
    maskmem_tpos_enc of each slot, obj_ptrs (max_obj_ptrs, d), ptr_valid
    (max_obj_ptrs,) bool. Returns (mask_lo (1, H4, W4) logits, obj_score
    (1,), ptr (d,), new_mem (hw16, mem_dim), new_mem_pos (hw16, mem_dim))."""
    _, H16, W16, d = fpn2_raw.shape
    hw16, md = H16 * W16, vcfg.mem_dim
    if is_cond:
        img_emb = fpn2_raw + params["no_mem_embed"]
    else:
        tok_pe = sine_pe_2d(H16, W16, d, device=fpn2_raw.device).reshape(hw16, d)
        spatial = mem_feat.reshape(1, -1, md)
        # temporal embedding by distance from the current frame, not by slot
        tpos_enc = vparams["maskmem_tpos_enc"][mem_tpos][:, None, :]
        spatial_pos = (mem_pos + tpos_enc).reshape(1, -1, md)
        n_split = d // md  # each d-wide pointer is d / mem_dim tokens
        ptr_tok = obj_ptrs.reshape(1, -1, md)
        mem_tokens = torch.cat([spatial, ptr_tok], dim=1)
        mem_pe = torch.cat([spatial_pos, torch.zeros_like(ptr_tok)], dim=1)
        bias = torch.cat([
            torch.where(mem_valid.repeat_interleave(hw16), 0.0, -1e9),
            torch.where(ptr_valid.repeat_interleave(n_split), 0.0, -1e9),
        ])
        # an empty bank would softmax over -1e9 alone: attend to every slot
        if not bool(mem_valid.any() | ptr_valid.any()):
            bias = torch.zeros_like(bias)
        img_emb = memory_attention_forward(
            vparams["mem_attn"], vcfg, fpn2_raw.reshape(1, hw16, d), tok_pe, mem_tokens, mem_pe,
            bias, (H16, W16), spatial.shape[1]).reshape(1, H16, W16, d)

    pe = S.dense_pe(params["prompt"], (H16, W16))
    sparse = S.encode_points(params["prompt"], cfg, points01, labels)
    src = img_emb + params["prompt"]["no_mask_embed"]
    masks, iou, tokens_f = S.mask_decoder(params["dec"], cfg, src, pe, sparse, [hr0, hr1])
    # multimask (tokens 1..3, best IoU) on a prompted frame, token 0 otherwise
    best_idx = 1 + int(torch.argmax(iou[0, 1:])) if multimask else 0
    mask_lo = masks[:, best_idx]
    obj_score = obj_score_from_tokens(vparams, tokens_f)
    ptr = obj_ptr_from_tokens(vparams, tokens_f, best_idx, obj_score[0])

    # the memory encoder's input: the mask at full resolution, sigmoid,
    # scaled and biased
    S_img = cfg.img_size
    mask_hi = S.resize(mask_lo, (S_img, S_img), "bilinear")
    mask_mem = torch.sigmoid(mask_hi) * vcfg.sigmoid_scale + vcfg.sigmoid_bias
    new_mem, new_mem_pos = memory_encoder_forward(vparams["mem_enc"], fpn2_raw, mask_mem[..., None])
    return mask_lo, obj_score, ptr[0], new_mem.reshape(hw16, md), new_mem_pos.reshape(hw16, md)


# ---------------------------------------------------------------------------
# Predictor (the official video predictor's API as the reference drives it)
# ---------------------------------------------------------------------------


class Sam2VideoPredictor:
    """The official `SAM2VideoPredictor` surface the reference drives:
    `init_state` / `add_new_points` / `propagate_in_video`, one object
    (obj_id 1); images (H, W, 3) float in [0, 1] or uint8."""

    def __init__(self, params, vparams, cfg: S.SAM2Config = S.SAM2_BASE_PLUS,
                 vcfg: VideoConfig = VIDEO_BASE_PLUS):
        self.params = params
        self.vparams = vparams
        self.cfg = cfg
        self.vcfg = vcfg

    def _image(self, im) -> torch.Tensor:
        a = np.asarray(im)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        S_img = self.cfg.img_size
        if a.shape[:2] != (S_img, S_img):
            import cv2

            a = cv2.resize(a, (S_img, S_img), interpolation=cv2.INTER_AREA)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(
            S._device_of(self.params))

    def init_state(self, images) -> dict:
        images = list(images)
        S_img = self.cfg.img_size
        native_hw = (int(np.shape(images[0])[0]), int(np.shape(images[0])[1])) if images else None
        hw16 = (S_img // 16) ** 2
        v, dev = self.vcfg, S._device_of(self.params)
        return {
            "images": [self._image(im) for im in images],
            "prompts": {},  # frame_idx -> (points in native pixels, labels)
            "obj_ids": [1],
            # the native (H, W) of the video: prompts are given in its pixels
            "video_hw": native_hw or (S_img, S_img),
            # the fixed-capacity memory bank
            "mem_feat": torch.zeros((v.num_maskmem, hw16, v.mem_dim), device=dev),
            "mem_pos": torch.zeros((v.num_maskmem, hw16, v.mem_dim), device=dev),
            "mem_valid": np.zeros((v.num_maskmem,), bool),
            "mem_frame": np.full((v.num_maskmem,), -1),  # the frame each slot holds
            "obj_ptrs": torch.zeros((v.max_obj_ptrs, self.cfg.d_model), device=dev),
            "ptr_valid": np.zeros((v.max_obj_ptrs,), bool),
            "ptr_frame": np.full((v.max_obj_ptrs,), -1),
        }

    def add_new_points(self, state, frame_idx, obj_id, points, labels):
        """points (1, N, 2) in pixels of the video's native resolution, as
        the official API; labels (1, N)."""
        pts = np.asarray(points, np.float32).reshape(1, -1, 2)
        lbs = np.asarray(labels, np.int64).reshape(1, -1)
        state["prompts"][int(frame_idx)] = (pts, lbs)

    def _bank_views(self, state, t: int, cond_idx: int):
        """The memories frame t reads: the conditioning slot always, the
        other slots holding earlier frames. Each slot's temporal embedding
        index comes from its stored frame id (slots are written round-robin):
        the most recent earlier frame 0, farther ones t_rel - 1, the
        conditioning frame num_maskmem - 1."""
        nm = self.vcfg.num_maskmem
        rel = t - state["mem_frame"]
        tpos = np.clip(rel - 1, 0, max(nm - 2, 0))
        tpos = np.where(state["mem_frame"] == cond_idx, nm - 1, tpos)
        dev = state["mem_feat"].device
        mem_valid = ((state["mem_valid"] & (state["mem_frame"] < t))
                     | (state["mem_frame"] == cond_idx))
        return (state["mem_feat"], state["mem_pos"], torch.from_numpy(mem_valid).to(dev),
                torch.from_numpy(tpos.astype(np.int64)).to(dev), state["obj_ptrs"],
                torch.from_numpy(state["ptr_valid"] & (state["ptr_frame"] < t)).to(dev))

    def propagate_in_video(self, state, start_frame_idx: int = 0):
        """Yields (frame_idx, obj_ids, mask_logits (1, H4, W4)) for each frame
        from `start_frame_idx`, each conditioned on the bank so far."""
        v = self.vcfg
        S_img = self.cfg.img_size
        dev = S._device_of(self.params)
        cond_idx = min(state["prompts"]) if state["prompts"] else start_frame_idx
        for t in range(start_frame_idx, len(state["images"])):
            fpn2, hr0, hr1 = S.encode_features(self.params, self.cfg, state["images"][t])
            if t in state["prompts"]:
                pts, lbs = state["prompts"][t]
                nh, nw = state.get("video_hw", (S_img, S_img))
                pts01 = pts / np.asarray([float(nw), float(nh)], np.float32)
                multimask = True
            else:
                pts01 = np.zeros((1, 1, 2), np.float32)
                lbs = -np.ones((1, 1), np.int64)
                multimask = False
            is_cond = t == cond_idx
            mask_lo, obj_score, ptr, new_mem, new_mem_pos = _condition_and_decode(
                self.params, self.vparams, self.cfg, v, fpn2, hr0, hr1,
                *self._bank_views(state, t, cond_idx),
                torch.from_numpy(pts01).to(dev), torch.from_numpy(lbs).to(dev),
                is_cond=is_cond, multimask=multimask)
            # the conditioning frame owns slot 0; the others rotate through
            # slots 1..num_maskmem-1
            slot = 0 if is_cond else 1 + (t % max(v.num_maskmem - 1, 1))
            state["mem_feat"][slot] = new_mem
            state["mem_pos"][slot] = new_mem_pos
            state["mem_valid"][slot] = True
            state["mem_frame"][slot] = t
            pslot = t % v.max_obj_ptrs
            state["obj_ptrs"][pslot] = ptr
            state["ptr_valid"][pslot] = True
            state["ptr_frame"][pslot] = t
            yield t, list(state["obj_ids"]), mask_lo


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_video_params(gen: torch.Generator, cfg: S.SAM2Config = S.SAM2_BASE_PLUS,
                      vcfg: VideoConfig = VIDEO_BASE_PLUS, device=None):
    """Random memory-module weights of the reference's layout and scale,
    drawn from `gen` on `device` (the generator's by default)."""
    device = gen.device if device is None else device
    d, md = cfg.d_model, vcfg.mem_dim
    downsampler, ci = [], 1
    for _ in range(4):  # stride 2, four layers to 1/16
        downsampler.append((S._cv_p(gen, 3, 3, ci, ci * 4, device), S._ln_p(ci * 4, device)))
        ci *= 4

    def cx_block():
        return {"dwconv": S._cv_p(gen, 7, 7, 1, d, device), "norm": S._ln_p(d, device),
                "pwconv1": S._lin_p(gen, d, 4 * d, device),
                "pwconv2": S._lin_p(gen, 4 * d, d, device),
                "gamma": torch.full((d,), 1e-6, device=device)}

    def mem_layer():
        return {"self_attn": S._attn_p(gen, d, device), "norm1": S._ln_p(d, device),
                "cross_attn": S._attn_p(gen, d, device, kv_c=md), "norm2": S._ln_p(d, device),
                "linear1": S._lin_p(gen, d, vcfg.mem_mlp, device),
                "linear2": S._lin_p(gen, vcfg.mem_mlp, d, device), "norm3": S._ln_p(d, device)}

    return {
        "mem_enc": {"pix_feat_proj": S._cv_p(gen, 1, 1, d, d, device),
                    "downsampler": downsampler,
                    "down_out": S._cv_p(gen, 1, 1, ci, d, device),
                    "fuser": [cx_block() for _ in range(2)],
                    "out_proj": S._cv_p(gen, 1, 1, d, md, device)},
        "mem_attn": {"layers": [mem_layer() for _ in range(vcfg.mem_layers)],
                     "norm": S._ln_p(d, device)},
        "obj_ptr_proj": [S._lin_p(gen, d, d, device) for _ in range(3)],
        "obj_score_head": [S._lin_p(gen, d, d, device), S._lin_p(gen, d, d, device),
                           S._lin_p(gen, d, 1, device)],
        "no_obj_ptr": S._small(gen, (d,), device),
        "maskmem_tpos_enc": S._small(gen, (vcfg.num_maskmem, md), device),
    }


def video_params_from_numpy(tree, device="cpu"):
    """The reference's video parameter tree with numpy leaves -> the port's
    (the same layout; the downsampler's (conv, norm) pairs stay pairs)."""
    return S.sam2_params_from_numpy(tree, device)


def video_params_from_torch(path: str, cfg: S.SAM2Config = S.SAM2_BASE_PLUS,
                            vcfg: VideoConfig = VIDEO_BASE_PLUS, device="cpu"):
    """An official SAM2 checkpoint -> (image parameters, memory-module
    parameters) on `device`, as the reference converts it. The file is
    unpickled in full: load only trusted checkpoints."""
    r = S._Reader(S._load_state_dict(path, device))
    sd = r.sd
    me, ma = "memory_encoder", "memory_attention"
    downsampler = [(r.cv(f"{me}.mask_downsampler.encoder.{3 * i}"),
                    r.ln(f"{me}.mask_downsampler.encoder.{3 * i + 1}")) for i in range(4)]
    fuser = [{"dwconv": r.cv(f"{me}.fuser.layers.{i}.dwconv"),
              "norm": r.ln(f"{me}.fuser.layers.{i}.norm"),
              "pwconv1": r.lin(f"{me}.fuser.layers.{i}.pwconv1"),
              "pwconv2": r.lin(f"{me}.fuser.layers.{i}.pwconv2"),
              "gamma": sd[f"{me}.fuser.layers.{i}.gamma"]} for i in range(2)]
    layers = [{"self_attn": r.attn(f"{ma}.layers.{i}.self_attn"),
               "norm1": r.ln(f"{ma}.layers.{i}.norm1"),
               "cross_attn": r.attn(f"{ma}.layers.{i}.cross_attn_image"),
               "norm2": r.ln(f"{ma}.layers.{i}.norm2"),
               "linear1": r.lin(f"{ma}.layers.{i}.linear1"),
               "linear2": r.lin(f"{ma}.layers.{i}.linear2"),
               "norm3": r.ln(f"{ma}.layers.{i}.norm3")} for i in range(vcfg.mem_layers)]
    vparams = {
        "mem_enc": {"pix_feat_proj": r.cv(f"{me}.pix_feat_proj"), "downsampler": downsampler,
                    "down_out": r.cv(f"{me}.mask_downsampler.encoder.12"), "fuser": fuser,
                    "out_proj": r.cv(f"{me}.out_proj")},
        "mem_attn": {"layers": layers, "norm": r.ln(f"{ma}.norm")},
        "obj_ptr_proj": [r.lin(f"obj_ptr_proj.layers.{j}") for j in range(3)],
        "obj_score_head": [r.lin(f"sam_mask_decoder.pred_obj_score_head.layers.{j}")
                           for j in range(3)],
        "no_obj_ptr": sd["no_obj_ptr"].reshape(-1),
        # (num_maskmem, 1, 1, mem_dim) in the checkpoint
        "maskmem_tpos_enc": sd["maskmem_tpos_enc"].reshape(vcfg.num_maskmem, vcfg.mem_dim),
    }
    return S._image_params(r, cfg), vparams


# ---------------------------------------------------------------------------
# SLAM refiner (dynamic.mask.set_mask_refiner): a one-frame video per frame
# ---------------------------------------------------------------------------


class Sam2VideoRefiner:
    """Mask refiner that drives the video predictor as the reference does:
    a one-frame video per SLAM frame, point prompts at the centroids of the
    raw mask's connected components, the frame's mask replacing the
    flow-error mask. With `carry_memory` the memory bank persists across
    SLAM frames instead of starting anew.

    `calls` and `replaced` count the calls and the masks it returned in
    place of the raw one."""

    def __init__(self, params, vparams, cfg: S.SAM2Config = S.SAM2_BASE_PLUS,
                 vcfg: VideoConfig = VIDEO_BASE_PLUS, carry_memory: bool = False,
                 min_area: int = 20):
        self.pred = Sam2VideoPredictor(params, vparams, cfg, vcfg)
        self.carry_memory = carry_memory
        self.min_area = min_area
        self._state = None
        self.calls = self.replaced = 0

    def reset(self):
        self._state = None

    def __call__(self, img_u8, err_norm, raw_mask, threshold, min_area):
        import cv2

        from monst3r_slam_torch.dynamic.mask import connected_component_centroids

        self.calls += 1
        h, w = raw_mask.shape
        pts = connected_component_centroids(raw_mask, max(min_area, self.min_area))
        if not pts:
            return raw_mask
        S_img = self.pred.cfg.img_size
        img = cv2.resize(np.asarray(img_u8[..., :3], np.uint8), (S_img, S_img),
                         interpolation=cv2.INTER_AREA)
        pts_s = np.asarray([[(x / w * S_img, y / h * S_img) for (x, y) in pts]], np.float32)
        labels = np.ones((1, len(pts)), np.int64)
        if self.carry_memory and self._state is not None:
            state = self._state
            state["images"].append(self.pred._image(img))
            t = len(state["images"]) - 1
            state["prompts"][t] = (pts_s, labels)
        else:
            state = self.pred.init_state([img])
            self.pred.add_new_points(state, 0, 1, pts_s, labels)
            t = 0
        mask = None
        for fi, obj_ids, logits in self.pred.propagate_in_video(state, t):
            if fi == t and 1 in obj_ids:
                mask = (logits[0] > 0.0).cpu().numpy()
                break
        if self.carry_memory:
            # later frames read only the bank: drop the consumed image
            state["images"][t] = None
            self._state = state
        if mask is None:
            return raw_mask
        self.replaced += 1
        return cv2.resize(mask.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
