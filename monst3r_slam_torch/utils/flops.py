"""Analytic FLOP counts for the CroCo encoder/decoder/heads, and the card's
peak.

Port of the JAX package's `utils/flops.py`, with the same counts:
matmul-dominant terms only (layernorms and activations are bandwidth, not
FLOPs); 1 MAC = 2 FLOPs. The peak table names NVIDIA cards only.
"""

from __future__ import annotations

import torch


def _block_flops(tok: int, d: int, kv_tok: int | None = None,
                 kv_d: int | None = None, mlp_ratio: int = 4) -> float:
    """One transformer block: qkv+proj (self) + mlp; with kv_tok set, adds a
    cross-attention (q from tok/d, kv from kv_tok/kv_d projected to d)."""
    f = 0.0
    # self-attention: qkv (3d^2/tok) + proj (d^2) + scores/values (2*tok*d)
    f += 2 * tok * (4 * d * d) + 2 * 2 * tok * tok * d
    # mlp
    f += 2 * tok * (2 * mlp_ratio * d * d)
    if kv_tok is not None:
        kd = kv_d if kv_d is not None else d
        # cross: q (d^2), k/v (kd*d each), proj (d^2), scores/values
        f += 2 * tok * (2 * d * d) + 2 * kv_tok * (2 * kd * d)
        f += 2 * 2 * tok * kv_tok * d
    return f


def encode_flops(cfg, h: int, w: int) -> float:
    tok = (h // cfg.patch_size) * (w // cfg.patch_size)
    # patch embed: conv P*P*3 -> enc_dim over tok patches
    f = 2 * tok * (cfg.patch_size**2 * 3) * cfg.enc_dim
    f += cfg.enc_depth * _block_flops(tok, cfg.enc_dim)
    return f


def decode_flops(cfg, h: int, w: int) -> float:
    """Dual cross-attention decoder (both streams) + DPT + catMLP heads."""
    tok = (h // cfg.patch_size) * (w // cfg.patch_size)
    d = cfg.dec_dim
    f = 2 * 2 * tok * cfg.enc_dim * d  # decoder_embed, both streams
    f += 2 * cfg.dec_depth * _block_flops(tok, d, kv_tok=tok, kv_d=d)
    # DPT head (both streams): 4 hook projections to layer_dims + refinenet
    # conv pyramid; dominated by the fusion convs at 1/8..1/1 resolutions.
    ld = getattr(cfg, "layer_dims", (96, 192, 384, 768))
    feat = getattr(cfg, "feature_dim", 256)
    hook_f = sum(2 * tok * (d + cfg.enc_dim if i == 0 else d) * ld[i]
                 for i in range(4))
    # per-level: 3x3 conv ld->feat at tok, then 2x (3x3 feat->feat) at each
    # pyramid level; approximate with the dominant full-res conv stack
    pyr_f = 0.0
    for lvl, scale in enumerate((4, 8, 16, 32)):
        hw_l = (h // scale) * (w // scale) * 16  # hooks upsampled
        pyr_f += 2 * hw_l * 9 * feat * feat * 2
    head_f = hook_f + pyr_f
    # final head convs at h/2 x w/2 and h x w
    head_f += 2 * (h // 2) * (w // 2) * 9 * feat * (feat // 2)
    head_f += 2 * h * w * (feat // 2) * 32 * 2
    f += 2 * head_f  # both streams
    if cfg.desc_dim is not None:
        hidden = 4 * (d + cfg.enc_dim)
        out = (cfg.desc_dim + 1) * cfg.patch_size**2
        f += 2 * 2 * tok * ((d + cfg.enc_dim) * hidden + hidden * out)
    return f


# Dense bf16 tensor-core peak FLOP/s per card, from NVIDIA's data sheets,
# keyed by a substring of the lower-cased device name. "H100 80GB HBM3" is
# the SXM part's name.
_PEAKS = {
    "h100 80gb hbm3": 989e12,
    "h100 sxm": 989e12,
}


def chip_peak_flops(device=0) -> float:
    """bf16 peak of a CUDA device, by name. Raises on a card not in the
    table and where there is no card: no peak is assumed."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a peak rate exists only for a card")
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAKS.items():
        if key in name.lower():
            return peak
    raise RuntimeError(f"no published bf16 peak for {name!r} in the table")


def mfu(flops_per_call: float, seconds_per_call: float,
        peak: float | None = None) -> dict:
    peak = peak or chip_peak_flops()
    achieved = flops_per_call / max(seconds_per_call, 1e-12)
    return {
        "tflops": round(achieved / 1e12, 2),
        "mfu_pct": round(100.0 * achieved / peak, 2),
        "ceiling_ms": round(1e3 * flops_per_call / peak, 3),
    }
