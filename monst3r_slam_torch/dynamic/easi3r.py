"""Easi3R-style attention-based dynamic handling (training-free).

Port of the JAX package's `dynamic/easi3r.py`. Dynamic regions receive
anomalous cross-view attention in DUSt3R-style decoders (Easi3R, Chen et al.
2025), so a second inference that re-weights the cross-attention suppresses
them:

  1. The first decoder pass collects, per memory token, the cross-attention
     mass it receives from the other view, averaged over layers and heads.
  2. Tokens whose received attention is anomalously low (the other view
     cannot ground them: typical of moving objects) form a patch-level
     dynamic mask by median/MAD thresholding.
  3. The second pass adds a log-bias that suppresses the masked memory
     tokens; its pointmaps are returned with per-pixel dynamic masks (the
     patch mask repeated over each patch).

Plain PyTorch: the decoder layers run in a Python loop, the explicit-logits
cross-attention is `blocks.cross_attention`'s biased branch, and every
self-attention goes through `sdpa` (kernel A on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monst3r_slam_torch.models import blocks, heads
from monst3r_slam_torch.models.config import ModelConfig


def _decode_pair_attn(params, cfg: ModelConfig, feat1, pos1, feat2, pos2,
                      bias1=None, bias2=None, dtype=torch.bfloat16):
    """`croco.decode_pair` that also sums the cross-attention column sums
    over the layers and takes per-memory-token log-biases (`bias1` applies
    to stream 1's memory, the view-2 tokens; `bias2` to the view-1 tokens).
    Returns (dec1, dec2, attn1, attn2): the DPT hook activations of each
    stream in f32, and the received attention of the view-1 and view-2
    tokens, normalized so that a token's expected share is 1."""
    x1 = blocks.linear(params["decoder_embed"], feat1.to(dtype))
    x2 = blocks.linear(params["decoder_embed"], feat2.to(dtype))
    B, N1 = feat1.shape[:2]
    N2 = feat2.shape[1]
    acc1 = torch.zeros((B, N1), device=feat1.device)
    acc2 = torch.zeros((B, N2), device=feat2.device)
    h1, h2, h3 = cfg.hooks[1], cfg.hooks[2], cfg.hooks[3]
    outs1, outs2 = {}, {}
    for depth, (p1, p2) in enumerate(zip(params["dec_blocks"], params["dec_blocks2"]), 1):
        n1, cs2 = blocks.decoder_block(p1, x1, x2, pos1, pos2, cfg.dec_heads, cfg.rope_freq,
                                       cfg.ln_eps, mem_bias=bias1, return_attn_colsum=True)
        n2, cs1 = blocks.decoder_block(p2, x2, x1, pos2, pos1, cfg.dec_heads, cfg.rope_freq,
                                       cfg.ln_eps, mem_bias=bias2, return_attn_colsum=True)
        x1, x2 = n1, n2
        acc1, acc2 = acc1 + cs1, acc2 + cs2
        if depth in (h1, h2, h3):
            outs1[depth], outs2[depth] = x1, x2
    final1 = blocks.layernorm(params["dec_norm"], outs1[h3], cfg.ln_eps)
    final2 = blocks.layernorm(params["dec_norm"], outs2[h3], cfg.ln_eps)
    dec1 = tuple(t.float() for t in (feat1, outs1[h1], outs1[h2], final1))
    dec2 = tuple(t.float() for t in (feat2, outs2[h1], outs2[h2], final2))
    # each query row sums to 1, so a token's expected share per layer is Nq/Nk
    attn1 = acc1 / cfg.dec_depth / (N2 / N1)
    attn2 = acc2 / cfg.dec_depth / (N1 / N2)
    return dec1, dec2, attn1, attn2


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keeping it, by the reference's midpoint
    rule: half the sum of the two middle values of an even count
    (`torch.median` would return the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2 : (n - 1) // 2 + 1] + s[..., n // 2 : n // 2 + 1]) * 0.5


def attention_dynamic_mask(attn: torch.Tensor, k_mad: float = 2.0) -> torch.Tensor:
    """Patch-level dynamic mask (B, N) bool from the received attention
    (B, N): tokens under median - k_mad * MAD."""
    med = _median(attn)
    mad = _median(torch.abs(attn - med))
    return attn < (med - k_mad * torch.clamp(mad, min=1e-6))


class Easi3ROutput(NamedTuple):
    X1: torch.Tensor
    C1: torch.Tensor
    X2: torch.Tensor
    C2: torch.Tensor
    dyn_mask1: torch.Tensor  # (B, H, W) bool: per-pixel dynamic mask, view 1
    dyn_mask2: torch.Tensor


@torch.no_grad()
def easi3r_double_inference_pair(params, cfg: ModelConfig, feat1, pos1, feat2, pos2, shape,
                                 k_mad: float = 2.0, dtype=torch.bfloat16) -> Easi3ROutput:
    """Two-pass Easi3R inference on a DUSt3R-architecture model: pass 1
    gives the attention statistics and the patch masks, pass 2 re-weights
    the cross-attention against the masked tokens (a finite -10 log-bias, so
    a fully masked row stays defined) and gives the pointmaps. The decoder
    computes in `dtype` (the reference's: bf16), the heads in f32."""
    h, w = shape
    p = cfg.patch_size
    n_h, n_w = h // p, w // p
    _, _, attn1, attn2 = _decode_pair_attn(params, cfg, feat1, pos1, feat2, pos2, dtype=dtype)
    mask1 = attention_dynamic_mask(attn1, k_mad)  # (B, N1): view-1 tokens
    mask2 = attention_dynamic_mask(attn2, k_mad)
    bias1 = torch.where(mask2, -10.0, 0.0)  # stream 1's memory is view 2
    bias2 = torch.where(mask1, -10.0, 0.0)
    dec1, dec2, _, _ = _decode_pair_attn(params, cfg, feat1, pos1, feat2, pos2,
                                         bias1=bias1, bias2=bias2, dtype=dtype)
    out1 = heads.head_forward(params["head1"], cfg, dec1, n_h, n_w)
    out2 = heads.head_forward(params["head2"], cfg, dec2, n_h, n_w)

    def upsample(mask):
        m = mask.reshape(mask.shape[0], n_h, n_w)
        return m.repeat_interleave(p, dim=1).repeat_interleave(p, dim=2)

    return Easi3ROutput(out1.pts3d, out1.conf, out2.pts3d, out2.conf,
                        upsample(mask1), upsample(mask2))
