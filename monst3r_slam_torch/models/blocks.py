"""Transformer primitives: layernorm, MLP, self/cross attention with RoPE2D.

Port of the JAX package's `models/blocks.py`. Parameters are plain dicts of
tensors; linear weights are stored torch-style, (out, in), and applied with
`F.linear` (`models/convert.py` transposes the JAX (in, out) layout).
Layernorm runs in float32 whatever the compute type; GELU is the exact (erf)
variant. In bf16 the products, bias additions and GELU steps round where the
reference's bf16 program rounds them. Tokens are (B, N, D), heads (B, H, N, hd).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from monst3r_slam_torch.models.rope import apply_rope2d
from monst3r_slam_torch.ops.attention import sdpa


def linear(p, x: torch.Tensor) -> torch.Tensor:
    b = p.get("b")
    if b is None or x.dtype == torch.float32:
        return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))
    # In bf16 the reference rounds the product to bf16 before it adds the bias.
    return F.linear(x, p["w"].to(x.dtype)) + b.to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], p["w"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU. In bf16 each step of the reference's formula,
    0.5 x erfc(-x sqrt(1/2)), is rounded to bf16, as the reference rounds it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    sqrt_half = float(torch.tensor(0.5**0.5, dtype=x.dtype))
    return 0.5 * x * torch.special.erfc(x * -sqrt_half)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def _heads_split(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _heads_merge(x: torch.Tensor) -> torch.Tensor:
    """A view for kernel A's output, the (B, H, N, hd) view of a (B, N, H, hd)
    buffer; a copy for the plain version's contiguous (B, H, N, hd)."""
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


def self_attention(p, x: torch.Tensor, pos: torch.Tensor, n_heads: int,
                   rope_freq: Optional[float]) -> torch.Tensor:
    """Fused-QKV self attention with RoPE2D on q and k."""
    q, k, v = (_heads_split(t, n_heads) for t in linear(p["qkv"], x).chunk(3, dim=-1))
    if rope_freq is not None:
        q = apply_rope2d(q, pos, rope_freq)
        k = apply_rope2d(k, pos, rope_freq)
    return linear(p["proj"], _heads_merge(sdpa(q, k, v)))


def cross_attention(p, x: torch.Tensor, mem: torch.Tensor, xpos: torch.Tensor,
                    mpos: torch.Tensor, n_heads: int, rope_freq: Optional[float],
                    mem_bias: Optional[torch.Tensor] = None, return_attn_colsum: bool = False):
    """Separate q/k/v projections; queries from x, keys/values from mem.

    `mem_bias` (B, Nk) is added to every query's logits (Easi3R's
    re-weighting of dynamic memory tokens). `return_attn_colsum` also
    returns the attention mass each memory token receives, summed over the
    queries and averaged over the heads, (B, Nk) in f32. Either one takes
    the explicit-logits branch, plain PyTorch as in the reference (which
    computes it outside its attention kernel): f32 logits from q and k, the
    bias and the softmax in f32, the probabilities cast to q's type before
    the product with v. Without them the call goes to `sdpa` (kernel A)."""
    q = _heads_split(linear(p["q"], x), n_heads)
    k = _heads_split(linear(p["k"], mem), n_heads)
    v = _heads_split(linear(p["v"], mem), n_heads)
    if rope_freq is not None:
        q = apply_rope2d(q, xpos, rope_freq)
        k = apply_rope2d(k, mpos, rope_freq)
    if mem_bias is None and not return_attn_colsum:
        return linear(p["proj"], _heads_merge(sdpa(q, k, v)))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mem_bias is not None:
        logits = logits + mem_bias[:, None, None, :].float()
    probs = torch.softmax(logits, dim=-1)
    del logits
    y = linear(p["proj"], _heads_merge(torch.matmul(probs.to(q.dtype), v)))
    if return_attn_colsum:
        return y, probs.sum(dim=(1, 2)) / probs.shape[1]
    return y


def encoder_block(p, x, pos, n_heads: int, rope_freq: float, eps: float) -> torch.Tensor:
    """Pre-LN ViT block."""
    x = x + self_attention(p["attn"], layernorm(p["norm1"], x, eps), pos, n_heads, rope_freq)
    return x + mlp(p["mlp"], layernorm(p["norm2"], x, eps))


def decoder_block(p, x, y, xpos, ypos, n_heads: int, rope_freq: float, eps: float,
                  mem_bias: Optional[torch.Tensor] = None, return_attn_colsum: bool = False):
    """Self-attn + cross-attn (memory normalized by `norm_y`) + MLP block;
    `mem_bias` and `return_attn_colsum` go to the cross-attention, and with
    the latter the block returns (x, colsum)."""
    x = x + self_attention(p["attn"], layernorm(p["norm1"], x, eps), xpos, n_heads, rope_freq)
    y_n = layernorm(p["norm_y"], y, eps)
    ca = cross_attention(
        p["cross"], layernorm(p["norm2"], x, eps), y_n, xpos, ypos, n_heads, rope_freq,
        mem_bias=mem_bias, return_attn_colsum=return_attn_colsum,
    )
    if return_attn_colsum:
        ca, colsum = ca
    x = x + ca
    x = x + mlp(p["mlp"], layernorm(p["norm3"], x, eps))
    return (x, colsum) if return_attn_colsum else x
