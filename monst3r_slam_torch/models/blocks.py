"""Transformer primitives: layernorm, MLP, self/cross attention with RoPE2D.

Port of the JAX package's `models/blocks.py`. Parameters are plain dicts of
tensors; linear weights are stored torch-style, (out, in), and applied with
`F.linear` (`models/convert.py` transposes the JAX (in, out) layout).
Layernorm runs in float32 whatever the compute type; GELU is the exact (erf)
variant. In bf16 the products, bias additions and GELU steps round where the
reference's bf16 program rounds them. Tokens are (B, N, D), heads (B, H, N, hd).

On weights placed by `parallel.mesh.shard_params` the same functions run
tensor parallel (the reference's GSPMD program on a dp x tp mesh, for one
dp row): a column-parallel `linear` (its weight a `Sharded` split on its
output dim) returns the list of its shards' outputs, each on its shard's
device; what follows up to the row-parallel `linear` runs on each shard
(`per_shard`: attention on its H/tp heads, GELU); the row-parallel
`linear` adds the shards' partial products on the first shard's device
and its bias once. Everything else runs once, on the row's first device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from monst3r_slam_torch.models.rope import apply_rope2d
from monst3r_slam_torch.ops.attention import sdpa
from monst3r_slam_torch.parallel.mesh import Sharded, sum_home


def linear(p, x):
    if isinstance(p["w"], Sharded):
        return _tp_linear(p, x)
    b = p.get("b")
    if b is None or x.dtype == torch.float32:
        return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))
    # In bf16 the reference rounds the product to bf16 before it adds the bias.
    return F.linear(x, p["w"].to(x.dtype)) + b.to(x.dtype)


def _tp_linear(p, x):
    """Column-parallel (the weight split on dim 0): `x` goes to each
    shard's device and the result is the list of shard outputs, the bias
    split with the weight. Row-parallel (split on dim 1): `x` is such a
    list; each shard's product without bias, in x's type (in bf16 rounded
    once, as `F.linear` rounds), is added over the shards in that type and
    in shard order (`sum_home`), then the bias once. In bf16 that rounds
    each partial and then each add: with tp 2 this equals one f32 sum of
    the rounded partials rounded once (a bf16 add rounds the exact sum),
    but not one `F.linear` of the whole weight."""
    w, b = p["w"], p.get("b")
    if w.dim == 0:
        bs = [None] * len(w.parts) if b is None else b.parts
        return [linear({"w": wt, "b": bt}, x.to(wt.device)) for wt, bt in zip(w.parts, bs)]
    y = sum_home([linear({"w": wt}, xt) for wt, xt in zip(w.parts, x)])
    return y if b is None else y + b.to(y.dtype)


def per_shard(fn, *xs):
    """`fn(*xs)`, or, where `xs` are column-parallel outputs (lists of shard
    tensors), the list of `fn` on each shard's tensors."""
    if isinstance(xs[0], list):
        return [fn(*t) for t in zip(*xs)]
    return fn(*xs)


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
    return linear(p["fc2"], per_shard(gelu, linear(p["fc1"], x)))


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
    """Fused-QKV self attention with RoPE2D on q and k (on a shard: its
    heads, whose q, k and v rows `shard_params` keeps together)."""
    hd = x.shape[-1] // n_heads

    def attend(qkv):
        q, k, v = (_heads_split(t, t.shape[-1] // hd) for t in qkv.chunk(3, dim=-1))
        if rope_freq is not None:
            q = apply_rope2d(q, pos.to(q.device), rope_freq)
            k = apply_rope2d(k, pos.to(k.device), rope_freq)
        return _heads_merge(sdpa(q, k, v))

    return linear(p["proj"], per_shard(attend, linear(p["qkv"], x)))


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
    the product with v; on unsharded weights only. Without them the call
    goes to `sdpa` (kernel A)."""
    hd = x.shape[-1] // n_heads

    def heads(q, k, v):
        q, k, v = (_heads_split(t, t.shape[-1] // hd) for t in (q, k, v))
        if rope_freq is not None:
            q = apply_rope2d(q, xpos.to(q.device), rope_freq)
            k = apply_rope2d(k, mpos.to(k.device), rope_freq)
        return q, k, v

    q, k, v = linear(p["q"], x), linear(p["k"], mem), linear(p["v"], mem)
    if mem_bias is None and not return_attn_colsum:
        return linear(p["proj"], per_shard(lambda *t: _heads_merge(sdpa(*heads(*t))), q, k, v))
    q, k, v = heads(q, k, v)
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
