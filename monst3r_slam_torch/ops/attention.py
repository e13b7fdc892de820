"""Softmax attention: kernel A (`csrc/attention.cu`) and its plain version.

Port of the JAX package's `ops/attention.py`. `sdpa` is the dispatch every
bias-free attention of the encoder and decoder goes through: on a CUDA
tensor it launches kernel A (or raises), on a CPU tensor it runs the plain
version, which has the reference's semantics — f32 logits and softmax,
probabilities cast to v's type before the PV product, output in q's type.

Kernel A has two routes: bfloat16 inputs (every call of the model on the
card) go to the tensor-core kernel, float32 inputs (f32 models: training
in f32, the f32 checks against the CPU path) to the register-tiled kernel
on the FP32 pipe, which keeps logits, probabilities and output in f32.
Both read q, k and v through their strides and write the output into a
(B, N, H, 64) buffer, returned as its (B, H, N, 64) view, so that neither
the heads split before nor the merge after is a copy.

Kernel A has no backward, and neither has the reference's Pallas kernel
(training there differentiates its einsum attention). For training on the
card, `sdpa` wraps kernel A in an autograd Function whose backward is
`sdpa_backward_plain`: P recomputed from q and k, rounded where the
autograd of `sdpa_plain` rounds.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from monst3r_slam_torch.ops import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16_tc"}
_SIGNATURES = {"attn_forward": ([ctypes.c_char_p], ctypes.c_int)}
# One call's arguments as the C entry's `AttnArgs`: 4 pointers, the (batch,
# head, row, dim) strides of q, k, v and the output, the 5 sizes, the type
# and the stream, 27 int64 values in one buffer (one foreign argument).
_PACK = struct.Struct("=27q").pack


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, H, Nq, D), k/v (B, H, Nk, D) -> (B, H, Nq, D) in q's type."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def sdpa_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor) -> tuple:
    """(dq, dk, dv) of `sdpa_plain` at (q, k, v) for the output gradient
    `dout`, rounded where its autograd rounds: P = softmax(QK^T/sqrt(d))
    recomputed in f32, dP = dout V^T and dV = P^T dout in v's type, the
    softmax backward and the products with k and q in f32, dq and dk cast
    to their inputs' types. The operations are the autograd's own, so on
    one device the result equals it bit for bit."""
    scale = q.shape[-1] ** -0.5
    qf, kf = q.float(), k.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    dout = dout.to(v.dtype)
    dv = torch.matmul(probs.to(v.dtype).transpose(-1, -2), dout)
    dprobs = torch.matmul(dout, v.transpose(-1, -2)).float()
    dlogits = torch._softmax_backward_data(dprobs, probs, -1, torch.float32) * scale
    dq = torch.matmul(dlogits, kf).to(q.dtype)
    dk = torch.matmul(qf.transpose(-1, -2), dlogits).transpose(-1, -2).to(k.dtype)
    return dq, dk, dv


def error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error kernel A may show against `ref`, the plain version
    computed in f32 from the same inputs.

    f32 route: 2e-5, the summation-order tolerance of the CPU parity test.

    bf16 route: 2^-8 max|ref| + 2^-9 max S. The first term covers the
    rounding of the output to bf16 (at most 2^-9 of the value) and as much
    again for the f32 summation order and exp2; it alone sufficed while the
    probabilities stayed in f32. The kernel also rounds each probability to
    bf16 before the PV product, which adds sum_k d_k p_ik v_kj to output
    (i, j), with independent relative errors d_k uniform within +-2^-9: a
    spread of 2^-9 / sqrt(3) S_ij, where S_ij = sqrt(sum_k p_ik^2 v_kj^2).
    The second term allows sqrt(3) such spreads where S is largest. Logits
    rounded to bf16 instead of kept in f32 exceed the bound once the logits
    are large."""
    if q.dtype == torch.float32:
        return 2e-5
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    spread = torch.sqrt(p.square() @ v.float().square())
    return 2.0**-8 * float(ref.abs().max()) + 2.0**-9 * float(spread.max())


def backward_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor) -> tuple:
    """Per-element bounds on how far `sdpa_backward_plain` in q's type may
    lie from the f32 autograd of `sdpa_plain` on the same values:
    (bound on dq, on dk, on dv), f32 tensors.

    In bf16 the backward rounds P before dV = P^T dout, dP = dout V^T, and
    the outputs, each within 2^-9 of its value. dV's error is then within
    2^-9 |P|^T |dout| for P's rounding and as much for the output's. dP's
    rounding moves dS = P (dP - sum_k P dP) by at most 2^-9 P (|dP| +
    sum_k P |dP|), which the product with k (with q) carries into dq (dk),
    whose own rounding adds 2^-9 |dS| |k| at most. Each bound is twice its
    sum, which leaves as much again for the f32 summation order. f32
    inputs: 2^-20 of the same terms, for the summation order alone."""
    u = 2.0**-8 if q.dtype == torch.bfloat16 else 2.0**-20
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, dim=-1)
    dp = df @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds_terms = p * (dp.abs() + (p * dp.abs()).sum(-1, keepdim=True)) + ds.abs()
    return (u * scale * (ds_terms @ kf.abs()),
            u * scale * (ds_terms.transpose(-1, -2) @ qf.abs()),
            2 * u * (p.transpose(-1, -2) @ df.abs()))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel A on CUDA tensors q (B, H, Nq, 64), k/v (B, H, Nk, 64), of one
    type, float32 or bfloat16, read through their strides. The last
    dimension must be contiguous, every start 16-byte aligned and every
    other stride a multiple of 8 elements in bfloat16, of 4 in float32 (the
    kernel checks, and this raises on a layout it refuses). Returns (B, H,
    Nq, 64), the transposed view of a contiguous (B, Nq, H, 64) buffer."""
    dev = q.get_device()  # -1 for a CPU tensor
    if dev < 0 or k.get_device() != dev or v.get_device() != dev:
        raise ValueError("fused_attention takes CUDA tensors on one device")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"fused_attention takes float32 or bfloat16, got {dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"fused_attention takes (B, H, N, {HEAD_DIM}), got {tuple(q.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    out = torch.empty_strided((b, h, nq, d), (nq * h * d, d, h * d, 1), dtype=dtype,
                              device=q.device)
    args = _PACK(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride(),
                 *k.stride(), *v.stride(), *out.stride(), b, h, nq, nk, d, _DTYPES[dtype],
                 torch._C._cuda_getCurrentRawStream(dev))
    lib = build.load("attention", _SIGNATURES)
    with build.on_card(dev):
        err = lib.attn_forward(args)
    if err == 1000:
        raise ValueError(
            f"fused_attention cannot read this layout: strides {q.stride()}, {k.stride()}, "
            f"{v.stride()} (a multiple of {16 // q.element_size()} elements in {dtype}); starts "
            f"{q.data_ptr() % 16}, {k.data_ptr() % 16}, {v.data_ptr() % 16} bytes past 16-byte "
            "alignment")
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: error {err}")
    fused_attention.launches += 1
    fused_attention.route_launches[_ROUTES[dtype]] += 1
    return out


fused_attention.launches = 0  # every launch
fused_attention.route_launches = {"bf16_tc": 0, "f32": 0}  # launches per route


class KernelAttention(torch.autograd.Function):
    """Kernel A forward, `sdpa_backward_plain` backward. Saves q, k and v,
    not P: the backward recomputes P, never the forward's output."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_attention(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        return sdpa_backward_plain(*ctx.saved_tensors, dout)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel A for CUDA tensors, the plain version for CPU tensors. On the
    card a call that autograd records (grad enabled, an input that requires
    grad) goes through `KernelAttention`; every other call launches kernel
    A directly."""
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return KernelAttention.apply(q, k, v)
    return fused_attention(q, k, v)
