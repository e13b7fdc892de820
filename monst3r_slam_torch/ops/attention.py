"""Softmax attention: kernel A (`csrc/attention.cu`) and its plain version.

Port of the JAX package's `ops/attention.py`. `sdpa` is the dispatch every
bias-free attention of the encoder and decoder goes through: on a CUDA
tensor it launches kernel A (or raises), on a CPU tensor it runs the plain
version, which has the reference's semantics — f32 logits and softmax,
probabilities cast to v's type before the PV product, output in q's type.

Kernel A has three routes (`route`): bfloat16 inputs (every call of the
model on the card) go to the bf16 tensor-core kernel; float32 inputs (f32
models: training in f32, the f32 checks against the CPU path) up to head
width 64 to the register-tiled kernel on the FP32 pipe, and above 64 to the
tensor-core kernel in 3xTF32; both f32 routes keep logits, probabilities
and output in f32. Every route reads q, k and v through their strides and
writes the output into a (B, N, H, d) buffer, returned as its (B, H, N, d)
view, so that neither the heads split before nor the merge after is a copy.

The bf16 route is instantiated at head widths 16, 32, 64, 128 and 256
(`HEAD_DIMS`), and above 256 runs its wide variant, which computes O in
column slices of 256 (`column_slices`); the FFMA route at 16, 32 and 64
(`F32_FFMA_DIMS`); the f32 tensor-core route above 64, also in slices of
256 columns above 256. A head runs on the narrowest instantiation that
holds it (`padded_width`), and every head whose rows a 16-byte copy
addresses, a width that is a multiple of 8 in bf16 and of 4 in f32, is
read in place at its own width (`reads_in_place`): the kernel's loads
zero-fill the columns past it (TMA boxes past the tensor map's extent,
cp.async with a source size of 0), so zero columns of q and k leave QK^T
as it is, zero columns of v give output columns that are never stored,
and the output is a buffer of the true width. Only the other widths are
zero-padded to the next width read in place (`read_width`, `pad_heads`,
a plain-PyTorch copy around the kernel), the output sliced back, the
logits scaled by the true width's d^-1/2. So kernel A takes every head
width, as the reference's kernel does.

The reference's Pallas kernel has no backward (training there
differentiates its einsum attention). For training on the card, `sdpa`
wraps kernel A in an autograd Function (`KernelAttention`) whose backward
is `sdpa_backward`: bf16 heads of a width the backward kernels take
(`backward_route`: a multiple of 8 up to `BWD_WIDTH`, every shipped
model's) go to three hand-written kernels (`csrc/attention_bwd.cu`,
`attention_backward`) that recompute P tile by tile and never write an
N x N tensor to device memory; f32 inputs, other widths and CPU tensors go
to `sdpa_backward_plain`, P recomputed from q and k and rounded where the
autograd of `sdpa_plain` rounds. Both stay within `backward_error_bound`.
The backward kernels were added for the cost of the plain backward, whose
(B, H, N, N) tensors in device memory took 334 of the 708 kernel ms of a
batch-12 384x512 training step on an H100 (the kernels: 41).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from monst3r_slam_torch.ops import build
from monst3r_slam_torch.utils import timing

HEAD_DIMS = (16, 32, 64, 128, 256)  # the bf16 route's instantiations
# Above HEAD_DIMS the bf16 wide variant stages d in chunks of WIDE_CHUNK
# columns (a step of QK^T); it and the f32 tensor-core route write O in
# slices of WIDE_SLICE columns.
WIDE_CHUNK = 64
WIDE_SLICE = 256
F32_FFMA_DIMS = (16, 32, 64)  # the FFMA route's instantiations
# The f32 tensor-core route's 16-byte copies: it takes every multiple of
# F32_TC_ALIGN above F32_FFMA_DIMS[-1].
F32_TC_ALIGN = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"attn_forward": ([ctypes.c_char_p], ctypes.c_int)}
# One call's arguments as the C entry's `AttnArgs`: 4 pointers, the (batch,
# head, row, dim) strides of q, k, v and the output, the 5 sizes, the true
# head width, the type and the stream, 28 int64 values in one buffer (one
# foreign argument).
_PACK = struct.Struct("=28q").pack
# The backward kernels' one instantiated head width; they read every
# narrower multiple of 8 in place.
BWD_WIDTH = 64
_BWD_ROWS = 64  # rows of a CTA's block; the row statistics are padded to it
_BWD_SIGNATURES = {"attn_backward": ([ctypes.c_char_p], ctypes.c_int)}
# One backward call's arguments as the C entry's `BwdArgs`: 9 pointers (q,
# k, v, dout, dq, dk, dv, the row statistics lse and delta), the (batch,
# head, row, dim) strides of the seven tensors, the 5 sizes and the stream.
_PACK_BWD = struct.Struct("=43q").pack


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float | None = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (B, H, Nq, D), k/v (B, H, Nk, D) -> (B, H, Nq, D) in q's type; the
    logits scaled by `scale`, D^-1/2 by default, and their softmax in
    `dtype` (the reference's float32; float64 gives the exact value that
    `error_bound` holds kernel A's f32 route to above 256 columns)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version `error_bound` holds kernel A to on these inputs:
    `sdpa_plain` in f32, or, for the f32 tensor-core route (f32 inputs
    wider than 64), in f64."""
    if route(q.dtype, q.shape[-1]) == "f32_tc":
        return sdpa_plain(q.double(), k.double(), v.double(), dtype=torch.float64)
    return sdpa_plain(q.float(), k.float(), v.float())


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
    computed in f32 from the same inputs (for the f32 tensor-core route, in
    f64: `reference`).

    f32 routes: 2e-5, the summation-order tolerance of the CPU parity test.
    Up to 64 columns the FFMA kernel sums each logit in one f32 chain in
    column order, as cuBLAS's f32 product does, so the two agree to that.
    Above 64 the tensor-core kernel sums in 3xTF32: each operand split into
    two TF32 parts, the three larger partial products summed in k8 blocks
    and the blocks chained in f32. That keeps it within 2e-5 of the exact
    value, closer than one f32 chain over d columns, whose rounding grows
    with its length: on peaked logits cuBLAS's own sum lies farther than
    2e-5 from the exact one, so there the f64 plain version is the
    reference.

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
    inputs: 2^-20 of the same terms, for the summation order alone.

    The same bounds hold for the backward kernels (`attention_backward`),
    which round the dS path elsewhere: they keep dP in f32 and round dS
    itself to bf16 before its products, which moves dS by at most 2^-9
    |dS| = 2^-9 P |dP - sum_k P dP| <= 2^-9 P (|dP| + sum_k P |dP|), the
    dP term above. On an H100 the card tests' inputs put both backwards at
    0.13-0.89 of these bounds, the largest on peaked logits."""
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


def route(dtype: torch.dtype, d: int) -> str:
    """The route kernel A takes for inputs of type `dtype` and head width
    `d`: "bf16_tc" (the bf16 tensor-core kernel), "f32" (the FFMA kernel, f32
    up to 64 columns) or "f32_tc" (the f32 tensor-core kernel in 3xTF32)."""
    if dtype == torch.bfloat16:
        return "bf16_tc"
    return "f32" if d <= F32_FFMA_DIMS[-1] else "f32_tc"


def padded_width(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The width of the instantiation kernel A runs a head of width `d` on,
    on the route of `dtype` (the bf16 route's by default): the narrowest
    that holds it (`HEAD_DIMS`, in f32 `F32_FFMA_DIMS`); above them, in bf16
    the next multiple of `WIDE_CHUNK` (the wide variant's chunks), in f32
    the next multiple of `F32_TC_ALIGN` (the tensor-core route). The
    columns from d to it are zeros the kernel's loads fill in; whether the
    call copies is `reads_in_place`."""
    if route(dtype, d) == "f32_tc":
        return -(-d // F32_TC_ALIGN) * F32_TC_ALIGN
    for width in (HEAD_DIMS if dtype == torch.bfloat16 else F32_FFMA_DIMS):
        if d <= width:
            return width
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def reads_in_place(d: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether kernel A reads a head of width `d` in place on the route of
    `dtype` (the bf16 route's by default), so that `fused_attention` makes
    no copy of it: every width whose rows a 16-byte copy addresses, a
    multiple of 8 in bf16 (a TMA box's row) and of 4 in f32 (a cp.async).
    The C entry's own rule is `attn_in_place` in csrc/attention.cu; the card
    tests hold the two equal."""
    return d >= 1 and read_width(d, dtype) == d


def read_width(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The width kernel A reads a head of width `d` at on the route of
    `dtype`: the next multiple of the elements one 16-byte copy holds, `d`
    itself where it `reads_in_place`; `fused_attention` zero-pads a head of
    any other width to it (`pad_heads`)."""
    align = 16 // dtype.itemsize
    return -(-d // align) * align


def column_slices(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """How many column slices of O kernel A computes a head of width `d` in
    on the route of `dtype` (the bf16 route's by default): in bf16 one up
    to `HEAD_DIMS[-1]`, above it one per `WIDE_SLICE` columns of the width
    it reads (`read_width`), each recomputing QK^T over the whole width; on
    the f32 tensor-core route one up to 256 columns, above it as few as
    `WIDE_SLICE` columns a slice allow, of one width (a multiple of 8),
    which share QK^T up to 16 slices and recompute it past them. The
    kernel's own count is `attn_f32_slices` in csrc/attention.cu; the card
    tests hold the two equal."""
    if route(dtype, d) != "f32_tc":
        return -(-read_width(d, dtype) // WIDE_SLICE)
    d = read_width(d, dtype)
    if d <= HEAD_DIMS[-1]:
        return 1
    n = -(-d // WIDE_SLICE)
    width = (-(-d // n) + 7) // 8 * 8
    return -(-d // width)


def pad_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, width: int) -> tuple:
    """(q, k, v) zero-padded along d to `width` (`read_width` on their
    route), as new contiguous tensors (the inputs themselves where d is
    that width). Attention over the padded heads with the true width's
    d^-1/2, sliced back to d columns, is attention over the originals.
    `pad_heads.copies` counts the calls that copy."""
    pad = width - q.shape[-1]
    if pad == 0:
        return q, k, v
    pad_heads.copies += 1
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


pad_heads.copies = 0  # calls that copied


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel A on CUDA tensors q (B, H, Nq, d), k/v (B, H, Nk, d), any
    d >= 1 and any B H, of one type, float32 or bfloat16, read in place
    through their strides where d is a width kernel A reads in place on
    its route (`reads_in_place`: a multiple of 8 in bfloat16, of 4 in
    float32), on the narrowest instantiation that holds d (`padded_width`),
    whose loads zero-fill the columns past d; any other width is first
    zero-padded to the next one (`read_width`, `pad_heads`, a copy). No
    width is refused: above 256 the tensor-core routes compute O in slices
    of at most 256 columns (`column_slices`), which in bf16 each recompute
    QK^T over the whole width and in f32 share it through the cluster (past
    16 slices, recompute it), so their shared memory and registers do not
    grow with d (only the grid does, within its 2^31 - 1 blocks). The last
    dimension must be contiguous, every start 16-byte aligned and every
    other stride a multiple of 8 elements in bfloat16, of 4 in float32 (the
    kernel checks, and this raises on a layout it refuses; `sdpa` copies
    such inputs first). A launch that fails raises: nothing falls back to
    the padding or to the plain version. Returns (B, H, Nq, d), the
    transposed view of a contiguous (B, Nq, H, d) buffer, or, for a padded
    width, that view's first d columns."""
    dev = q.get_device()  # -1 for a CPU tensor
    if dev < 0 or k.get_device() != dev or v.get_device() != dev:
        raise ValueError("fused_attention takes CUDA tensors on one device")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"fused_attention takes float32 or bfloat16, got {dtype}")
    if q.dim() != 4 or q.shape[-1] < 1:
        raise ValueError(f"fused_attention takes (B, H, N, d), got {tuple(q.shape)}")
    b, h, nq, d_true = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d_true) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    path = route(dtype, d_true)
    q, k, v = pad_heads(q, k, v, read_width(d_true, dtype))
    d = q.shape[-1]
    out = torch.empty_strided((b, h, nq, d), (nq * h * d, d, h * d, 1), dtype=dtype,
                              device=q.device)
    args = _PACK(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride(),
                 *k.stride(), *v.stride(), *out.stride(), b, h, nq, nk, d, d_true,
                 _DTYPES[dtype], torch._C._cuda_getCurrentRawStream(dev))
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
    fused_attention.route_launches[path] += 1
    widths = fused_attention.width_launches
    widths[d_true] = widths.get(d_true, 0) + 1
    return out if d == d_true else out[..., :d_true]


fused_attention.launches = 0  # every launch
fused_attention.route_launches = {"bf16_tc": 0, "f32": 0, "f32_tc": 0}  # launches per route
fused_attention.width_launches = {}  # launches per true head width


def backward_route(dtype: torch.dtype, d: int, device: torch.device) -> str:
    """The backward `sdpa_backward` takes for inputs of type `dtype`, head
    width `d` on `device`: "kernel" (`attention_backward`) for bf16 CUDA
    tensors of a width the kernels read in place, a multiple of 8 up to
    `BWD_WIDTH`; "plain" (`sdpa_backward_plain`) for f32 inputs, other
    widths and CPU tensors."""
    if (device.type == "cuda" and dtype == torch.bfloat16 and d % 8 == 0
            and 8 <= d <= BWD_WIDTH):
        return "kernel"
    return "plain"


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor) -> tuple:
    """(dq, dk, dv) of softmax attention on the card: the backward kernels of
    `csrc/attention_bwd.cu` (`attn_bwd_prep`, `attn_bwd_dkdv`, `attn_bwd_dq`)
    on bf16 CUDA tensors q, dout (B, H, Nq, d), k, v (B, H, Nk, d) of a width
    `backward_route` sends to them, read through their strides (last
    dimension contiguous, starts 16-byte aligned, other strides multiples of
    8 elements; the C entry checks, and this raises on a layout it
    refuses). Rounds P to bf16 before dV = P^T dout, as
    `sdpa_backward_plain` does, but keeps dP in f32 where that rounds it to
    bf16, and rounds dS to bf16 before dK = dS^T q and dQ = dS k where that
    keeps it in f32 (`backward_error_bound` says why the same bound holds);
    the outputs to bf16.
    Each gradient is the (B, H, N, d) view of a contiguous (B, N, H, d)
    buffer. A launch that fails raises."""
    dev = q.get_device()
    if dev < 0 or any(t.get_device() != dev for t in (k, v, dout)):
        raise ValueError("attention_backward takes CUDA tensors on one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, dout)):
        raise ValueError(f"attention_backward takes bfloat16, got {q.dtype}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape or dout.shape != q.shape:
        raise ValueError(f"k/v/dout shapes {tuple(k.shape)}/{tuple(v.shape)}/"
                         f"{tuple(dout.shape)} do not fit q {tuple(q.shape)}")
    if backward_route(q.dtype, d, q.device) != "kernel":
        raise ValueError(f"attention_backward takes head widths that are multiples of 8 up "
                         f"to {BWD_WIDTH}, got {d}")
    grads = [torch.empty_strided((b, h, n, d), (n * h * d, d, h * d, 1), dtype=q.dtype,
                                 device=q.device) for n in (nq, nk, nk)]
    rows = -(-nq // _BWD_ROWS) * _BWD_ROWS
    lse, delta = torch.empty((2, b * h * rows), dtype=torch.float32, device=q.device)
    ts = (q, k, v, dout, *grads)
    args = _PACK_BWD(*(t.data_ptr() for t in ts), lse.data_ptr(), delta.data_ptr(),
                     *(s for t in ts for s in t.stride()), b, h, nq, nk, d,
                     torch._C._cuda_getCurrentRawStream(dev))
    lib = build.load("attention_bwd", _BWD_SIGNATURES)
    with build.on_card(dev):
        err = lib.attn_backward(args)
    if err == 1000:
        raise ValueError(
            f"attention_backward cannot read this layout: strides "
            f"{[t.stride() for t in ts[:4]]}, starts {[t.data_ptr() % 16 for t in ts[:4]]} "
            "bytes past 16-byte alignment")
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: error {err}")
    attention_backward.launches += 1
    return tuple(grads)


attention_backward.launches = 0  # calls (of three kernel launches each)


def sdpa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor) -> tuple:
    """(dq, dk, dv) of `sdpa` on the route `backward_route` gives:
    `attention_backward` (dout copied first where the kernels cannot read
    its layout) or `sdpa_backward_plain`. Counts the call as
    `attn.bwd_kernel` or `attn.bwd_plain` in `utils.timing`."""
    path = backward_route(q.dtype, q.shape[-1], q.device)
    timing.count(f"attn.bwd_{path}")
    if path == "plain":
        return sdpa_backward_plain(q, k, v, dout)
    if not readable(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    return attention_backward(q, k, v, dout)



class KernelAttention(torch.autograd.Function):
    """Kernel A forward, `sdpa_backward` backward. Saves q, k and v, not P:
    the backward recomputes P, never the forward's output."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_attention(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        return sdpa_backward(*ctx.saved_tensors, dout)


def readable(t: torch.Tensor) -> bool:
    """Whether kernel A reads `t` in place: its last dimension contiguous,
    its start 16-byte aligned and every other stride of a dimension longer
    than 1 a multiple of 16 bytes (the C entry's check)."""
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % align == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel A for CUDA tensors, the plain version for CPU tensors. On the
    card an input whose layout kernel A cannot read in place (`readable`)
    is first copied into a contiguous tensor, at every width it reads in
    place (`reads_in_place`; a head of any other width is copied by its
    padding already); a call that autograd records (grad enabled, an input
    that requires grad) goes through `KernelAttention`; every other call
    launches kernel A directly."""
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v)
    if reads_in_place(q.shape[-1], q.dtype):
        q, k, v = (t if readable(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return KernelAttention.apply(q, k, v)
    return fused_attention(q, k, v)
