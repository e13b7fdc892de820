"""Kernels A (attention, both routes, and its autograd Function with the
plain backward) and B (tile matcher, and its phase instantiations) on the
card against their plain versions, through the dispatch the model and the
matcher call; and the dynamic pipeline's parts
on the card: RAFT against its CPU path, the fused flow program's readback
ordering around `overlap_cb`, and the dual decode's kernel A launches; the
LM matcher against its CPU run; chunked tracking against the per-frame
path, with each chunk's dispatch free of host synchronization; and the
sharded edge decode and Gauss-Newton, and the sharded train step, on a
mesh that repeats one card against their unsharded forms.

They need a CUDA device and nvcc, and skip without them. On a machine with
the card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: the repository's conftest sets JAX up for the CPU tests,
and the port needs no JAX.)
"""

import numpy as np
import pytest
import torch

import monst3r_slam_torch  # noqa: F401  (TF32 off for the plain versions)
from monst3r_slam_torch.ops import attention, matching_pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


# (batch, heads, nq, nk): the main path's 768 tokens, a 224x224 image's 196,
# and ragged counts below and across one 64-row tile.
ATTENTION_CASES = [(2, 3, 768, 768), (2, 3, 196, 196), (2, 3, 48, 80), (2, 3, 130, 7)]
# The f32 route also at the training path's shapes (MAST3R_512 at 224x224
# batch 4, encoder and decoder heads and the sharded step's halves, and two
# 384x512 decoder pairs) and at counts across its 128-query blocks, its
# 32-query warps and its 16-key tiles.
F32_CASES = [(2, 8, 196, 196), (2, 6, 196, 196), (4, 16, 196, 196), (2, 12, 768, 768)] + [
    (2, 3, nq, nk) for nq in (1, 31, 33, 65, 129) for nk in (7, 63, 65, 769)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,logit_scale,b,h,nq,nk", [
    (dtype, scale, *case) for dtype, scale in ((torch.float32, 1), (torch.bfloat16, 1),
                                               (torch.bfloat16, 8), (torch.float32, 8))
    for case in ATTENTION_CASES] + [
    (torch.float32, scale, *case) for scale in (1, 8) for case in F32_CASES])
def test_attention_kernel_matches_plain(cuda, dtype, logit_scale, b, h, nq, nk):
    """Both routes at `ATTENTION_CASES` and the f32 route at `F32_CASES`,
    within `attention.error_bound` (f32: 2e-5; bf16: from its two bf16
    roundings, of P and of O), with unit logits and with logits 8x the unit
    scale (a peaked softmax), where in bf16 logits rounded to bf16 would
    exceed the bound (tests/test_torch_attention.py shows that on the
    kernel's arithmetic emulated on the CPU)."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, 64), dtype=np.float32))
               .to(cuda, dtype) for n in (nq, nk, nk))
    q = q * logit_scale
    route = "bf16_tc" if dtype == torch.bfloat16 else "f32"
    before = attention.fused_attention.launches
    before_route = attention.fused_attention.route_launches[route]
    got = attention.sdpa(q, k, v)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1
    assert attention.fused_attention.route_launches[route] == before_route + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = attention.sdpa_plain(q.float(), k.float(), v.float())
    assert float((got.float() - ref).abs().max()) <= attention.error_bound(q, k, v, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_and_writes_through_strides(cuda, dtype):
    """q, k, v as the model's heads split makes them: transposed views of
    one fused projection output, read in place. The output is the (B, H, N,
    64) view of a contiguous (B, N, H, 64) buffer, so the heads merge is a
    view."""
    b, n, h = 2, 196, 3
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * 64), dtype=np.float32)).to(cuda, dtype)
    q, k, v = (t.reshape(b, n, h, 64).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not v.is_contiguous()
    got = attention.sdpa(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, h, n, 64) and got.transpose(1, 2).is_contiguous()
    assert got.transpose(1, 2).reshape(b, n, h * 64).data_ptr() == got.data_ptr()
    ref = attention.sdpa_plain(q.float(), k.float(), v.float())
    assert float((got.float() - ref).abs().max()) <= attention.error_bound(q, k, v, ref)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    """Wrong head dim or type; and layouts the kernel cannot read in place,
    which it refuses rather than copy: a last dimension that is not
    contiguous, a start that is not 16-byte aligned, or a row stride that is
    not a multiple of 8 elements in bf16 and of 4 in f32. The model's
    transposed views of one fused projection are taken on both routes."""
    x = torch.zeros((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention(x, x, x)  # head dim 32
    y = torch.zeros((1, 2, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        attention.fused_attention(y, y, y)
    for dtype in (torch.float32, torch.bfloat16):
        ok = torch.zeros((1, 2, 100, 64), device=cuda, dtype=dtype)
        strided = torch.zeros((1, 2, 64, 100), device=cuda, dtype=dtype).transpose(-1, -2)
        with pytest.raises(ValueError):
            attention.fused_attention(ok, strided, ok)
    for dtype, pad in ((torch.bfloat16, 68), (torch.float32, 66)):
        ok = torch.zeros((1, 2, 100, 64), device=cuda, dtype=dtype)
        odd = torch.zeros(2 * 100 * 64 + 1, device=cuda, dtype=dtype)[1:].reshape(1, 2, 100, 64)
        wide = torch.zeros((1, 2, 100, pad), device=cuda, dtype=dtype)[..., :64]
        for bad in (odd, wide):
            with pytest.raises(ValueError):
                attention.fused_attention(ok, ok, bad)
            with pytest.raises(ValueError):
                attention.fused_attention(bad, ok, ok)
        qkv = torch.zeros((2, 196, 3 * 3 * 64), device=cuda, dtype=dtype)
        q, k, v = (t.reshape(2, 196, 3, 64).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        assert attention.fused_attention(q, k, v).shape == (2, 3, 196, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nk", [((4, 16, 196, 64), 196), ((1, 16, 768, 64), 768),
                                      ((2, 3, 130, 64), 7)])
def test_attention_function_gradient_matches_the_plain_autograd(cuda, dtype, shape, nk):
    """Kernel A's autograd Function, as the training forward reaches it
    through `sdpa` with grad enabled: one kernel A launch forward and none
    backward; the forward within `attention.error_bound` and dq, dk, dv
    within `attention.backward_error_bound` of the f32 plain autograd, at
    the 224x224 training shape, at 768 tokens and at a ragged count. With
    grad disabled `sdpa` launches kernel A directly and records nothing."""
    rng = np.random.default_rng(shape[2] + nk)
    b, h, nq, d = shape
    q, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, nk, d), dtype=np.float32)).to(cuda, dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = attention.fused_attention.launches
    out = attention.sdpa(*leaves)
    n1 = attention.fused_attention.launches
    out.backward(dout)
    torch.cuda.synchronize()
    assert (n1 - n0, attention.fused_attention.launches - n1) == (1, 0)
    assert type(out.grad_fn).__name__ == "KernelAttentionBackward"
    ref = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref_out = attention.sdpa_plain(*ref)
    ref_out.backward(dout.float())
    assert (float((out.detach().float() - ref_out.detach()).abs().max())
            <= attention.error_bound(q, k, v, ref_out.detach()))
    for t, r, bound in zip(leaves, ref, attention.backward_error_bound(q, k, v, dout)):
        assert t.grad.dtype == dtype and bool(((t.grad.float() - r.grad).abs() <= bound).all())
    with torch.no_grad():
        assert attention.sdpa(*leaves).grad_fn is None
    assert attention.fused_attention.launches == n1 + 1


def _tile_args(cuda, seed, fd, T, desc=None, qd=None):
    """Kernel B's dispatch arguments on a 64x80 image: random unit rays,
    exact ray peaks on a crop border (the stencil's wrap and zero rules),
    corners that need clipping and 16-alignment; random descriptors unless
    given."""
    rng = np.random.default_rng(seed)
    h, w, tsz = 64, 80, 256
    rays = rng.standard_normal((h, w, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, tsz, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, :32] = rays[:1, :32]
    corners = np.concatenate([[[-5, 3], [40, 40], [17, 9], [79, 63], [0, 0], [31, 15]],
                              rng.integers(-8, 90, (max(T - 6, 0), 2))])[:T].astype(np.int32)
    if desc is None:
        desc = rng.standard_normal((h, w, fd))
    if qd is None:
        qd = rng.standard_normal((T, tsz, fd))
    return [torch.from_numpy(np.asarray(a, np.float32)).to(cuda) for a in (rays, desc, q, qd)] + [
        torch.from_numpy(corners).to(cuda)]


def _kernel_args(args, crop=48, window=15):
    """The kernel wrapper's arguments from the dispatch's: bf16 descriptors,
    quantized corners."""
    h, w, _ = args[0].shape
    return (args[0], args[1].to(torch.bfloat16), args[2], args[3].to(torch.bfloat16),
            matching_pallas.quantize_corners(args[4], h, w, crop), crop, window, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [6, 301])
@pytest.mark.parametrize("fd", [16, 24, 32])
def test_tile_match_kernel_matches_plain(cuda, fd, T):
    """Through the dispatch, at a tile count under the persistent grid and
    one that is no multiple of it. The ray match (the stencil cut) and the
    convergence flags equal the plain version's; the descriptor match passes
    `rounding_check` (the tensor cores sum in their own order)."""
    args = _tile_args(cuda, fd + T, fd, T)
    before = matching_pallas.tile_match_kernel.launches
    u, v, conv = matching_pallas.tile_match(
        *args, tcfg=matching_pallas.PallasTileConfig(crop=48, window=15), conv_thresh=1e-6)
    torch.cuda.synchronize()
    assert matching_pallas.tile_match_kernel.launches == before + 1
    kargs = _kernel_args(args)
    ray = matching_pallas.tile_match_phase_kernel(*kargs, phase="stencil")
    torch.cuda.synchronize()
    ray0 = matching_pallas.tile_match_plain(*kargs, phase="stencil")
    assert all(torch.equal(a, b) for a, b in zip(ray, ray0))
    assert torch.equal(conv, ray0[2])
    passes, exact = matching_pallas.rounding_check(*kargs, (u, v, conv))
    assert bool(passes.all())
    assert float(exact.float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("fd", [16, 24, 32])
def test_tile_match_kernel_keeps_the_lowest_index_among_equal_descriptors(cuda, fd):
    """Every position's descriptor is one of four small-integer vectors and
    the queries are small integers, so every sum is an exact integer in any
    order: each window holds many positions with the same descriptor and
    equal scores, and the kernel must pick the lowest index as the plain
    version does. Equal."""
    rng = np.random.default_rng(fd)
    palette = rng.integers(-2, 3, (4, fd))
    desc = palette[rng.integers(0, 4, (64, 80))]
    qd = rng.integers(-2, 3, (6, 256, fd))
    kargs = _kernel_args(_tile_args(cuda, 7, fd, 6, desc=desc, qd=qd))
    got = matching_pallas.tile_match_kernel(*kargs)
    torch.cuda.synchronize()
    ref = matching_pallas.tile_match_plain(*kargs)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_tile_match_kernel_refuses_what_it_does_not_take(cuda):
    """What its bulk copies cannot move (a crop or an image width that is no
    multiple of 4, an image that is not 16-byte aligned) and a crop whose
    ring of slots exceeds shared memory: refused, no other path."""
    kargs = list(_kernel_args(_tile_args(cuda, 0, 24, 6)))
    with pytest.raises(ValueError):
        matching_pallas.tile_match_kernel(*kargs[:5], 46, *kargs[6:])
    with pytest.raises(ValueError):
        matching_pallas.tile_match_kernel(*kargs[:4], kargs[4], 64, *kargs[6:])
    odd = torch.zeros(64 * 80 * 24 + 1, device=cuda, dtype=torch.bfloat16)[1:].reshape(64, 80, 24)
    with pytest.raises(ValueError):
        matching_pallas.tile_match_kernel(kargs[0], odd, *kargs[2:])
    narrow = kargs[0][:, :78].contiguous()
    with pytest.raises(ValueError):
        matching_pallas.tile_match_kernel(narrow, kargs[1][:, :78].contiguous(), *kargs[2:])


# fd 24 descriptor sums by kernel B's tensor-core instructions: m16n8k16 on
# channels 0-15, then m16n8k8 on 16-23, from a zero accumulator, with each
# operand in the k slot `descriptor_window` gives it. One warp per 16 x 8
# block of s[b] = q[b] d[b]^T; q (batch, n, 24), d (batch, m, 24) bf16.
_MMA_SUMS_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_sums(const uint32_t* q, const uint32_t* d, float* s, int n, int m) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  const size_t b = blockIdx.z, i = (size_t)blockIdx.y * 16 + g, j = (size_t)blockIdx.x * 8 + g;
  const uint32_t* qa = q + (b * n + i) * 12;  // 12 bf16 pairs a row
  const uint32_t* qb = qa + 8 * 12;
  const uint32_t* dc = d + (b * m + j) * 12;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(qa[t]), "r"(qb[t]), "r"(qa[4 + t]), "r"(qb[4 + t]), "r"(dc[t]), "r"(dc[4 + t]));
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(qa[8 + t]), "r"(qb[8 + t]), "r"(dc[8 + t]));
  float* out = s + (b * n + i) * m + (size_t)blockIdx.x * 8 + 2 * t;
  out[0] = c[0];
  out[1] = c[1];
  out[8 * (size_t)m] = c[2];
  out[8 * (size_t)m + 1] = c[3];
}

extern "C" int mma_sums_forward(const void* q, const void* d, void* s, int batch, int n, int m,
                                void* stream) {
  mma_sums<<<dim3(m / 8, n / 16, batch), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(d), static_cast<float*>(s),
      n, m);
  return (int)cudaGetLastError();
}
"""


@pytest.mark.cuda
def test_tensor_core_descriptor_sums_stay_within_the_rounding_allowance(cuda, tmp_path):
    """`rounding_check` admits a descriptor match whose plain score is within
    delta = ROUNDING_C 2^-24 S of the plain window maximum (S the window's
    largest sum_c |q_c d_c|). That is sound while each tensor-core window
    sum lies within ROUNDING_C / 2 units of 2^-24 S of the plain sum: then
    plain(jp) - plain(jk) <= gap(jp) + (mma(jp) - mma(jk)) + gap(jk), and
    the middle term is <= 0 for the kernel's match jk. On chip_smoke.py's
    descriptors (384x512, fd 24, unit normal, seed 0), every query of each
    16x16 tile against every position of its 48x48 crop (a superset of its
    +-15 px window): the largest gap, in units of 2^-24 sum_c |q_c d_c| of
    that pair (at most its unit of the window's S), with each sum's
    distance from the exact one (float64), printed."""
    import ctypes
    import subprocess

    from monst3r_slam_torch.ops import build

    src, lib_file = tmp_path / "mma_sums.cu", tmp_path / "libmma_sums.so"
    src.write_text(_MMA_SUMS_SRC)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_file), str(src)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_file))
    lib.mma_sums_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mma_sums_forward.restype = ctypes.c_int

    h, w, fd, crop, batch = 384, 512, 24, 48, 32
    d = np.random.default_rng(0).standard_normal((h * w, fd)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    flat = torch.from_numpy(d).to(cuda, torch.bfloat16)
    ty, tx = torch.meshgrid(torch.arange(h // 16), torch.arange(w // 16), indexing="ij")
    oy, ox = 16 * ty.flatten().to(cuda), 16 * tx.flatten().to(cuda)
    cy, cx = (oy - 16).clamp(0, h - crop), (ox - 16).clamp(0, w - crop)
    r16, rc = torch.arange(16, device=cuda), torch.arange(crop, device=cuda)
    q_lin = ((oy[:, None, None] + r16[:, None]) * w + ox[:, None, None] + r16).flatten(1)
    c_lin = ((cy[:, None, None] + rc[:, None]) * w + cx[:, None, None] + rc).flatten(1)
    unit = 2.0**-24
    worst = dict(gap=0.0, mma=0.0, plain=0.0)
    for b0 in range(0, len(q_lin), batch):
        q, dc = flat[q_lin[b0 : b0 + batch]], flat[c_lin[b0 : b0 + batch]]
        nb, n, m = q.shape[0], q.shape[1], dc.shape[1]
        s = torch.empty((nb, n, m), device=cuda)
        err = lib.mma_sums_forward(q.data_ptr(), dc.data_ptr(), s.data_ptr(), nb, n, m,
                                   torch.cuda.current_stream().cuda_stream)
        assert err == 0
        qf, df = q.float(), dc.float()
        plain = qf[:, :, None, 0] * df[:, None, :, 0]  # tile_match_plain's order
        for ch in range(1, fd):
            plain.addcmul_(qf[:, :, None, ch], df[:, None, :, ch])
        exact = q.double() @ dc.double().transpose(1, 2)
        scale = unit * (q.double().abs() @ dc.double().abs().transpose(1, 2))
        for key, a, ref in (("gap", s, plain), ("mma", s, exact), ("plain", plain, exact)):
            worst[key] = max(worst[key], float(((a.double() - ref.double()).abs() / scale).max()))
    print(f"fd 24 window sums over {len(q_lin)} tiles x 256 queries x {crop * crop} positions, "
          f"largest distance in units of 2^-24 sum_c |q_c d_c|: mma.sync from plain "
          f"{worst['gap']:.3f}, mma.sync from exact {worst['mma']:.3f}, plain from exact "
          f"{worst['plain']:.3f} (allowance per sum: ROUNDING_C / 2 = "
          f"{matching_pallas.ROUNDING_C / 2:g})")
    assert worst["gap"] <= matching_pallas.ROUNDING_C / 2


@pytest.mark.cuda
@pytest.mark.parametrize("phase", matching_pallas.PHASES)
def test_tile_match_phase_kernel_matches_plain(cuda, phase):
    """Each phase instantiation of kernel B against the plain version cut at
    the same point: stage, ray and stencil do the same arithmetic in the same
    order, so equal; full passes `rounding_check`."""
    kargs = _kernel_args(_tile_args(cuda, 2, 24, 6))
    before = matching_pallas.tile_match_phase_kernel.launches
    got = matching_pallas.tile_match_phase_kernel(*kargs, phase=phase)
    torch.cuda.synchronize()
    assert matching_pallas.tile_match_phase_kernel.launches == before + 1
    if phase == "full":
        passes, _ = matching_pallas.rounding_check(*kargs, got)
        assert bool(passes.all())
    else:
        ref = matching_pallas.tile_match_plain(*kargs, phase=phase)
        for a, r in zip(got, ref):
            assert torch.equal(a, r)


def _raft_inputs(seed=0, h=64, w=80):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = sum(np.sin(rng.uniform(0.05, 0.4) * xx[..., None] + rng.uniform(0.05, 0.4)
                     * yy[..., None] + rng.uniform(0, 6.3, 3)) for _ in range(5))
    u0 = np.uint8(np.clip((img / np.abs(img).max() * 0.5 + 0.5) * 255, 0, 255))
    K = np.asarray([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
    return u0, np.roll(u0, 3, axis=1), np.full((h, w), 2.0, np.float32), K


@pytest.mark.cuda
def test_raft_on_the_card_matches_the_cpu_path(cuda):
    """RAFT at full widths, 3 iterations, f32 with TF32 off on both sides:
    the flow within 1e-4 of its scale, the fused uint8 map within one step."""
    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.dynamic import raft

    cfg = raft.RAFTConfig(iters=3)
    params = raft.init_raft_params(torch.Generator().manual_seed(2), cfg)
    u0, u1, depth, K = _raft_inputs()
    T_j = lie.sim3_retr(lie.sim3_identity(), torch.tensor([0.02, 0, 0, 0, 0.01, 0, 0]))
    got, ref = {}, {}
    for dev, out in ((cuda, got), ("cpu", ref)):
        p = _tree_to(params, dev)
        out["flow"] = raft.raft_flow(p, torch.from_numpy(u0).float().to(dev),
                                     torch.from_numpy(u1).float().to(dev), cfg).cpu()
        out["map"] = raft.make_fused_flow_error_program(p, cfg)(
            u0, u1, lie.sim3_identity(), T_j, depth, K)
    scale = float(ref["flow"].abs().max())
    assert float((got["flow"] - ref["flow"]).abs().max()) <= 1e-4 * scale
    assert np.abs(got["map"] - ref["map"]).max() <= 1 / 255 + 1e-6


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_fused_program_reads_its_map_before_the_overlap_work_ends(cuda):
    """The map's pinned copy is enqueued behind the flow program with an
    event, then `overlap_cb` runs, then only that event is waited on: the
    adapter returns while the work `overlap_cb` enqueued (a 0.2 s spin here,
    as the MASt3R decode in the pipeline) is still running, and the map is
    the one a plain read gives."""
    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.dynamic import raft

    cfg = raft.RAFTConfig(iters=2)
    params = raft.init_raft_params(torch.Generator(device=cuda).manual_seed(2), cfg)
    u0, u1, depth, K = _raft_inputs()
    prog = raft.make_fused_flow_error_program(params, cfg)
    T = lie.sim3_identity(device=cuda)
    ref = prog(u0, u1, T, T, depth, K)
    overlap_done = torch.cuda.Event()

    def overlap_cb():
        torch.cuda._sleep(int(0.2 * 1.98e9))
        overlap_done.record()

    got = prog(u0, u1, T, T, depth, K, overlap_cb=overlap_cb)
    assert not overlap_done.query()  # returned before the overlap work ended
    torch.cuda.synchronize()
    assert overlap_done.query()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_dual_decode_launches_kernel_a_per_decoder(cuda):
    """The dual pipeline's encode and pair decode at MAST3R_512 / MONST3R_512
    widths (cut depth, bf16): kernel A once per encoder block, and 4 per
    decoder block in each decoder (self and cross attention, both streams),
    all on the tensor-core route, so 24 + 2 x 48 = 120 at full depth; X and C
    come from MonST3R, D and Q from MASt3R."""
    import dataclasses

    from monst3r_slam_torch.dynamic.inference import DualParams, monst3r_asymmetric_inference
    from monst3r_slam_torch.models import mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512, MONST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    cut = dict(enc_depth=2, dec_depth=2)
    a_cfg, m_cfg = (dataclasses.replace(c, **cut) for c in (MAST3R_512, MONST3R_512))
    a, m = (cast_params_for_inference(init_params(torch.Generator(device=cuda).manual_seed(s), c))
            for s, c in ((0, a_cfg), (1, m_cfg)))
    dual = DualParams(m, m_cfg, a, a_cfg)
    img = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 64, 80, 3))
                           .astype(np.float32)).to(cuda)
    attn = attention.fused_attention
    before, before_tc = attn.launches, attn.route_launches["bf16_tc"]
    feat, pos = model_api.encode(m, m_cfg, img)
    out = monst3r_asymmetric_inference(dual, feat[:1], pos[:1], feat[1:], pos[1:], (64, 80))
    torch.cuda.synchronize()
    want = 2 + 2 * 4 * 2  # the batch-2 encode: one a block; each decoder: 4 a block
    assert attn.launches - before == want and attn.route_launches["bf16_tc"] - before_tc == want
    ref_m = model_api.decode(m, m_cfg, feat[:1], pos[:1], feat[1:], pos[1:], (64, 80))
    ref_a = model_api.decode(a, a_cfg, feat[:1], pos[:1], feat[1:], pos[1:], (64, 80))
    for got, ref in ((out.X1, ref_m.X1), (out.C2, ref_m.C2), (out.D1, ref_a.D1),
                     (out.Q2, ref_a.Q2)):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_lm_matcher_on_the_card_matches_the_cpu(cuda):
    """The LM matcher (`ops/matching.py`, plain PyTorch) on the card against
    its CPU run on the same pointmaps and descriptors: indices and `valid`
    equal on at least 99.9% of the pixels (an LM iterate may land in the
    next integer cell when the card's f32 sums round otherwise, and then
    refines in another window)."""
    from monst3r_slam_torch.ops import matching

    h, w = 64, 80
    rng = np.random.default_rng(4)

    def surface(dx, dy):  # a smooth surface, sampled (dx, dy) px off the grid
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        u, v = (xx + dx - w / 2) / 60, (yy + dy - h / 2) / 60
        z = 2.0 + 0.3 * np.sin(3 * u) * np.cos(4 * v)
        return np.stack([u * z, v * z, z], -1)[None].astype(np.float32)

    X, X21 = surface(0, 0), surface(1.3, 0.4)
    D = rng.standard_normal((1, h, w, 24)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    D21 = np.roll(D, 1, axis=2)
    args = [torch.from_numpy(a) for a in (X, X21, D, D21)]
    ref = matching.match(*args)
    got = matching.match(*(a.to(cuda) for a in args))
    assert (got[0].cpu() == ref[0]).float().mean() >= 0.999
    assert (got[1].cpu() == ref[1]).float().mean() >= 0.999


@pytest.mark.cuda
def test_chunked_tracking_on_the_card_decides_as_the_perframe_path(cuda, monkeypatch):
    """`process_chunk` on the card against the per-frame path with
    `defer_tracking_sync: 0`, at MAST3R_512 widths with cut depth (bf16,
    tied random weights, one frame repeated, 64x80), with a keyframe at every
    frame (gate above 1): the same keyframes, poses within 1e-5; each
    chunk's dispatch runs under `torch.cuda.set_sync_debug_mode("error")`,
    so a hidden host synchronization fails the test; kernels A and B run.
    And a uint8 chunk normalizes on the card bit for bit as the host does."""
    import dataclasses

    from monst3r_slam_torch.app import chunked
    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params

    cfg_m = dataclasses.replace(MAST3R_512, enc_depth=2, dec_depth=2)
    p = init_params(torch.Generator(device=cuda).manual_seed(0), cfg_m)
    p["dec_blocks2"], p["head2"] = p["dec_blocks"], p["head1"]
    p = cast_params_for_inference(p)
    h, w = 64, 80
    img = np.random.default_rng(0).uniform(-1, 1, (h, w, 3)).astype(np.float32)

    def make(thresh):
        c = load_config("config/base.yaml", set_global=False)
        c["single_thread"] = True
        c["tracking"].update(Q_conf=0.0, match_frac_thresh=thresh)
        c["local_opt"].update(Q_conf=0.0, solver="device")
        c["parallel"] = {"mesh": "off"}
        return SLAMSystem(params=p, model_cfg=cfg_m, cfg=c, img_size=(h, w), kf_capacity=16,
                          device="cuda")

    track = chunked.chunk_track

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return track(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(chunked, "chunk_track", strict)
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    dev = chunked._norm_slice(torch.from_numpy(u8).to(cuda), 0).cpu().numpy()
    np.testing.assert_array_equal(dev, (u8.astype(np.float32) / 255.0 - 0.5) / 0.5)
    for thresh in (0.0, 1.01):
        ref, got = make(thresh), make(thresh)
        for i in range(6):
            ref.process_frame(i, i / 30.0, img)
        a0, b0 = attention.fused_attention.launches, matching_pallas.tile_match_kernel.launches
        for c0 in (0, 3):
            got.process_chunk(list(range(c0, c0 + 3)), [i / 30.0 for i in range(c0, c0 + 3)],
                              torch.from_numpy(np.stack([img] * 3)).to(cuda))
        assert attention.fused_attention.launches > a0
        assert matching_pallas.tile_match_kernel.launches > b0
        for s in (ref, got):
            s.finalize()
        assert got.mem.frame_id[: got.n_kf].tolist() == ref.mem.frame_id[: ref.n_kf].tolist()
        assert got.n_kf == (1 if thresh == 0.0 else 6) and got.mode == ref.mode
        np.testing.assert_allclose(np.stack(got.frame_poses), np.stack(ref.frame_poses),
                                   atol=1e-5)


def _one_card_mesh(cuda):
    """A (4, 2) mesh whose eight entries are all this card: the dp shards of
    a multi-card mesh, run one after the other on one card."""
    from monst3r_slam_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[cuda] * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [3, 8])
def test_sharded_edge_decode_on_one_card_equals_its_shards_decoded_alone(cuda, E):
    """`sharded_edge_decode` over the one-card (4, 2) mesh at MAST3R_512
    widths (cut depth, bf16 as the pipeline decodes; 64x80), E = 3 (pad
    rows) and 8: kernel A launches for every shard (4 a decoder block, both
    streams), and every output, in the unsharded decode's shape, layout and
    device, equals each shard's rows (zero pad rows included) decoded alone
    at the shard's batch size, bit for bit; with cuDNN off, whose algorithm
    choice is the decode's only dependence on the batch size, every output
    also equals one decode of the whole batch."""
    import dataclasses

    from monst3r_slam_torch.models import mast3r as model_api
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.convert import cast_params_for_inference
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.parallel.inference import place_replicated, sharded_edge_decode

    cfg = dataclasses.replace(MAST3R_512, enc_depth=2, dec_depth=2)
    p = cast_params_for_inference(init_params(torch.Generator(device=cuda).manual_seed(0), cfg))
    h, w = 64, 80
    img = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (E, h, w, 3))
                           .astype(np.float32)).to(cuda)
    feat, pos = model_api.encode(p, cfg, img)
    args = (feat, pos, feat.roll(1, 0), pos.roll(1, 0))
    mesh = _one_card_mesh(cuda)
    ref = model_api.decode(p, cfg, *args, (h, w))
    before = attention.fused_attention.launches
    out = sharded_edge_decode(mesh, place_replicated(p, mesh), cfg, *args, (h, w))
    torch.cuda.synchronize()
    assert attention.fused_attention.launches - before == 4 * 2 * 2 * cfg.dec_depth
    rows = -(-E // 4)
    padded = [torch.cat([a, a.new_zeros((4 * rows - E,) + tuple(a.shape[1:]))]) for a in args]
    alone = [model_api.decode(p, cfg, *(a[d * rows:(d + 1) * rows] for a in padded), (h, w))
             for d in range(4)]
    for r, s, *shards in zip(ref, out, *alone):
        assert s.shape == r.shape and s.device == r.device and s.stride() == r.stride()
        assert torch.equal(s, torch.cat(shards)[:E])
    torch.backends.cudnn.enabled = False  # its convolution algorithms vary with the batch
    try:
        out = sharded_edge_decode(mesh, place_replicated(p, mesh), cfg, *args, (h, w))
        ref = model_api.decode(p, cfg, *args, (h, w))
    finally:
        torch.backends.cudnn.enabled = True
    for r, s in zip(ref, out):
        assert torch.equal(s, r)


@pytest.mark.cuda
@pytest.mark.parametrize("calibrated", [False, True])
def test_sharded_gauss_newton_on_one_card_matches_the_unsharded_solve(cuda, calibrated):
    """`gauss_newton_sharded` over the one-card (4, 2) mesh against
    `gauss_newton` on a 5-keyframe graph (8 edges, two a consecutive pair)
    of one point cloud, initial poses perturbed; within 1e-4, and both near
    the true poses."""
    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.slam import backend

    g = torch.Generator().manual_seed(4)
    P, h, w = 5, 24, 32
    K = torch.tensor([[30.0, 0, 16.0], [0, 30.0, 12.0], [0, 0, 1.0]])
    if calibrated:  # every camera sees the cloud at one pixel grid: true poses identity
        vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        z = 3.0 + torch.sin(uu * 0.3) * torch.cos(vv * 0.2)
        Wd = torch.stack([(uu - 16.0) / 30.0 * z, (vv - 12.0) / 30.0 * z, z], -1).reshape(-1, 3)
        xi = torch.zeros(P, 7)
    else:
        Wd = torch.randn(h * w, 3, generator=g) * torch.tensor([1.0, 1.0, 0.4]) \
            + torch.tensor([0.0, 0.0, 4.0])
        xi = 0.1 * torch.randn(P, 7, generator=g)
        xi[0] = 0.0
    T_true = lie.sim3_exp(xi)
    Xs = lie.sim3_act(lie.sim3_inv(T_true)[:, None], Wd[None])
    pert = 0.03 * torch.randn(P, 7, generator=g)
    pert[0] = 0.0
    T_init = lie.sim3_retr(T_true, pert)
    ii = torch.tensor(list(range(P - 1)) + list(range(1, P)))
    jj = torch.tensor(list(range(1, P)) + list(range(P - 1)))
    E, hw = ii.shape[0], h * w
    args = [t.to(cuda) for t in (
        T_init, Xs, torch.full((P, hw, 1), 10.0), ii, jj,
        torch.arange(hw).expand(E, hw), torch.ones(E, hw, dtype=torch.bool),
        torch.full((E, hw), 4.0), torch.ones(E, dtype=torch.bool))]
    cfg = backend.BackendConfig(max_iters=10)
    kw = dict(n_poses=P, use_calib=calibrated, K=K.to(cuda), img_size=(h, w))
    T_s, _ = backend.gauss_newton_sharded(_one_card_mesh(cuda), *args, cfg, **kw)
    T_u, _ = backend.gauss_newton(*args, cfg, **kw)
    assert T_s.device == T_u.device
    np.testing.assert_allclose(T_s.cpu().numpy(), T_u.cpu().numpy(), atol=1e-4)
    err = torch.linalg.vector_norm(lie.sim3_log(lie.sim3_mul(lie.sim3_inv(T_s.cpu()), T_true)),
                                   dim=-1)
    assert float(err.max()) < 2e-3


@pytest.mark.cuda
def test_sharded_train_step_on_one_card_matches_the_one_device_step(cuda):
    """`train_step` on a (2, 2) grid of this card (`shard_params` weights,
    `batch_sharding` batches) against the one-device step, 3 steps each
    from the same weights and batches, at MAST3R_512 widths (cut depth),
    224x224, batch 4: in f32 (TF32 off) each step held by
    `chip_smoke.train_mesh_step_check` (losses, the first step's gradients,
    the gathered weights; its bounds are stated beside
    `chip_smoke.TRAIN_MESH_LOSS_RTOL`); in bf16 each loss within twice the
    one-device bf16 step's distance from the f32 one's. Kernel A launches (2 encoder + 4 decoder
    blocks' worth) x dp x tp times a sharded step on its dtype's route, at
    (2, 8, 196, 64) and (2, 6, 196, 64), never giving way to another path,
    its output at each shape within `attention.error_bound` of the plain
    version (`chip_smoke.recorded_attention_shapes`)."""
    import dataclasses

    import chip_smoke
    import train_torch
    from monst3r_slam_torch.models.config import MAST3R_512
    from monst3r_slam_torch.models.init import init_params
    from monst3r_slam_torch.parallel.mesh import batch_sharding, make_mesh, shard_params
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer, train_step

    cfg = dataclasses.replace(MAST3R_512, enc_depth=2, dec_depth=2)
    mesh = make_mesh(devices=[cuda] * 4)
    losses = {}
    for dtype, route in ((torch.float32, "f32"), (torch.bfloat16, "bf16_tc")):
        params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
        sharded = init_train_state(shard_params(params, mesh), make_optimizer())
        one = init_train_state(params, make_optimizer())
        for i in range(3):
            batch = train_torch.synthetic_batch(i, 4, 224, 224, cuda)
            one, l1 = train_step(one, cfg, batch, dtype=dtype)
            before = attention.fused_attention.route_launches[route]
            shapes = {}
            with chip_smoke.recorded_attention_shapes(shapes):
                sharded, l2 = train_step(sharded, cfg, {k: batch_sharding(mesh, t)
                                                        for k, t in batch.items()},
                                         dtype=dtype, mesh=mesh)
            torch.cuda.synchronize()
            assert (attention.fused_attention.route_launches[route] - before
                    == (2 * cfg.enc_depth + 4 * cfg.dec_depth) * 4)
            assert sorted(shapes) == [(2, 6, 196, 64), (2, 8, 196, 64)]
            assert all(err <= tol for err, tol in shapes.values()), shapes
            losses[dtype, i] = (float(l1), float(l2))
            if dtype == torch.float32:
                check = chip_smoke.train_mesh_step_check(one.params, sharded.params, mesh, i + 1,
                                                         (float(l1), float(l2)))
                assert check["ok"], check
    for i in range(3):
        (f32, _), (one, got) = losses[torch.float32, i], losses[torch.bfloat16, i]
        assert abs(got - one) <= 2 * abs(one - f32), (i, losses)


@pytest.mark.cuda
def test_kernels_launch_on_every_card(cuda):
    """With the current device left at card 0, kernels A and B on tensors of
    each card launch there and give card 0's result: each library sets its
    kernels' shared-memory attribute on every card at its first launch
    there, and each wrapper launches on its tensors' card. Needs two cards
    or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more: a launch on a second card")
    rng = np.random.default_rng(0)
    qkv = [torch.from_numpy(rng.standard_normal((2, 3, 130, 64), dtype=np.float32))
           .to(torch.bfloat16) for _ in range(3)]
    targs = _tile_args(cuda, 7, 24, 6)
    ref_a = attention.sdpa(*(t.to("cuda:0") for t in qkv))
    ref_b = matching_pallas.tile_match_kernel(*_kernel_args([t.to("cuda:0") for t in targs]))
    for c in range(1, n):
        dev = torch.device("cuda", c)
        before = (attention.fused_attention.launches, matching_pallas.tile_match_kernel.launches)
        got_a = attention.sdpa(*(t.to(dev) for t in qkv))
        got_b = matching_pallas.tile_match_kernel(*_kernel_args([t.to(dev) for t in targs]))
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        assert (attention.fused_attention.launches,
                matching_pallas.tile_match_kernel.launches) == (before[0] + 1, before[1] + 1)
        assert got_a.device == dev and torch.equal(got_a.cpu(), ref_a.cpu())
        assert all(g.device == dev and torch.equal(g.cpu(), r.cpu())
                   for g, r in zip(got_b, ref_b))
