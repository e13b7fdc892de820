"""Kernels A (attention, both routes) and B (tile matcher, and its phase
instantiations) on the card against their plain versions, through the
dispatch the model and the matcher call; and the dynamic pipeline's parts
on the card: RAFT against its CPU path, the fused flow program's readback
ordering around `overlap_cb`, and the dual decode's kernel A launches.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,logit_scale", [(torch.float32, 1), (torch.bfloat16, 1),
                                               (torch.bfloat16, 8)])
@pytest.mark.parametrize("nq,nk", [(768, 768), (196, 196), (48, 80), (130, 7)])
def test_attention_kernel_matches_plain(cuda, dtype, logit_scale, nq, nk):
    """Both routes at the main path's 768 tokens, at a 224x224 image's 196,
    and at ragged counts below and across one 64-row tile, within
    `attention.error_bound` (f32: 2e-5; bf16: from its two bf16 roundings,
    of P and of O). In bf16 also with logits 8x the unit scale (a peaked
    softmax), where logits rounded to bf16 would exceed the bound
    (tests/test_torch_attention.py shows that on the kernel's arithmetic
    emulated on the CPU)."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, 64), dtype=np.float32))
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
    contiguous, and in bf16 a start that is not 16-byte aligned or a row
    stride that is not a multiple of 8."""
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
    ok = torch.zeros((1, 2, 100, 64), device=cuda, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 100 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].reshape(1, 2, 100, 64)
    wide = torch.zeros((1, 2, 100, 68), device=cuda, dtype=torch.bfloat16)[..., :64]
    for bad in (odd, wide):
        with pytest.raises(ValueError):
            attention.fused_attention(ok, ok, bad)


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
