"""Kernels A (attention, both routes) and B (tile matcher, and its phase
instantiations) on the card against their plain versions, through the
dispatch the model and the matcher call.

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


@pytest.mark.cuda
@pytest.mark.parametrize("seed,fd", [(0, 24), (1, 16)])
def test_tile_match_kernel_matches_plain(cuda, seed, fd):
    """Random rays and descriptors, corners that need clipping and
    16-alignment, and exact ray peaks on a crop border (the stencil's wrap
    and zero rules). Both do the same arithmetic in the same order: equal."""
    rng = np.random.default_rng(seed)
    h, w, crop, T, tsz = 64, 80, 48, 6, 256
    rays = rng.standard_normal((h, w, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, tsz, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, :32] = rays[:1, :32]
    corners = np.asarray([[-5, 3], [40, 40], [17, 9], [79, 63], [0, 0], [31, 15]], np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rays, rng.standard_normal((h, w, fd)).astype(np.float32), q,
        rng.standard_normal((T, tsz, fd)).astype(np.float32), corners)]
    tcfg = matching_pallas.PallasTileConfig(crop=crop, window=15)
    before = matching_pallas.tile_match_kernel.launches
    u, v, conv = matching_pallas.tile_match(*args, tcfg=tcfg, conv_thresh=1e-6)
    torch.cuda.synchronize()
    assert matching_pallas.tile_match_kernel.launches == before + 1
    cq = matching_pallas.quantize_corners(args[4], h, w, crop)
    u0, v0, c0 = matching_pallas.tile_match_plain(args[0], args[1], args[2], args[3], cq,
                                                  crop, 15, 1e-6)
    assert torch.equal(u, u0) and torch.equal(v, v0) and torch.equal(conv, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", matching_pallas.PHASES)
def test_tile_match_phase_kernel_matches_plain(cuda, phase):
    """Each phase instantiation of kernel B against the plain version cut at
    the same point: the same arithmetic in the same order, so equal."""
    rng = np.random.default_rng(2)
    h, w, crop, T, tsz, fd = 64, 80, 48, 6, 256, 24
    rays = rng.standard_normal((h, w, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, tsz, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    corners = np.asarray([[-5, 3], [40, 40], [17, 9], [79, 63], [0, 0], [31, 15]], np.int32)
    rays_t, q_t = torch.from_numpy(rays).to(cuda), torch.from_numpy(q).to(cuda)
    desc = torch.from_numpy(rng.standard_normal((h, w, fd)).astype(np.float32)).to(cuda, torch.bfloat16)
    qd = torch.from_numpy(rng.standard_normal((T, tsz, fd)).astype(np.float32)).to(cuda, torch.bfloat16)
    cq = matching_pallas.quantize_corners(torch.from_numpy(corners).to(cuda), h, w, crop)
    args = (rays_t, desc, q_t, qd, cq, crop, 15, 1e-6)
    before = matching_pallas.tile_match_phase_kernel.launches
    got = matching_pallas.tile_match_phase_kernel(*args, phase=phase)
    torch.cuda.synchronize()
    assert matching_pallas.tile_match_phase_kernel.launches == before + 1
    ref = matching_pallas.tile_match_plain(*args, phase=phase)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
