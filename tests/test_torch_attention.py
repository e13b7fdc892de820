"""Parity of the port's plain attention (`ops/attention.py::sdpa` on CPU
tensors) with the JAX package's Pallas kernel run in interpret mode, at the
shapes of tests/test_attention.py.

Tolerance: atol 2e-5 (rtol 1e-4), as tests/test_attention.py: both compute
an f32 softmax attention over unit-normal inputs; summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.ops import attention as jatt
from monst3r_slam_torch.ops import attention as tatt
from tests.test_torch_slam import one_torch_thread  # noqa: F401

SHAPES = [  # (q shape, k/v shape)
    ((2, 4, 128, 64), (2, 4, 128, 64)),
    ((1, 2, 64, 32), (1, 2, 256, 32)),
    ((1, 3, 48, 64), (1, 3, 80, 64)),  # ragged: neither count a multiple of 64
]


@pytest.mark.parametrize("q_shape,kv_shape", SHAPES)
def test_plain_sdpa_matches_pallas_interpret(q_shape, kv_shape):
    rng = np.random.default_rng(sum(q_shape) + sum(kv_shape))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape))
    ref = jatt.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = tatt.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


# Every head width class kernel A takes: below, at and between its
# instantiations (16, 32, 64, 128, 256); the last case is ragged (Nq != Nk).
WIDTH_CASES = [((1, 2, 64, d), (1, 2, 64, d))
               for d in (8, 12, 16, 24, 32, 48, 80, 96, 128, 160, 256)] + [
    ((1, 3, 48, 12), (1, 3, 80, 12))]


@pytest.mark.parametrize("q_shape,kv_shape", WIDTH_CASES)
def test_plain_sdpa_matches_pallas_interpret_at_every_width(q_shape, kv_shape):
    """The reference's kernel reads d from q's shape; the port's plain
    version matches it at every width kernel A takes (1-256), f32, to the
    tolerance of tests/test_attention.py."""
    rng = np.random.default_rng(sum(q_shape) + sum(kv_shape))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape))
    ref = jatt.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = tatt.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("d", [16, 12])
def test_plain_sdpa_bf16_casts_probs_like_jax_at_tiny_widths(d):
    """TINY's encoder (16) and decoder (12) head widths in bf16: the same
    rounding points as JAX's XLA path, to one bf16 ulp of the output."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 2, 96, d)).astype(np.float32) for _ in range(3))
    ref = jatt.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), use_pallas=False)
    got = tatt.sdpa(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=8e-3)


# Above 256 the wide variant runs multiples of 64 in column slices of 256:
# the slices kernel A plans at each wide width of the test below.
WIDE_SLICES = {257: 2, 300: 2, 320: 2, 384: 2, 512: 2, 1024: 4}


@pytest.mark.parametrize("d,width", [(1, 16), (8, 16), (12, 16), (16, 16), (24, 32), (33, 64),
                                     (48, 64), (64, 64), (80, 128), (96, 128), (127, 128),
                                     (129, 256), (160, 256), (192, 256), (256, 256),
                                     (257, 320), (300, 320), (320, 320), (384, 384), (512, 512),
                                     (1024, 1024)])
def test_padded_heads_give_the_unpadded_attention(d, width):
    """`pad_heads` pads q, k and v with zero columns to kernel A's next
    instantiation, above 256 to the next multiple of 64, which the wide
    variant runs in `column_slices` slices of 256 columns; attention over
    the padded heads scaled by the true width's d^-1/2 and sliced back to d
    columns is attention over the originals, within 1e-6 (f32: the zero
    products add exact zeros; only the matmuls' blocking may differ)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, d), dtype=np.float32))
               for n in (40, 56, 56))
    qp, kp, vp = tatt.pad_heads(q, k, v, tatt.padded_width(d))
    assert tatt.padded_width(d) == width
    assert tatt.column_slices(d) == WIDE_SLICES.get(d, 1)
    assert all(t.shape[-1] == width for t in (qp, kp, vp))
    assert all(torch.equal(t[..., :d], s) and not t[..., d:].any()
               for t, s in ((qp, q), (kp, k), (vp, v)))
    got = tatt.sdpa_plain(qp, kp, vp, scale=d**-0.5)[..., :d]
    np.testing.assert_allclose(got.numpy(), tatt.sdpa_plain(q, k, v).numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 40, 320), (1, 1, 24, 512)])
def test_sdpa_matches_pallas_interpret_at_wide_heads(shape, dtype):
    """Heads wider than 256, which the reference's kernel takes (it reads d
    from q's shape): the port's dispatch on the CPU against the Pallas
    kernel in interpret mode, in f32 within 1e-5 and in bf16 (the same
    rounding points: f32 logits, probabilities rounded to bf16) to one bf16
    ulp of the output, as `test_plain_sdpa_bf16_casts_probs_like_jax`."""
    rng = np.random.default_rng(shape[-1])
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = jatt.fused_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)), interpret=True)
    got = tatt.sdpa(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-5 if dtype == "float32" else 8e-3, rtol=0)


def test_plain_sdpa_bf16_casts_probs_like_jax():
    """bf16 inputs: f32 logits/softmax, probabilities rounded to bf16 before
    the PV product, bf16 output — the same rounding points as the JAX XLA
    path, so the two agree to one bf16 ulp of the output."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 96, 64)).astype(np.float32) for _ in range(3))
    ref = jatt.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), use_pallas=False)
    got = tatt.sdpa(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=8e-3)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError):
        tatt.fused_attention(x, x, x)


def _kernel_a_arithmetic(q, k, v, bf16_logits=False):
    """Kernel A's bf16 route emulated on the CPU, step for step: f32 logits
    (or, with `bf16_logits`, logits rounded to bf16 as a kernel that skipped
    the f32 accumulator would give), 64-key tiles with a running max in log2
    units, each tile's probabilities rounded to bf16 before the PV product,
    the sum kept in f32, the output divided once and rounded to bf16."""
    s = q.float() @ k.float().transpose(-1, -2)
    if bf16_logits:
        s = s.to(torch.bfloat16).float()
    s = s * (q.shape[-1] ** -0.5 / np.log(2.0))
    m = torch.full(s.shape[:-1] + (1,), -np.inf)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    l = torch.zeros(s.shape[:-1] + (1,))
    for k0 in range(0, s.shape[-1], 64):
        t = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        c = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + p.to(torch.bfloat16).float() @ v[..., k0:k0 + 64, :].float()
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("logit_scale", [1, 8])
@pytest.mark.parametrize("nq,nk", [(768, 768), (196, 196), (48, 80), (130, 7)])
def test_error_bound_admits_the_kernels_roundings(nq, nk, logit_scale):
    """`error_bound` (the card's tolerance for kernel A's bf16 route) admits
    the kernel's own arithmetic, emulated, at the card tests' shapes, with
    unit logits and with logits 8x larger (a peaked softmax)."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, 64), dtype=np.float32))
               .to(torch.bfloat16) for n in (nq, nk, nk))
    q = q * logit_scale
    ref = tatt.sdpa_plain(q.float(), k.float(), v.float())
    err = float((_kernel_a_arithmetic(q, k, v).float() - ref).abs().max())
    assert err <= tatt.error_bound(q, k, v, ref)


@pytest.mark.parametrize("nq,nk", [(768, 768), (196, 196), (48, 80), (130, 7)])
def test_error_bound_refuses_bf16_logits(nq, nk):
    """With large logits (8x unit scale), a kernel that rounded its logits
    to bf16 instead of keeping them in f32 falls outside `error_bound`."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, 64), dtype=np.float32))
               .to(torch.bfloat16) for n in (nq, nk, nk))
    q = q * 8
    ref = tatt.sdpa_plain(q.float(), k.float(), v.float())
    err = float((_kernel_a_arithmetic(q, k, v, bf16_logits=True).float() - ref).abs().max())
    assert err > tatt.error_bound(q, k, v, ref)


def _kernel_a_f32_arithmetic(q, k, v, split):
    """Kernel A's f32 route emulated on the CPU: f32 logits in log2 units
    (scale d^-1/2 log2(e) on the raw scores), 16-key tiles with a running
    max per row, the tiles split into `split` contiguous shares as the CTAs
    of a cluster take them, each share's unnormalized (O, max, sum), and the
    shares merged with weights 2^(max_g - max) and divided once. exp2 is
    torch's (the card's ex2.approx is within 2 ulp of it)."""
    scale_log2 = np.float32(q.shape[-1] ** -0.5 * np.log2(np.e))
    s = q @ k.transpose(-1, -2)
    nk, ntiles = s.shape[-1], -(-s.shape[-1] // 16)
    parts = []
    for g in range(split):
        m = torch.full(s.shape[:-1] + (1,), -np.inf)
        acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
        l = torch.zeros(s.shape[:-1] + (1,))
        for t in range(g * ntiles // split, (g + 1) * ntiles // split):
            sl = slice(16 * t, min(16 * t + 16, nk))
            m_new = torch.maximum(m, s[..., sl].amax(-1, keepdim=True) * scale_log2)
            c = torch.exp2(m - m_new)
            p = torch.exp2(s[..., sl] * scale_log2 - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            acc = acc * c + p @ v[..., sl, :]
            m = m_new
        parts.append((acc, m, l))
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [torch.exp2(m - mx) for _, m, _ in parts]
    total = sum(wg * l for wg, (_, _, l) in zip(w, parts))
    return sum(wg * acc for wg, (acc, _, _) in zip(w, parts)) / total


@pytest.mark.parametrize("logit_scale", [1, 8])
@pytest.mark.parametrize("shape,nk,split", [((2, 3, 768, 64), 768, 6), ((2, 3, 768, 64), 768, 3),
                                            ((2, 8, 196, 64), 196, 7), ((2, 3, 65, 64), 769, 8),
                                            ((2, 3, 129, 64), 7, 1)])
def test_error_bound_admits_the_f32_routes_arithmetic(shape, nk, split, logit_scale):
    """`error_bound`'s 2e-5 (the card's tolerance for kernel A's f32 route)
    admits the route's own arithmetic, emulated, with its key tiles split
    among a cluster's CTAs as the card splits them at these shapes, with
    unit logits and with logits 8x larger (a peaked softmax)."""
    rng = np.random.default_rng(shape[2] + nk + split)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape[:2] + (n, 64), dtype=np.float32))
               for n in (shape[2], nk, nk))
    q = q * logit_scale
    ref = tatt.sdpa_plain(q, k, v)
    err = float((_kernel_a_f32_arithmetic(q, k, v, split) - ref).abs().max())
    assert err <= tatt.error_bound(q, k, v, ref)


def _tf32_split(x):
    """An f32 tensor split into TF32 parts as kernel A's f32 tensor-core
    route splits it (cvt.rna.tf32.f32: half a TF32 ulp added to the
    magnitude's bits, the 13 low bits cleared): (big, small) with big =
    rna(x) and small = rna(x - big), both f32 tensors."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def _toward_zero(x):
    """f64 values rounded to f32 toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_3xtf32(a, b, span):
    """a @ b as the kernel sums it: a and b split into TF32 parts; for each
    k8 block of the product the three terms small_a big_b, big_a small_b and
    big_a big_b, each summed exactly over the block (products of TF32 values
    are exact in f64) and added in turn to an f32 accumulator, rounded
    toward zero, as three mma.sync m16n8k8 chain (the H100's tensor cores
    round an mma's sum toward zero); each `span` of the k dimension summed
    so from zero and the spans added in f32, as the kernel adds its chunk
    sums (of 32 columns of d) to S and its V steps' sums to O."""
    (ab, as_), (bb, bs) = _tf32_split(a), _tf32_split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c0 in range(0, a.shape[-1], span):
        part = torch.zeros_like(out)
        for k0 in range(c0, min(c0 + span, a.shape[-1]), 8):
            blk = slice(k0, k0 + 8)
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                part = _toward_zero(part.double() + x[..., blk].double() @ y[..., blk, :].double())
        out = out + part
    return out


def _kernel_a_tf32_arithmetic(q, k, v, split):
    """Kernel A's f32 tensor-core route emulated on the CPU: S = Q K^T in
    3xTF32 (`_mma_3xtf32`) over 32-column chunks of d, in log2 units (scale
    d^-1/2 log2(e) on the raw scores); key tiles of 32 keys with a running
    max per row; P kept in f32, split again for O += P V in 3xTF32 over V
    steps of 16 keys; the tiles split into `split` contiguous shares as the
    CTAs of a cluster take them, each share's unnormalized (O, max, sum),
    merged with weights 2^(max_g - max) and divided once. Above 256
    columns O is computed in `column_slices` slices, whose S (shared among
    them, or past 16 slices recomputed by each) is summed in one order:
    each slice's share of d's 32-column chunks from zero, the shares added
    in slice order; O's slices change nothing else."""
    d = q.shape[-1]
    bn, vk, kc = 32, 16, 32
    scale_log2 = np.float32(d ** -0.5 * np.log2(np.e))
    nk = k.shape[-2]
    ntiles = -(-nk // bn)
    chunks, slices = -(-d // kc), tatt.column_slices(d, torch.float32)
    s = 0
    for i in range(slices):
        cols = slice(kc * (i * chunks // slices), kc * ((i + 1) * chunks // slices))
        s = s + _mma_3xtf32(q[..., cols], k.transpose(-1, -2)[..., cols, :], 32)
    parts = []
    for g in range(split):
        m = torch.full(s.shape[:-1] + (1,), -np.inf)
        acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
        l = torch.zeros(s.shape[:-1] + (1,))
        for t in range(g * ntiles // split, (g + 1) * ntiles // split):
            sl = slice(bn * t, min(bn * t + bn, nk))
            m_new = torch.maximum(m, s[..., sl].amax(-1, keepdim=True) * scale_log2)
            c = torch.exp2(m - m_new)
            p = torch.exp2(s[..., sl] * scale_log2 - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            acc = acc * c
            for j0 in range(0, p.shape[-1], vk):
                acc = acc + _mma_3xtf32(p[..., j0:j0 + vk], v[..., sl, :][..., j0:j0 + vk, :], vk)
            m = m_new
        parts.append((acc, m, l))
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [torch.exp2(m - mx) for _, m, _ in parts]
    total = sum(wg * l for wg, (_, _, l) in zip(w, parts))
    return sum(wg * acc for wg, (acc, _, _) in zip(w, parts)) / total


def test_tf32_split_rounds_as_cvt_rna():
    """The split's rounding is round-to-nearest with ties away from zero at
    TF32's 10 fraction bits, and big + small recovers x to within 2^-22 of
    its magnitude."""
    one_ulp = 2.0**-10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2**-23,
                      1 + 1.5 * one_ulp, 3.0, 0.0], dtype=torch.float32)
    big, small = _tf32_split(x)
    assert big.tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, 0.0]
    assert small.tolist() == [-one_ulp / 2, one_ulp / 2, one_ulp / 2, -one_ulp / 2,
                              0.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096, dtype=np.float32))
    big, small = _tf32_split(y)
    assert float(((big.double() + small.double() - y.double()).abs() / y.abs().double()).max()) \
        <= 2.0**-22


# (q shape, key count, the split the H100's plan (`plan_for` in
# csrc/attention.cu, with the card's cluster counts) takes at these shapes).
TF32_CASES = [((1, 1, 384, 80), 384, 6), ((1, 1, 384, 128), 384, 6), ((1, 1, 384, 160), 384, 6),
              ((1, 1, 384, 256), 384, 6), ((1, 1, 65, 256), 769, 7), ((1, 1, 196, 1024), 196, 4),
              ((1, 4, 196, 1024), 196, 2), ((1, 2, 384, 512), 384, 4),
              ((1, 1, 128, 4100), 128, 4), ((1, 1, 128, 5000), 128, 4)]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("logit_scale", [1, 8])
@pytest.mark.parametrize("shape,nk,split", TF32_CASES)
def test_error_bound_admits_the_f32_tensor_core_routes_arithmetic(shape, nk, split, logit_scale):
    """`error_bound`'s 2e-5 (the card's tolerance for kernel A's f32 route)
    admits the tensor-core route's 3xTF32 arithmetic, emulated, against the
    f64 plain version (`reference`) at widths 80, 128, 160, 256, 512,
    1,024 (196 tokens), 4,100 and 5,000 (17 and 20 slices, each
    recomputing S), with its key tiles split among a cluster's CTAs as the
    card plans these shapes and its slices sharing S above 256 columns up
    to 16 slices, with unit logits and with logits 8x larger (a peaked
    softmax)."""
    rng = np.random.default_rng(shape[2] + nk + shape[3])
    q, k, v = (torch.from_numpy(rng.standard_normal(shape[:2] + (n, shape[3]), dtype=np.float32))
               for n in (shape[2], nk, nk))
    q = q * logit_scale
    assert tatt.route(q.dtype, shape[3]) == "f32_tc"
    ref = tatt.reference(q, k, v)
    assert ref.dtype == torch.float64
    err = float((_kernel_a_tf32_arithmetic(q, k, v, split).double() - ref).abs().max())
    assert err <= tatt.error_bound(q, k, v, ref)


@pytest.mark.parametrize("widths", [(1, 257), (257, 2049)], ids=["to256", "above256"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_routes_and_pads_every_width(dtype, widths):
    """For each head width 1-2,048: the route kernel A takes, the
    instantiation it runs on, whether it reads the head in place and the
    width it reads, and whether `pad_heads` copies contiguous inputs there.
    bf16: the tensor-core kernel at its instantiations, above 256 the wide
    variant (its chunks cover the next multiple of 64), every multiple of
    8 read in place, any other width padded to the next one. f32: the FFMA
    kernel at 16, 32 and 64, the tensor-core kernel above 64, every
    multiple of 4 read in place, any other width padded to the next one."""
    align = 8 if dtype == torch.bfloat16 else 4
    for d in range(*widths):
        if dtype == torch.bfloat16:
            want_route = "bf16_tc"
            want = (next(w for w in tatt.HEAD_DIMS if d <= w) if d <= 256
                    else -(-d // 64) * 64)
        elif d <= 64:
            want_route, want = "f32", next(w for w in (16, 32, 64) if d <= w)
        else:
            want_route, want = "f32_tc", -(-d // 4) * 4
        assert tatt.route(dtype, d) == want_route, d
        assert tatt.padded_width(d, dtype) == want, d
        assert tatt.reads_in_place(d, dtype) == (d % align == 0), d
        width = tatt.read_width(d, dtype)
        assert width == -(-d // align) * align and width <= tatt.padded_width(d, dtype), d
        x = torch.zeros((1, 1, 2, d), dtype=dtype)
        copies = tatt.pad_heads.copies
        qp, kp, vp = tatt.pad_heads(x, x, x, width)
        assert tatt.pad_heads.copies - copies == (not tatt.reads_in_place(d, dtype)), d
        assert all(t.shape[-1] == width and (t is x) == (width == d) for t in (qp, kp, vp)), d
    assert tatt.column_slices(2000) == 8 and tatt.column_slices(257) == 2
    assert tatt.column_slices(264) == 2 and tatt.column_slices(256) == 1


# The models' attention layouts: (config, which attention, heads) -> head
# width, at the TINY config and at MAST3R_512 re-headed (a checkpoint's
# constructor string) to 4, 2 and 1 heads.
QKV_LAYOUTS = [("TINY", "encoder", 4, 16), ("TINY", "decoder", 4, 12),
               ("MAST3R_512/4", "encoder", 4, 256), ("MAST3R_512/4", "decoder", 4, 192),
               ("MAST3R_512/2", "encoder", 2, 512), ("MAST3R_512/2", "decoder", 2, 384),
               ("MAST3R_512/1", "encoder", 1, 1024), ("MAST3R_512/1", "decoder", 1, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config,which,heads,hd", QKV_LAYOUTS)
def test_copy_predicate_on_the_models_qkv_layouts(config, which, heads, hd, dtype):
    """q, k and v as `models/blocks.py`'s self-attention splits its fused
    projection (transposed views of one (B, N, 3 H hd) output, v never
    copied before the kernel): kernel A reads them in place, with no
    copy by `sdpa` (`readable`) or by the padding (`reads_in_place`),
    everywhere but at TINY's decoder in bf16, whose 12-wide heads start 24
    bytes apart (in f32 48 bytes: read in place)."""
    from monst3r_slam_torch.models import blocks, config as mcfg

    cfg = mcfg.TINY if config == "TINY" else mcfg.MAST3R_512
    width = cfg.enc_dim if which == "encoder" else cfg.dec_dim
    assert width // heads == hd
    qkv = torch.zeros((2, 9, 3 * width), dtype=dtype)
    q, k, v = (blocks._heads_split(t, heads) for t in qkv.chunk(3, dim=-1))
    assert q.shape == (2, heads, 9, hd) and not v.is_contiguous()
    copies = not (tatt.reads_in_place(hd, dtype) and all(tatt.readable(t) for t in (q, k, v)))
    assert copies == (config == "TINY" and which == "decoder" and dtype == torch.bfloat16)
