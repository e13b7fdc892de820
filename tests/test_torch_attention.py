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
