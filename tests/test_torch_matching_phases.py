"""Kernel B's phase split on the CPU: `tile_match_plain(..., phase=)`, the
plain version of the phase instantiations of `csrc/tile_match.cu` and the
port's counterpart of the TPU phase profiler `scripts/profile_pallas_phases.py`.

  * "ray" equals a numpy argmax of the same f32 dot taken in the same order,
    (qx*rx + qy*ry) + qz*rz (numpy rounds each product and sum: no FMA);
  * "stencil"'s convergence flags and "full"'s (u, v, conv) against the JAX
    package's `tile_match_pallas` in interpret mode, on the inputs of
    tests/test_torch_matching.py::test_tile_match_plain_matches_pallas_interpret;
  * "full" is the default call, bit for bit; "stage" gives the corners.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.ops import matching_pallas as jmp
from monst3r_slam_torch.ops import matching_pallas as tmp

H, W, CROP, T, TSZ, FD, WINDOW, THRESH = 64, 80, 48, 6, 256, 24, 15, 1e-6
CORNERS = np.asarray([[-5, 3], [40, 40], [17, 9], [79, 63], [0, 0], [31, 15]], np.int32)


def _inputs(seed):
    """The inputs of test_tile_match_plain_matches_pallas_interpret: random
    unit rays and descriptors, corners that need clipping and 16-alignment,
    exact ray peaks on the crop's first row."""
    rng = np.random.default_rng(seed)
    rays = rng.standard_normal((H, W, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    desc = rng.standard_normal((H, W, FD)).astype(np.float32)
    q = rng.standard_normal((T, TSZ, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, :32] = rays[:1, :32]
    qd = rng.standard_normal((T, TSZ, FD)).astype(np.float32)
    return rays, desc, q, qd, CORNERS


def _plain(seed, **kw):
    rays, desc, q, qd, corners = (torch.from_numpy(a) for a in _inputs(seed))
    cq = tmp.quantize_corners(corners, H, W, CROP)
    return tmp.tile_match_plain(rays, desc, q, qd, cq, CROP, WINDOW, THRESH, **kw)


@functools.lru_cache(maxsize=None)
def _pallas(seed):
    ju, jv, jc = jmp.tile_match_pallas(
        *(jnp.asarray(a) for a in _inputs(seed)),
        tcfg=jmp.PallasTileConfig(crop=CROP, window=WINDOW, sub_q=128),
        conv_thresh=THRESH, interpret=True,
    )
    return np.asarray(ju), np.asarray(jv), np.asarray(jc)


def _quantized_corners():
    cx = np.clip(CORNERS[:, 0], 0, W - CROP) & ~15
    cy = np.clip(CORNERS[:, 1], 0, H - CROP) & ~15
    return cx, cy


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_phase_is_the_f32_ray_argmax(seed):
    rays, _, q, _, _ = _inputs(seed)
    cx, cy = _quantized_corners()
    u, v, conv = _plain(seed, phase="ray")
    for t in range(T):
        r = rays[cy[t]:cy[t] + CROP, cx[t]:cx[t] + CROP].reshape(-1, 3)
        qt = q[t][:, None, :]
        s = (qt[..., 0] * r[:, 0] + qt[..., 1] * r[:, 1]) + qt[..., 2] * r[:, 2]
        assert s.dtype == np.float32
        best = np.argmax(s, axis=-1)
        np.testing.assert_array_equal(u[t].numpy(), cx[t] + best % CROP)
        np.testing.assert_array_equal(v[t].numpy(), cy[t] + best // CROP)
    assert not conv.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_stencil_and_full_phases_match_pallas_interpret(seed):
    """Equal on these inputs: the Pallas kernel's split bf16 ray dot drops
    cross terms of order 2^-24, which flips near-ties on other scenes
    (test_torch_matching.py allows 0.5%), but none of these."""
    ju, jv, jc = _pallas(seed)
    _, _, sc = _plain(seed, phase="stencil")
    fu, fv, fc = _plain(seed, phase="full")
    np.testing.assert_array_equal(sc.numpy(), jc)
    np.testing.assert_array_equal(fu.numpy(), ju)
    np.testing.assert_array_equal(fv.numpy(), jv)
    np.testing.assert_array_equal(fc.numpy(), jc)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_phase_is_the_default_call(seed):
    default, full = _plain(seed), _plain(seed, phase="full")
    for a, b in zip(default, full):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_stage_phase_gives_the_corners_and_later_phases_keep_the_ray_match():
    cx, cy = _quantized_corners()
    u, v, conv = _plain(0, phase="stage")
    assert u.dtype == torch.int32 and conv.dtype == torch.bool
    np.testing.assert_array_equal(u.numpy(), np.broadcast_to(cx[:, None], (T, TSZ)))
    np.testing.assert_array_equal(v.numpy(), np.broadcast_to(cy[:, None], (T, TSZ)))
    assert not conv.any()
    ru, rv, _ = _plain(0, phase="ray")
    su, sv, _ = _plain(0, phase="stencil")
    assert torch.equal(ru, su) and torch.equal(rv, sv)


def test_phase_kernel_refuses_cpu_tensors_and_unknown_phases():
    args = (torch.zeros((16, 16, 3)), torch.zeros((16, 16, 24), dtype=torch.bfloat16),
            torch.zeros((1, 4, 3)), torch.zeros((1, 4, 24), dtype=torch.bfloat16),
            torch.zeros((1, 2), dtype=torch.int32), 16, 15, 1e-6)
    with pytest.raises(ValueError):
        tmp.tile_match_phase_kernel(*args, phase="ray")
    with pytest.raises(ValueError):
        tmp.tile_match_phase_kernel(*args, phase="dma")
    with pytest.raises(ValueError):
        tmp.tile_match_plain(*args, phase="dma")
