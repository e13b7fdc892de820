"""Parity of the port's matchers with the JAX package's, on the scenes of
tests/test_matching_tiled.py:
  * `tiled` mode (plain PyTorch) against `match_tiled(use_pallas=False)`;
  * `kernel` mode (kernel B's plain version on CPU tensors) against
    `match_tiled(use_pallas=True)`, which runs the Pallas kernel in
    interpret mode.

Tolerance: indices and valid masks identical on >= 99.5% of pixels. The
argmax and the convergence test compare f32 scores; near-ties can flip
between the two frameworks' summation orders (and the TPU kernel's split
dot drops cross terms of order 2^-24).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.ops import matching as jm
from monst3r_slam_tpu.ops import matching_pallas as jmp
from monst3r_slam_tpu.ops import matching_tiled as jmt
from monst3r_slam_torch.ops import matching as tm
from monst3r_slam_torch.ops import matching_pallas as tmp
from monst3r_slam_torch.ops import matching_tiled as tmt
from tests.test_matching import make_smooth_pointmap

AGREE = 0.995


def _desc(seed, h, w, f=24):
    D = np.random.default_rng(seed).standard_normal((1, h, w, f)).astype(np.float32)
    return D / np.linalg.norm(D, axis=-1, keepdims=True)


def _scene(h, w, s):
    X = np.asarray(make_smooth_pointmap(jax.random.PRNGKey(0), h, w))
    D = _desc(1, h, w)
    return X, np.roll(X, -s, axis=2), D, np.roll(D, -s, axis=2)


SCENES = {  # name: (h, w, shift, crop, warm start)
    "shifted": (32, 48, 3, 32, False),
    "self": (32, 48, 0, 32, False),
    "large_shift": (48, 64, 21, 32, False),
    "stale_warm": (48, 96, 40, 32, True),
    "warm_64x80": (64, 80, 2, 48, True),
}


@pytest.mark.parametrize("mode", ["tiled", "kernel"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_match_matches_jax(scene, mode):
    h, w, s, crop, warm = SCENES[scene]
    X, X21, D, D21 = _scene(h, w, s)
    init = np.broadcast_to(np.arange(h * w), (1, h * w)).copy() if warm else None
    jcfg, tcfg = jm.MatchingConfig(radius=1, dilation_max=2), tm.MatchingConfig(radius=1, dilation_max=2)
    jt = jmt.TiledConfig(tile=16, crop=crop, chunk_tiles=8)
    tt = tmt.TiledConfig(tile=16, crop=crop, chunk_tiles=8)
    ij, vj = jmt.match(*(jnp.asarray(a) for a in (X, X21, D, D21)),
                       None if init is None else jnp.asarray(init, jnp.int32),
                       cfg=jcfg, tcfg=jt, use_pallas=mode == "kernel")
    it, vt = tmt.match(*(torch.from_numpy(a.copy()) for a in (X, X21, D, D21)),
                       None if init is None else torch.from_numpy(init),
                       cfg=tcfg, tcfg=tt, use_kernel=mode == "kernel")
    assert tuple(it.shape) == ij.shape and tuple(vt.shape) == vj.shape
    assert (it.numpy() == np.asarray(ij)).mean() >= AGREE
    assert (vt.numpy() == np.asarray(vj)).mean() >= AGREE
    assert vt.numpy().mean() > 0.5  # the scene really matches


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_match_plain_matches_pallas_interpret(seed):
    """Kernel B's plain version against the Pallas kernel on random rays and
    descriptors, with corners that need clipping and 16-alignment and ray
    peaks on crop borders (the flat-neighbour stencil's wrap/zero rules)."""
    rng = np.random.default_rng(seed)
    h, w, crop, T, tsz, fd = 64, 80, 48, 6, 256, 24
    rays = rng.standard_normal((h, w, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    desc = rng.standard_normal((h, w, fd)).astype(np.float32)
    q = rng.standard_normal((T, tsz, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, :32] = rays[:1, :32]  # exact peaks on the crop's first row
    qd = rng.standard_normal((T, tsz, fd)).astype(np.float32)
    corners = np.asarray([[-5, 3], [40, 40], [17, 9], [79, 63], [0, 0], [31, 15]], np.int32)
    ju, jv, jc = jmp.tile_match_pallas(
        jnp.asarray(rays), jnp.asarray(desc), jnp.asarray(q), jnp.asarray(qd),
        jnp.asarray(corners), tcfg=jmp.PallasTileConfig(crop=crop, window=15, sub_q=128),
        conv_thresh=1e-6, interpret=True,
    )
    tu, tv, tc = tmp.tile_match(
        torch.from_numpy(rays), torch.from_numpy(desc), torch.from_numpy(q),
        torch.from_numpy(qd), torch.from_numpy(corners),
        tcfg=tmp.PallasTileConfig(crop=crop, window=15), conv_thresh=1e-6,
    )
    assert tu.dtype == torch.int32 and tc.dtype == torch.bool
    assert (tu.numpy() == np.asarray(ju)).mean() >= AGREE
    assert (tv.numpy() == np.asarray(jv)).mean() >= AGREE
    assert (tc.numpy() == np.asarray(jc)).mean() >= AGREE


def test_median_averages_middle_pair_like_jnp():
    x = np.random.default_rng(3).integers(0, 50, (7, 64, 2)).astype(np.float32)
    np.testing.assert_array_equal(tmt._median(torch.from_numpy(x), dim=1).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=1)))


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        tmp.tile_match_kernel(torch.zeros((16, 16, 3)), torch.zeros((16, 16, 24)), z,
                              torch.zeros((1, 4, 24)), torch.zeros((1, 2), dtype=torch.int32),
                              16, 15, 1e-6)


# (crop, fd, queries a tile, image width): the shapes the reference's kernel
# takes beyond the main path's, which the card runs through kernel B's
# banded variant: `PallasTileConfig()`'s own crop of 64, fd 64 and the
# reference's widest 119, 1,024 queries a tile (tile 32, eight of its
# `sub_q` blocks) and a crop that is no multiple of 4; and an image width
# that is no multiple of 4 (110), which the card reads through a pitched
# copy (`pad_pitch`).
WIDE_CASES = [(64, 24, 256, 112), (48, 64, 256, 112), (64, 119, 256, 112), (48, 24, 1024, 112),
              (50, 24, 256, 112), (48, 24, 256, 110)]


@pytest.mark.parametrize("crop,fd,tsz,w", WIDE_CASES,
                         ids=[f"{c}-{f}-{t}" + ("" if w == 112 else f"-w{w}")
                              for c, f, t, w in WIDE_CASES])
def test_tile_match_plain_matches_pallas_interpret_at_wide_shapes(crop, fd, tsz, w):
    """Kernel B's plain version against the Pallas kernel at `WIDE_CASES` on
    a 96 x w target with 2 tiles, corners that need clipping and
    16-alignment and exact ray peaks on a crop row; the tolerance of
    `test_tile_match_plain_matches_pallas_interpret`."""
    rng = np.random.default_rng(crop + fd + tsz + w - 112)
    h, T = 96, 2
    rays = rng.standard_normal((h, w, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    desc = rng.standard_normal((h, w, fd)).astype(np.float32)
    q = rng.standard_normal((T, tsz, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, :32] = rays[:1, :32]
    qd = rng.standard_normal((T, tsz, fd)).astype(np.float32)
    corners = np.asarray([[-5, 3], [70, 50]], np.int32)
    ju, jv, jc = jmp.tile_match_pallas(
        jnp.asarray(rays), jnp.asarray(desc), jnp.asarray(q), jnp.asarray(qd),
        jnp.asarray(corners), tcfg=jmp.PallasTileConfig(crop=crop, window=15, sub_q=128),
        conv_thresh=1e-6, interpret=True,
    )
    tu, tv, tc = tmp.tile_match(
        torch.from_numpy(rays), torch.from_numpy(desc), torch.from_numpy(q),
        torch.from_numpy(qd), torch.from_numpy(corners),
        tcfg=tmp.PallasTileConfig(crop=crop, window=15), conv_thresh=1e-6,
    )
    assert tu.shape == (T, tsz) and tc.dtype == torch.bool
    assert (tu.numpy() == np.asarray(ju)).mean() >= AGREE
    assert (tv.numpy() == np.asarray(jv)).mean() >= AGREE
    assert (tc.numpy() == np.asarray(jc)).mean() >= AGREE


@pytest.mark.parametrize("w,offset", [(110, 0), (112, 1), (112, 0)])
def test_pad_pitch_copies_only_what_the_kernel_cannot_read(w, offset):
    """`pad_pitch` returns images the kernel's 16-byte row copies read:
    the inputs themselves at a width that is a multiple of 4 and an aligned
    start; an aligned copy of an image that starts `offset` elements past
    alignment; at width 110 both images zero-padded to a pitch of 112, their
    first 110 columns the inputs'."""
    rng = np.random.default_rng(w + offset)
    rays = torch.from_numpy(rng.standard_normal((24, w, 3), dtype=np.float32))
    desc = torch.from_numpy(rng.standard_normal((24, w, 24), dtype=np.float32)).to(torch.bfloat16)
    if offset:
        buf = torch.zeros(rays.numel() + offset)
        buf[offset:] = rays.flatten()
        rays = buf[offset:].view(rays.shape)
        assert rays.data_ptr() % 16
    pr, pd, pitch = tmp.pad_pitch(rays, desc)
    assert pitch == -(-w // 4) * 4
    for got, src in ((pr, rays), (pd, desc)):
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert got.shape == (24, pitch, src.shape[-1]) and got.dtype == src.dtype
        assert torch.equal(got[:, :w], src) and not got[:, w:].any()
    assert (pd.data_ptr() == desc.data_ptr()) == (pitch == w)
    assert (pr.data_ptr() == rays.data_ptr()) == (pitch == w and not offset)
