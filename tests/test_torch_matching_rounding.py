"""`matching_pallas.rounding_check`, the referee of kernel B's descriptor step
(`csrc/tile_match.cu` sums the descriptor dot on the tensor cores, in their
own order), on the CPU.

One 32x32 scene with two 16x16 crops. Query (0, 0) has two strong matches A
and B in one crop row outside the +-3 px window of its ray match (inside
the +-15 px one): B = A with channels 0 and 1 swapped, whose exact products
with the query are equal, and channel 5 one bf16 step higher, so B scores
2^-14 above A, well under the check's delta (~1e-3 here). The check must
accept the plain version's own output and a pick of A, and reject a match
outside the window, a match far below the window maximum, a higher-index
copy of a lower-index position, and a flipped convergence flag.
"""

import numpy as np
import pytest
import torch

from monst3r_slam_torch.ops import matching_pallas as tmp

H = W = 32
CROP, T, TSZ, FD, THRESH = 16, 2, 16, 24, 1e-6
CORNERS = torch.tensor([[0, 0], [16, 16]], dtype=torch.int32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _scene(duplicate=False):
    """Arguments (without window) and the crop positions A < B (u, v)."""
    rng = np.random.default_rng(0)
    rays = rng.standard_normal((H, W, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, TSZ, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    desc = _bf16(0.1 * rng.standard_normal((H, W, FD)))
    qd = _bf16(rng.standard_normal((T, TSZ, FD)))
    qd[0, 0, [0, 1, 5]] = 1.0
    ru, rv, _ = tmp.tile_match_plain(*(torch.from_numpy(a) for a in (rays, desc, q, qd)),
                                     CORNERS, CROP, 3, THRESH, phase="stencil")
    pv = int(rv[0, 0])
    row = next(r for r in range(CROP) if abs(r - pv) > 3)
    a, b = (0, row), (1, row)
    va = _bf16(2.0 * qd[0, 0])
    va[[0, 1, 5]] = 1.5, 0.5, 2.0**-7
    vb = va.copy()
    if not duplicate:
        vb[[0, 1, 5]] = 0.5, 1.5, 2.0**-7 + 2.0**-14
    desc[a[1], a[0]], desc[b[1], b[0]] = va, vb
    args = [torch.from_numpy(x) for x in (rays, desc, q, qd)] + [CORNERS, CROP]
    return args, a, b


def _check(args, window, got):
    return tmp.rounding_check(*args, window, THRESH, got)


def _plain(args, window):
    return tmp.tile_match_plain(*args, window, THRESH)


def _pick(out, pos):
    """`out` with query (0, 0)'s match moved to crop position pos (u, v)."""
    u, v, conv = (x.clone() for x in out)
    u[0, 0], v[0, 0] = pos
    return u, v, conv


@pytest.mark.parametrize("window", [3, 15])
def test_rounding_check_accepts_the_plain_output(window):
    args, _, _ = _scene()
    passes, exact = _check(args, window, _plain(args, window))
    assert passes.all() and exact.all()


def test_rounding_check_accepts_a_near_tie():
    args, a, b = _scene()
    out = _plain(args, 15)
    assert (int(out[0][0, 0]), int(out[1][0, 0])) == b  # B scores 2^-14 above A
    passes, exact = _check(args, 15, _pick(out, a))
    assert passes.all()
    assert not exact[0, 0] and exact.sum() == T * TSZ - 1


def test_rounding_check_rejects_a_match_outside_the_window():
    args, a, _ = _scene()
    passes, _ = _check(args, 3, _pick(_plain(args, 3), a))  # A lies 4+ rows off
    assert not passes[0, 0] and passes.sum() == T * TSZ - 1


def test_rounding_check_rejects_a_match_far_below_the_maximum():
    args, a, b = _scene()
    out = _plain(args, 15)
    low = (2, a[1])  # a random descriptor beside A and B: far below them
    assert low not in (a, b)
    passes, _ = _check(args, 15, _pick(out, low))
    assert not passes[0, 0] and passes.sum() == T * TSZ - 1


def test_rounding_check_rejects_a_higher_index_duplicate():
    """B is an exact copy of A: equal sums in any order, so the lowest index
    wins without rounding allowance."""
    args, a, b = _scene(duplicate=True)
    out = _plain(args, 15)
    assert (int(out[0][0, 0]), int(out[1][0, 0])) == a
    passes, _ = _check(args, 15, _pick(out, b))
    assert not passes[0, 0] and passes.sum() == T * TSZ - 1


def test_rounding_check_rejects_a_flipped_convergence_flag():
    args, _, _ = _scene()
    u, v, conv = (x.clone() for x in _plain(args, 15))
    conv[1, 3] = ~conv[1, 3]
    passes, exact = _check(args, 15, (u, v, conv))
    assert not passes[1, 3] and not exact[1, 3] and passes.sum() == T * TSZ - 1


@pytest.mark.parametrize("fd,width", [(8, 16), (12, 16), (20, 24), (33, 48), (80, 96),
                                      (119, 128)])
def test_zero_padded_descriptors_match_bit_for_bit(fd, width):
    """Kernel B's wrapper zero-pads a descriptor width other than 16, 24,
    32, 48, 64, 96 or 128 to the next of them (`pad_descriptors`, up to the
    reference's 119): the plain version on the
    padded descriptors gives the originals' matches bit for bit, since a
    zero channel adds an exact zero to every score."""
    rng = np.random.default_rng(fd)
    rays = rng.standard_normal((H, W, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, TSZ, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    desc, qd = (torch.from_numpy(_bf16(rng.standard_normal(s)))
                for s in ((H, W, fd), (T, TSZ, fd)))
    pd, pq = tmp.pad_descriptors(desc, qd)
    assert pd.shape == (H, W, width) and pq.shape == (T, TSZ, width)
    assert torch.equal(pd[..., :fd], desc) and not pd[..., fd:].any() and not pq[..., fd:].any()
    rays, q = torch.from_numpy(rays), torch.from_numpy(q)
    for window in (3, 15):
        want = tmp.tile_match_plain(rays, desc, q, qd, CORNERS, CROP, window, THRESH)
        got = tmp.tile_match_plain(rays, pd, q, pq, CORNERS, CROP, window, THRESH)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _wide_scene(fd, x):
    """Arguments (without window) at descriptor width `fd` where query (0, 0)
    reads channels 0 and 1 only (both 1.0): B = [1, 0, ...] scores exactly
    1, the window maximum, and A = [1, -x, 0, ...] scores exactly 1 - x,
    with the window's largest sum of |q_c d_c| S = 1 + x (A's). Every other
    position scores far lower. Returns the arguments and A, B (u, v)."""
    rng = np.random.default_rng(fd)
    rays = rng.standard_normal((H, W, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q = rng.standard_normal((T, TSZ, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    desc = _bf16(0.05 * rng.standard_normal((H, W, fd)))
    qd = _bf16(rng.standard_normal((T, TSZ, fd)))
    qd[0, 0] = 0.0
    qd[0, 0, [0, 1]] = 1.0
    a, b = (3, 5), (9, 5)
    desc[a[1], a[0]] = 0.0
    desc[a[1], a[0], [0, 1]] = 1.0, -x
    desc[b[1], b[0]] = 0.0
    desc[b[1], b[0], 0] = 1.0
    assert _bf16(desc).tolist() == desc.tolist()  # x is exact in bf16
    return [torch.from_numpy(v) for v in (rays, desc, q, qd)] + [CORNERS, CROP], a, b


@pytest.mark.parametrize("fd,inside", [(64, True), (64, False), (128, True), (128, False)])
def test_rounding_allowance_grows_with_the_descriptor_width(fd, inside):
    """At fd 64 (allowance 512) and 128 (1024) a descriptor match whose plain
    score lies 15/16 of delta = allowance 2^-24 S below the window maximum
    passes `rounding_check`, one 9/8 of delta below fails; the 15/16 one lies
    past the allowance of the widths up to 32 (256), so the check scales with
    the instantiated width."""
    allowance = tmp.rounding_allowance(fd)
    assert allowance == {64: 512, 128: 1024}[fd] and tmp.rounding_allowance(32) == 256
    x = allowance * 2.0**-24 * (15 / 16 if inside else 9 / 8)
    args, a, b = _wide_scene(fd, x)
    out = _plain(args, 15)
    assert (int(out[0][0, 0]), int(out[1][0, 0])) == b
    assert x > 256 * 2.0**-24 * (1 + x)  # past the allowance of fd <= 32
    passes, exact = _check(args, 15, _pick(out, a))
    assert bool(passes[0, 0]) == inside and not exact[0, 0]
    assert passes.sum() == T * TSZ - (0 if inside else 1)


def test_descriptors_wider_than_the_reference_takes_are_refused():
    z = torch.zeros((4, 4, 120))
    with pytest.raises(ValueError, match="1 to 119"):
        tmp.pad_descriptors(z, z)
