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
