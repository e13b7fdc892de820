"""The port's f64 host solve against the JAX package's.

* `native/build.py::solve_spd` (the port's copy of `native/solver.cpp`,
  built with g++ into build/native/) equals the JAX package's native solve
  on the same SPD systems, to the last bit (the same source and flags),
  including the jitter recovery of a semi-definite system and the refusal
  of an indefinite one (tests/test_native.py).
* `backend.gauss_newton_host_solve` on the 4-keyframe graph of
  tests/test_backend.py matches the JAX host solve within 1e-5 and
  recovers the true poses; the calibrated residual is held the same way
  on an edge set with matched pixels (`_calib_residual`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.native.build import solve_spd as jsolve
from monst3r_slam_tpu.slam import backend as jb
from monst3r_slam_torch.native import build as tnative
from monst3r_slam_torch.slam import backend as tb
from tests.test_backend import build_graph, pose_errors
from tests.test_torch_slam import one_torch_thread  # noqa: F401


def test_solve_spd_matches_jax():
    rng = np.random.default_rng(0)
    n = 70
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    A = L @ L.T
    b = A @ rng.standard_normal(n)
    np.testing.assert_array_equal(tnative.solve_spd(A, b), jsolve(A, b))
    # semi-definite: plain Cholesky fails, the jitter path recovers
    A0, b0 = np.diag([1.0, 1.0, 0.0]), np.asarray([1.0, 2.0, 0.0])
    x = tnative.solve_spd(A0, b0, jitter=1e-8)
    np.testing.assert_array_equal(x, jsolve(A0, b0, jitter=1e-8))
    np.testing.assert_allclose(x[:2], [1.0, 2.0], atol=1e-4)
    # indefinite beyond any jitter: both refuse
    with pytest.raises(np.linalg.LinAlgError):
        tnative.solve_spd(np.diag([1.0, -1.0]), np.ones(2))
    with pytest.raises(np.linalg.LinAlgError):
        jsolve(np.diag([1.0, -1.0]), np.ones(2))
    assert tnative.LIB.parent.name == "native" and tnative.LIB.parent.parent.name == "build"


def test_host_solve_matches_jax():
    T_true, T_init, Xs, Cs, ii, jj, idx, valid, Q, ev = (
        np.asarray(a) for a in build_graph(jax.random.PRNGKey(3)))
    args = (T_init, Xs, Cs, ii, jj, idx, valid, Q, ev)
    T_j = jb.gauss_newton_host_solve(*(jnp.asarray(a) for a in args),
                                     jb.BackendConfig(max_iters=10, chunk=512), n_poses=4)
    T_t, iters = tb.gauss_newton_host_solve(*(torch.from_numpy(a.copy()) for a in args),
                                            tb.BackendConfig(max_iters=10), n_poses=4)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    assert 1 <= iters <= 10
    assert float(np.max(np.asarray(pose_errors(jnp.asarray(T_t.numpy()), T_true))[1:])) < 1e-3


def _calib_graph(seed=0, P=4, h=12, w=16):
    """Keyframes seeing one plane at depth ~3 through pinhole K, with exact
    pixel correspondences; poses perturbed."""
    from monst3r_slam_tpu.core import lie as jlie

    rng = np.random.default_rng(seed)
    K = np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]], np.float32)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 3.0 + 0.2 * np.sin(u / 3.0) + 0.1 * np.cos(v / 2.0)
    X = np.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z], -1).reshape(-1, 3)
    Xs = np.repeat(X[None], P, 0).astype(np.float32)
    Cs = np.full((P, h * w, 1), 2.0, np.float32)
    T = np.stack([np.asarray(jlie.sim3_exp(jnp.asarray(rng.normal(size=7) * 0.01, jnp.float32)))
                  for _ in range(P)])
    T[0] = np.asarray(jlie.sim3_identity())
    ii = np.array([0, 1, 1, 2, 2, 3], np.int32)
    jj = np.array([1, 0, 2, 1, 3, 2], np.int32)
    idx = np.repeat(np.arange(h * w, dtype=np.int32)[None], len(ii), 0)
    valid = np.ones(idx.shape, bool)
    Q = np.full(idx.shape, 2.0, np.float32)
    ev = np.ones(len(ii), bool)
    return K, (h, w), (T, Xs, Cs, ii, jj, idx, valid, Q, ev)


@pytest.mark.parametrize("host", [False, True])
def test_calibrated_global_solve_matches_jax(host):
    K, img_size, args = _calib_graph()
    jcfg, tcfg = jb.BackendConfig(max_iters=5, chunk=64), tb.BackendConfig(max_iters=5)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a.copy()) for a in args]
    kw_j = dict(n_poses=4, use_calib=True, K=jnp.asarray(K), img_size=img_size)
    kw_t = dict(n_poses=4, use_calib=True, K=torch.from_numpy(K), img_size=img_size)
    if host:
        T_j = jb.gauss_newton_host_solve(*jargs, jcfg, **kw_j)
        T_t, _ = tb.gauss_newton_host_solve(*targs, tcfg, **kw_t)
    else:
        T_j, _ = jb.gauss_newton(*jargs, jcfg, **kw_j)
        T_t, _ = tb.gauss_newton(*targs, tcfg, **kw_t)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    moved = np.abs(np.asarray(T_j) - args[0]).max()
    assert moved > 1e-4  # the solve did something


def test_calib_residual_matches_jax():
    rng = np.random.default_rng(1)
    n, h, w = 200, 12, 16
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
    Xi = (rng.normal(size=(n, 3)) * [1, 1, 0.3] + [0, 0, 3]).astype(np.float32)
    Xj = (Xi + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    Xj[:5, 2] = -1.0  # behind the camera: invalid
    ind = rng.integers(0, h * w, n).astype(np.int32)
    je, jJ, jv = jb._calib_residual(jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(ind),
                                    jnp.asarray(K), h, w, -10.0, 1e-6)
    te, tJ, tv = tb._calib_residual(torch.from_numpy(Xi), torch.from_numpy(Xj),
                                    torch.from_numpy(ind).long(), torch.from_numpy(K), h, w,
                                    -10.0, 1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[..., 0])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-5, atol=1e-5)
