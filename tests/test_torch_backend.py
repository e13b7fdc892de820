"""Parity of the port's global Gauss-Newton (`slam/backend.py`) with the JAX
package's on the ray-residual cases of tests/test_backend.py: a 4-keyframe
graph with exact identity correspondences, perturbed initial poses, padded
invalid edges and the `pixel_subsample` stride.

Tolerance: poses within 1e-4. Both sides solve the same f32 normal
equations; the per-edge sums over ~500 pixels run in different orders and
the Jacobi-scaled Cholesky amplifies that roundoff along the weakly
determined scale direction (sigma_dist = 10) to ~1e-5 in the pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.core import lie as jlie
from monst3r_slam_tpu.slam import backend as jb
from monst3r_slam_torch.slam import backend as tb
from tests.test_backend import build_graph

POSE_TOL = 1e-4


def _graph(seed, P=4, pad_edges=0):
    T_true, T_init, Xs, Cs, ii, jj, idx, valid, Q, ev = (
        np.asarray(a) for a in build_graph(jax.random.PRNGKey(seed), P=P))
    if pad_edges:  # garbage edges, masked out by edge_valid
        hw = idx.shape[1]
        ii = np.concatenate([ii, np.zeros(pad_edges, ii.dtype)])
        jj = np.concatenate([jj, np.zeros(pad_edges, jj.dtype)])
        idx = np.concatenate([idx, np.zeros((pad_edges, hw), idx.dtype)])
        valid = np.concatenate([valid, np.ones((pad_edges, hw), bool)])
        Q = np.concatenate([Q, np.full((pad_edges, hw), 100.0, Q.dtype)])
        ev = np.concatenate([ev, np.zeros(pad_edges, bool)])
    return T_true, (T_init, Xs, Cs, ii, jj, idx, valid, Q, ev)


def _pose_err(T_est, T_true):
    rel = jax.vmap(lambda a, b: jlie.sim3_log(jlie.sim3_mul(jlie.sim3_inv(a), b)))(
        jnp.asarray(T_est), jnp.asarray(T_true))
    return np.linalg.norm(np.asarray(rel), axis=-1)


@pytest.mark.parametrize("seed,pad_edges,subsample", [(0, 0, 1), (2, 4, 1), (3, 0, 4)])
def test_gauss_newton_matches_jax(seed, pad_edges, subsample):
    T_true, args = _graph(seed, pad_edges=pad_edges)
    P = T_true.shape[0]
    T_j, it_j = jb.gauss_newton(
        *(jnp.asarray(a) for a in args),
        jb.BackendConfig(max_iters=10, chunk=512, pixel_subsample=subsample), n_poses=P)
    T_t, it_t = tb.gauss_newton(
        *(torch.from_numpy(a.copy()) for a in args),
        tb.BackendConfig(max_iters=10, pixel_subsample=subsample), n_poses=P)
    T_t = T_t.numpy()
    np.testing.assert_allclose(T_t, np.asarray(T_j), atol=POSE_TOL)
    assert abs(it_t - int(it_j)) <= 1  # the stop test reads a step norm near 1e-8
    err = _pose_err(T_t, T_true)
    assert err[0] < 1e-6  # pinned pose untouched
    assert err[1:].max() < 1e-3  # and the solve recovered the others


def test_edge_terms_and_dense_system_match_jax():
    """SoA per-edge blocks, the dense assembly and the solve step, under
    partial validity, confidence gates and an invalid edge (the case of
    tests/test_backend.py::test_soa_terms_match_generic_path). Tolerance 2e-5
    of the system's scale, as that test holds the two JAX forms."""
    rng = np.random.default_rng(0)
    P, E, hw = 6, 6, 800
    taus = rng.normal(size=(P, 7)) * 0.1
    Twc = np.stack([np.asarray(jlie.sim3_exp(jnp.asarray(t, jnp.float32))) for t in taus])
    Xs = (rng.standard_normal((P, hw, 3)) * 0.5 + [0.0, 0.0, 3.0]).astype(np.float32)
    Cs = rng.uniform(0.5, 3.0, (P, hw, 1)).astype(np.float32)
    ii = rng.integers(0, P, (E,)).astype(np.int64)
    jj = (ii + 1) % P
    idx = rng.integers(0, hw, (E, hw)).astype(np.int64)
    vm = rng.random((E, hw)) > 0.1
    Q = rng.uniform(0.5, 3.0, (E, hw)).astype(np.float32)
    ev = np.arange(E) < E - 1
    args = (Twc, Xs, Cs, ii, jj, idx, vm, Q, ev)
    jcfg = jb.BackendConfig(Q_conf=1.2, C_conf=1.1, chunk=256)
    tcfg = tb.BackendConfig(Q_conf=1.2, C_conf=1.1)

    jT, jX, jC, jii, jjj, jidx, jvm, jQ, jev = (jnp.asarray(a) for a in args)
    jgat = jb._gather_edges(jX, jC, jii, jjj, jidx, jvm, jQ, jev, jcfg)
    jA, jbv = jb._edge_terms_ray_soa(jT, jii, jjj, jgat, jcfg)
    jH, jg = jb._assemble_dense_A(jA, jbv, jii, jjj, jev, P, jcfg)
    jdx = jb._solve_dense(jH, jg, P, jcfg)

    tT, tX, tC, tii, tjj, tidx, tvm, tQ, tev = (torch.from_numpy(np.asarray(a).copy()) for a in args)
    tgat = tb._gather_edges(tX, tC, tii, tjj, tidx, tvm, tQ, tev, tcfg)
    tA, tbv = tb._edge_terms_ray_soa(tT, tii, tjj, tgat, tcfg)
    tH, tg = tb._assemble_dense(tA, tbv, tii, tjj, tev, P, tcfg)
    tdx = tb._solve_dense(tH, tg, P, tcfg)

    scale, gscale = float(jnp.max(jnp.abs(jA))), float(jnp.max(jnp.abs(jbv)))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=2e-5 * scale)
    np.testing.assert_allclose(tbv.numpy(), np.asarray(jbv), atol=2e-5 * gscale)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), atol=2e-5 * scale)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5 * gscale)
    dscale = float(jnp.max(jnp.abs(jdx)))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-3 * dscale)
    assert not tdx[: tcfg.pin].any()  # pinned rows


def test_gauss_newton_point_residual_matches_jax():
    """`residual_kind="point"` on tests/test_backend.py's synthetic graph
    (its test_gauss_newton_points_converges), in `gauss_newton` and in
    `gauss_newton_sharded` over a 2-entry CPU mesh, against JAX's
    `gauss_newton` and its sharded solve on a 2-device mesh, at 1e-4."""
    from monst3r_slam_tpu.parallel import mesh as jmesh
    from monst3r_slam_torch.parallel import mesh as tmesh

    T_true, args = _graph(7)
    P = T_true.shape[0]
    jargs = [jnp.asarray(a) for a in args]
    jcfg = jb.BackendConfig(max_iters=10, chunk=512)
    T_j, _ = jb.gauss_newton(*jargs, jcfg, n_poses=P, residual_kind="point")
    T_js, _ = jb.gauss_newton_sharded(jmesh.make_mesh(2), *jargs, jcfg, n_poses=P,
                                      residual_kind="point")
    targs = [torch.from_numpy(a.copy()) for a in args]
    tcfg = tb.BackendConfig(max_iters=10)
    T_t, it_t = tb.gauss_newton(*targs, tcfg, n_poses=P, residual_kind="point")
    mesh = tmesh.make_mesh(devices=[torch.device("cpu")] * 2)
    T_ts, it_ts = tb.gauss_newton_sharded(mesh, *targs, tcfg, n_poses=P, residual_kind="point")
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=POSE_TOL)
    np.testing.assert_allclose(T_ts.numpy(), np.asarray(T_js), atol=POSE_TOL)
    np.testing.assert_allclose(T_ts.numpy(), T_t.numpy(), atol=POSE_TOL)
    assert abs(it_ts - it_t) <= 1
    err = _pose_err(T_t.numpy(), T_true)
    assert err[0] < 1e-6 and err[1:].max() < 1e-3
    # the point route differs from the ray route it replaces
    T_ray, _ = tb.gauss_newton(*targs, tcfg, n_poses=P)
    assert not torch.equal(T_ray, T_t)


@pytest.mark.parametrize("scale_gauge", [0.0, 0.05, 1.0])
def test_solve_dense_scale_gauge_matches_jax(scale_gauge):
    """`_solve_dense` with the ridge on each scale coordinate against JAX's
    on the same dense system of the synthetic graph; the step within 1e-3 of
    its own largest entry, as test_edge_terms_and_dense_system_match_jax
    holds the solve step (f32 Cholesky in both, factorized in different
    orders; the weak scale direction amplifies that to ~2e-4)."""
    T_true, args = _graph(0)
    P = T_true.shape[0]
    tcfg = tb.BackendConfig(scale_gauge=scale_gauge)
    targs = [torch.from_numpy(a.copy()) for a in args]
    gat = tb._gather_edges(*targs[1:], tcfg)
    A, b = tb._edge_terms(targs[0], targs[3], targs[4], gat, tcfg, None)
    H, g = tb._assemble_dense(A, b, targs[3], targs[4], targs[8], P, tcfg)
    dx_t = tb._solve_dense(H, g, P, tcfg)
    dx_j = jb._solve_dense(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()), P,
                           jb.BackendConfig(scale_gauge=scale_gauge))
    scale = float(np.abs(np.asarray(dx_j)).max())
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-3 * scale)
    if scale_gauge > 0:  # the prior shrinks the scale steps and leaves the rest near
        dx_0 = tb._solve_dense(H, g, P, tb.BackendConfig())
        assert dx_t[1:, 6].abs().sum() < dx_0[1:, 6].abs().sum()
