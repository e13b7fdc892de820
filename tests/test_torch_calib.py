"""The port's calibrated path against the JAX package's.

* Geometry (`core/geometry.py`): decompose_K, project_calib (values,
  Jacobian, validity), backproject, get_pixel_coords and
  constrain_points_to_ray on the same points, within 1e-5 (the tolerance
  of tests/test_torch_core.py).
* Tracking (`slam/tracker.py`): `opt_pose_calib_sim3` through `track_pose`
  with `use_calib` on an oracle frame pair, poses within 1e-4 and the same
  decision flags.
* The whole system: the geometry oracle of tests/test_torch_slam.py with
  `use_calib: True` and the oracle's own pinhole K in both packages, for 8
  frames in `tiled` mode: the same modes, keyframes and graph edges, poses
  within 1e-3 (the tiled tolerance of tests/test_torch_slam.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.core import geometry as jgeo
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.slam import tracker as jtr
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.core import geometry as tgeo
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.slam import tracker as ttr
from tests.test_ate_regression import FX, FY, H, W, OracleSLAM, gt_trajectory, render_frame
from tests.test_torch_slam import (  # noqa: F401
    TorchOracleSLAM, _oracle_cfg, _run_oracle, one_torch_thread,
)

K_ORACLE = np.array([[FX, 0.0, W / 2], [0.0, FY, H / 2], [0.0, 0.0, 1.0]], np.float32)
ATOL = 1e-5


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    P = (rng.normal(size=(n, 3)) * [1.0, 0.8, 0.5] + [0.0, 0.0, 3.0]).astype(np.float32)
    P[:4, 2] = [-1.0, 0.0, 1e-8, 50.0]  # behind, on and just past z_eps, far
    return P


@pytest.mark.parametrize("jacobian,border,z_eps", [(False, 0.0, 0.0), (True, -10.0, 1e-6)])
def test_project_calib_matches_jax(jacobian, border, z_eps):
    P = _points()
    ref = jgeo.project_calib(jnp.asarray(P), jnp.asarray(K_ORACLE), (H, W), jacobian=jacobian,
                             border=border, z_eps=z_eps)
    got = tgeo.project_calib(torch.from_numpy(P), torch.from_numpy(K_ORACLE), (H, W),
                             jacobian=jacobian, border=border, z_eps=z_eps)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(ref[-1]))  # validity
    for g, r in zip(got[:-1], ref[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL)
    assert [float(a) for a in tgeo.decompose_K(torch.from_numpy(K_ORACLE))] == \
        [float(a) for a in jgeo.decompose_K(jnp.asarray(K_ORACLE))]


def test_backproject_and_constrain_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, W, (50, 2)).astype(np.float32)
    z = rng.uniform(1, 5, (50, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.backproject(torch.from_numpy(p), torch.from_numpy(z), torch.from_numpy(K_ORACLE)).numpy(),
        np.asarray(jgeo.backproject(jnp.asarray(p), jnp.asarray(z), jnp.asarray(K_ORACLE))),
        atol=ATOL)
    Xs = np.stack([render_frame(T)[0] for T in gt_trajectory(2)])
    Xs = (Xs + 0.01 * rng.normal(size=Xs.shape)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.constrain_points_to_ray((H, W), torch.from_numpy(Xs), torch.from_numpy(K_ORACLE)).numpy(),
        np.asarray(jgeo.constrain_points_to_ray((H, W), jnp.asarray(Xs), jnp.asarray(K_ORACLE))),
        atol=ATOL)
    np.testing.assert_array_equal(tgeo.get_pixel_coords(2, (H, W)).numpy(),
                                  np.asarray(jgeo.get_pixel_coords(2, (H, W))))


def test_calibrated_track_pose_matches_jax():
    rng = np.random.default_rng(2)
    gt = gt_trajectory(3)
    Xf, _ = render_frame(gt[1])
    Xk, _ = render_frame(gt[0])
    hw = H * W
    idx = np.arange(hw, dtype=np.int32)  # oracle frames see the same pixels nearby
    valid = rng.random((hw, 1)) > 0.05
    Q = rng.uniform(1.0, 3.0, (hw, 1)).astype(np.float32)
    C = rng.uniform(1.0, 3.0, (hw, 1)).astype(np.float32)
    args = (idx, valid, Q, Q[::-1].copy(), Xf, C, Xk, C[::-1].copy(), gt[0], gt[0])
    cfg = dict(Q_conf=0.5, C_conf=0.5, match_frac_thresh=0.925)
    jres = jtr.track_pose(jtr.TrackingConfig(**cfg), (H, W), True, *(jnp.asarray(a) for a in args),
                          K=jnp.asarray(K_ORACLE))
    tres = ttr.track_pose(ttr.TrackingConfig(**cfg), (H, W), True,
                          *(torch.from_numpy(np.array(a)) for a in args),
                          K=torch.from_numpy(K_ORACLE))
    for name in ("new_kf", "low_match", "solver_failed"):
        assert bool(getattr(tres, name)) == bool(getattr(jres, name)), name
    assert not bool(tres.solver_failed)
    np.testing.assert_allclose(tres.T_WCf.numpy(), np.asarray(jres.T_WCf), atol=1e-4)
    moved = np.abs(np.asarray(jres.T_WCf) - gt[0]).max()
    assert moved > 1e-3  # the calibrated GN moved the pose toward gt[1]


def test_calibrated_oracle_slam_matches_jax():
    n = 8

    def cfg(load):
        c = _oracle_cfg(load, "tiled")
        c["use_calib"] = True
        return c

    js = OracleSLAM(params={}, model_cfg=JTINY, cfg=cfg(jload_config), img_size=(H, W),
                    kf_capacity=16, K=jnp.asarray(K_ORACLE))
    ts = TorchOracleSLAM(params={}, model_cfg=TTINY,
                         cfg=cfg(lambda p: tload_config(p, set_global=False)), img_size=(H, W),
                         kf_capacity=16, device="cpu", K=torch.from_numpy(K_ORACLE))
    assert ts.use_calib
    j_modes, t_modes = _run_oracle(js, n), _run_oracle(ts, n)
    assert t_modes == j_modes
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.n_kf >= 2 and ts.graph.n_solves >= 1
    assert ts.graph.edge_list() == js.graph.edge_list()
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=1e-3)
    assert t_modes.count(1) >= n - 2  # frames were tracked (mode 1: TRACKING)
