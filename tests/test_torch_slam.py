"""Twins of the JAX package's synchronous SLAMSystem in the port (the
TINY-model twin is in tests/test_torch_slam_model.py).

* The geometry oracle of tests/test_ate_regression.py (exact pointmaps and
  descriptors of a known trajectory in place of the network) drives both
  packages' real matcher, tracker, fusion, keyframing, factor graph and
  global Gauss-Newton for 8 frames at 64x80, in each matcher mode: the
  port's `tiled` against JAX's `tiled`, and the port's `kernel` (kernel B's
  plain version on the CPU) against JAX's `pallas` (the Pallas kernel in
  interpret mode). Same mode sequence, keyframe ids and graph edges; poses
  within 1e-3 in `tiled` mode, where both sides make the same matches and
  differ by f32 summation order in the solves (measured 4e-5). In `kernel`
  mode ~2% of the convergence flags sit within 2e-7 of the 1e-6 threshold
  and flip between the TPU kernel's split bf16 dot and the port's f32 dot
  (tests/test_torch_tracker.py); over 8 frames and 7 global solves that
  moves the poses by up to ~2e-3, so that mode is held to 5e-3.
"""

import gc

import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app import pipeline as jpipe
from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.app.evaluate import ate_rmse
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_torch.app import pipeline as tpipe
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.core import lie as tlie
from monst3r_slam_torch.dynamic.inference import DualParams, EasiParams
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.parallel.mesh import make_mesh
from tests.test_ate_regression import (
    DESC_F, H, W, OracleSLAM, gt_trajectory, render_frame, world_desc,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the oracle twins run. The test suite runs in
    several processes at once, and torch's pool in each (a thread per core)
    would oversubscribe the cores several times over: the oracle runs take
    up to 20x longer so. Modules that drive the oracle import this."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def close_backend_workers():
    """Stop the backend worker of every system, of either package, that a
    test left running: each worker thread waits for jobs, and holds its
    system and the system's memory, until the process ends, and a test
    process runs many files. The JAX package's systems have no `close`; the
    job queue's None ends their worker as it ends the port's. Modules that
    start asynchronous systems import this."""
    yield
    for obj in gc.get_objects():
        if isinstance(obj, (tpipe.SLAMSystem, jpipe.SLAMSystem)) and obj._worker is not None:
            obj._backend_jobs.put(None)
            obj._worker.join()
            obj._worker = None


class TorchOracleSLAM(tpipe.SLAMSystem):
    """The port's SLAMSystem with the network replaced by the geometry
    oracle of tests/test_ate_regression.py::OracleSLAM."""

    def __post_init__(self):
        super().__post_init__()
        self._oracle_frames = {}
        self._next_id = 0

    def register_frame(self, T_WC_gt):
        fid = self._next_id
        self._next_id += 1
        X_cam, X_world = render_frame(T_WC_gt)
        self._oracle_frames[fid] = (X_cam, X_world, np.asarray(T_WC_gt))
        self._pending_id = fid

    def encode(self, img_nhwc):
        b = img_nhwc.shape[0]
        feat = torch.zeros((b, self.hw // self.model_cfg.patch_size**2, self.model_cfg.enc_dim))
        feat[:, 0, 0] = self._pending_id
        return feat, torch.zeros(feat.shape[:2] + (2,), dtype=torch.int32)

    def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
        b = feat_i.shape[0]
        X1s, X2s, D1s, D2s = [], [], [], []
        for k in range(b):
            Xi_cam, Xi_w, Ti = self._oracle_frames[int(feat_i[k, 0, 0])]
            Xj_cam, Xj_w, Tj = self._oracle_frames[int(feat_j[k, 0, 0])]
            T_ij = tlie.sim3_rel(torch.from_numpy(Ti.copy()), torch.from_numpy(Tj.copy()))
            X1s.append(torch.from_numpy(Xi_cam))
            X2s.append(tlie.sim3_act(T_ij, torch.from_numpy(Xj_cam)))
            D1s.append(torch.from_numpy(world_desc(Xi_w)))
            D2s.append(torch.from_numpy(world_desc(Xj_w)))
        conf = torch.full((b, H, W), 2.0)

        def stack(xs, c):
            return torch.stack(xs).reshape(b, H, W, c)

        return tmodel.PairOutput(stack(X1s, 3), conf, stack(D1s, DESC_F), conf,
                                 stack(X2s, 3), conf, stack(D2s, DESC_F), conf)


def _oracle_cfg(load, mode):
    cfg = load("config/base.yaml")
    cfg["tracking"].update(Q_conf=0.5, C_conf=0.5, match_frac_thresh=0.925)
    cfg["local_opt"].update(Q_conf=0.5, solver="device")
    cfg["single_thread"] = True
    cfg["parallel"] = {"mesh": "off"}
    cfg["matching"]["mode"] = mode
    return cfg


def _run_oracle(slam, n_frames):
    modes = []
    for i, T in enumerate(gt_trajectory(n_frames)):
        slam.register_frame(T)
        slam.process_frame(i, i / 30.0, np.zeros((H, W, 3), np.float32))
        modes.append(int(slam.mode))
    slam.finalize()
    return modes


@pytest.mark.parametrize("jmode,tmode,pose_tol", [("tiled", "tiled", 1e-3),
                                                  ("pallas", "kernel", 5e-3)])
def test_oracle_slam_matches_jax(jmode, tmode, pose_tol):
    n = 8
    js = OracleSLAM(params={}, model_cfg=JTINY, cfg=_oracle_cfg(jload_config, jmode),
                    img_size=(H, W), kf_capacity=16)
    ts = TorchOracleSLAM(params={}, model_cfg=TTINY,
                         cfg=_oracle_cfg(lambda p: tload_config(p, set_global=False), tmode),
                         img_size=(H, W), kf_capacity=16, device="cpu")
    assert ts.match_mode == tmode
    j_modes, t_modes = _run_oracle(js, n), _run_oracle(ts, n)
    assert t_modes == j_modes
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.n_kf >= 2 and ts.graph.n_solves >= 1  # the backend really ran
    assert ts.graph.edge_list() == js.graph.edge_list()
    j_poses, t_poses = np.stack(js.frame_poses), np.stack(ts.frame_poses)
    np.testing.assert_allclose(t_poses, j_poses, atol=pose_tol)
    t = np.arange(n, dtype=np.float64)
    gt_xyz = np.stack([T[:3] for T in gt_trajectory(n)])
    rmse, _ = ate_rmse(t, t_poses[:, :3].astype(np.float64), t, gt_xyz)
    assert rmse < 0.01  # the bound tests/test_ate_regression.py holds JAX to


def test_port_refuses_unported_configurations(tmp_path):
    """config/base.yaml as shipped (async worker, `solver: auto`, `mesh:
    auto` on the CPU, which builds no mesh, as JAX builds none on one
    device) is accepted, and so are the calibrated and host-solve settings,
    the dynamic pipeline's dual models, the Easi3R models, a viewer, the LM
    matcher and the pointmap debug dumps with the dual models, and a system
    writes and reads its state file; a system given a mesh holds it and
    takes the device solve under `solver: auto`; a `parallel.mesh` other
    than auto or off raises, and so do dual and Easi3R models together."""
    def make(fields=None, **over):
        c = tload_config("config/base.yaml", set_global=False)
        c.update(over)
        return tpipe.SLAMSystem(params={}, model_cfg=TTINY, cfg=c, img_size=(H, W),
                                kf_capacity=2, device="cpu", **(fields or {}))

    s = make()
    assert s._worker is not None and s.defer_depth == 2 and s.host_solve and s.mesh is None
    s.finalize()
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    s = make({"mesh": mesh})
    assert s.mesh is mesh and s._worker is not None and not s.host_solve
    s.finalize()
    make(single_thread=True, use_calib=True, fields={"K": torch.eye(3)})
    make(single_thread=True, local_opt={"solver": "host"})
    dual = {"dual": DualParams({}, TTINY, {}, TTINY)}
    make(dual, single_thread=True)
    easi3r = {"easi3r": EasiParams({}, TTINY, {}, TTINY)}
    make(easi3r, single_thread=True)
    make({"viewer": object()}, single_thread=True)
    with pytest.raises(ValueError, match="parallel.mesh must be auto or off"):
        make(single_thread=True, parallel={"mesh": "on"})
    lm = make(single_thread=True, matching={"mode": "lm"})
    assert lm.match_mode == "lm" and lm.match_tcfg is None and not lm.supports_chunking
    make(dual, single_thread=True, debug_save_3d_pointclouds=True,
         debug_save_pointmap_visualization=True)
    with pytest.raises(ValueError, match="not both"):
        make({**dual, **easi3r}, single_thread=True)
    with pytest.raises(ValueError, match="unknown matching mode"):
        make(single_thread=True, matching={"mode": "brute"})
    s = make(single_thread=True)
    s.save_state(tmp_path / "state.npz")
    s2 = make(single_thread=True)
    s2.load_state(tmp_path / "state.npz")
    assert s2.mem.count == 0 and s2.graph.n_edges == 0 and s2.mode == s.mode
