"""The port's asynchronous backend and f64 host solve in the SLAMSystem.

* `solver: host` in the whole system: the geometry oracle of
  tests/test_torch_slam.py (8 frames, tiled) with every global GN step
  solved in float64 on the host in both packages: the same modes,
  keyframes and edges, poses within 1e-3 (the tiled tolerance there).
* The worker against the synchronous backend, in the port: the same oracle
  with `single_thread: False` and the host solve gives the same keyframes
  and graph edges as `single_thread: True` with the host solve; the solves
  ran on the worker thread. Both runs resolve every frame at once
  (`defer_tracking_sync: 0`), and the test waits for the worker after each
  frame, so its poses are folded in before the next frame as a synchronous
  solve's are. Held within 1e-3: the tracked poses and the keyframe poses
  after `finalize`. A keyframe's own entry of the full trajectory differs by
  design: the synchronous run records the pose its solve gave, the async run
  the tracked pose (the solve has not run yet), as the JAX package does.
* A solve superseded by a newer queued job is skipped, and the newest job
  solves.
* A worker that raises surfaces on the next process_frame, once
  (tests/test_pipeline.py:138).
* `local_opt.solver: auto` resolves as tests/test_pipeline.py:370-405 has
  it on one device: host with the worker, device without; explicit values
  win.
"""

import threading

import numpy as np
import pytest

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.native.build import solver_available
from tests.test_ate_regression import H, W, OracleSLAM, gt_trajectory
from tests.test_torch_slam import (  # noqa: F401
    TorchOracleSLAM, _oracle_cfg, _run_oracle, one_torch_thread,
)


def _tcfg(**over):
    c = _oracle_cfg(lambda p: tload_config(p, set_global=False), "tiled")
    c["local_opt"]["solver"] = "host"
    c.update(over)
    return c


def _torch_oracle(cfg):
    return TorchOracleSLAM(params={}, model_cfg=TTINY, cfg=cfg, img_size=(H, W), kf_capacity=16,
                           device="cpu")


def test_host_solve_oracle_matches_jax():
    n = 8
    jc = _oracle_cfg(jload_config, "tiled")
    jc["local_opt"]["solver"] = "host"
    js = OracleSLAM(params={}, model_cfg=JTINY, cfg=jc, img_size=(H, W), kf_capacity=16)
    ts = _torch_oracle(_tcfg())
    assert ts.host_solve and js.host_solve
    j_modes, t_modes = _run_oracle(js, n), _run_oracle(ts, n)
    assert t_modes == j_modes
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.n_kf >= 2 and ts.graph.n_solves >= 1
    assert ts.graph.edge_list() == js.graph.edge_list()
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=1e-3)


def _run_tracked(slam, n_frames, wait_for_worker):
    """_run_oracle, also returning each frame's tracked pose (the decision
    vector's first 8 floats; the INIT frame's is its recorded pose)."""
    tracked = []
    for i, T in enumerate(gt_trajectory(n_frames)):
        slam.register_frame(T)
        slam.process_frame(i, i / 30.0, np.zeros((H, W, 3), np.float32))
        if wait_for_worker:
            slam._backend_jobs.join()
        tracked.append(slam.last_summary[:8].copy() if i else slam.frame_poses[0])
    slam.finalize()
    return np.stack(tracked)


def test_async_backend_matches_synchronous():
    n = 8
    sync = _torch_oracle(_tcfg(single_thread=True, defer_tracking_sync=0))
    asyn = _torch_oracle(_tcfg(single_thread=False, defer_tracking_sync=0))
    assert asyn._worker is not None and asyn.host_solve
    threads = set()
    body = asyn._backend_job_body

    def tracking_body(*a):
        threads.add(threading.current_thread().name)
        return body(*a)

    asyn._backend_job_body = tracking_body
    s_tracked = _run_tracked(sync, n, wait_for_worker=False)
    a_tracked = _run_tracked(asyn, n, wait_for_worker=True)
    assert threads == {"slam-backend"}
    assert asyn.n_async_solves >= 1 and asyn.graph.n_solves == asyn.n_async_solves
    assert asyn.keyframe_trajectory()[1].tolist() == sync.keyframe_trajectory()[1].tolist()
    assert asyn.n_kf >= 2
    assert asyn.graph.edge_list() == sync.graph.edge_list()
    np.testing.assert_allclose(a_tracked, s_tracked, atol=1e-3)
    np.testing.assert_allclose(asyn.keyframe_trajectory()[0], sync.keyframe_trajectory()[0],
                               atol=1e-3)
    np.testing.assert_array_equal(np.stack(asyn.frame_poses), a_tracked)


def test_superseded_solve_is_shed():
    s = _torch_oracle(_tcfg(single_thread=False))
    gt = gt_trajectory(3)
    img = np.zeros((H, W, 3), np.float32)
    for i in range(2):
        s.register_frame(gt[i])
        s.process_frame(i, i / 30.0, img, force_kf=True)
    s._resolve_pending()
    s._backend_jobs.join()
    solves = s.n_async_solves
    s.register_frame(gt[2])
    frame = s.make_frame(2, img)
    with s._graph_lock:  # the worker cannot reach its solve until both jobs are queued
        s.backend_step(1, frame)
        s.backend_step(1, frame)
    s.finalize()
    assert (s.n_shed_solves, s.n_async_solves - solves) == (1, 1)


def test_worker_failure_surfaces():
    s = _torch_oracle(_tcfg(single_thread=False))

    def boom(*a, **k):
        raise ValueError("poisoned backend job")

    s._backend_job_body = boom
    gt = gt_trajectory(2)
    img = np.zeros((H, W, 3), np.float32)
    s.register_frame(gt[0])
    s.process_frame(0, 0.0, img)  # INIT
    s.register_frame(gt[1])
    s.backend_step(0, s.make_frame(1, img))  # queue the poisoned job
    s._backend_jobs.join()
    with pytest.raises(RuntimeError, match="async backend worker failed"):
        s.process_frame(1, 1 / 30.0, img)
    s.process_frame(1, 1 / 30.0, img)  # the error was consumed: the loop goes on


def test_solver_auto_resolution():
    def mk(**over):
        c = tload_config("config/base.yaml", set_global=False)
        c.update(over)
        return TorchOracleSLAM(params={}, model_cfg=TTINY, cfg=c, img_size=(H, W),
                               kf_capacity=4, device="cpu")

    assert mk(single_thread=True).host_solve is False
    s = mk(single_thread=False)
    assert s.host_solve is solver_available() is True
    s.finalize()
    base_lo = tload_config("config/base.yaml", set_global=False)["local_opt"]
    assert mk(single_thread=True, local_opt={**base_lo, "solver": "host"}).host_solve is True
    s = mk(single_thread=False, local_opt={**base_lo, "solver": "device"})
    assert s.host_solve is False
    s.finalize()
