"""SLAM-state files (`SLAMSystem.save_state` / `load_state`) in the port,
against the JAX package's, TINY tied weights in f32 on 64x80 frames (the
setup of tests/test_torch_slam_model.py, which tracks):

* a file written by either package has the other's keys, dtypes and shapes,
  and each package reads the other's file to the same state: the keyframe
  memory, the graph's edges, the trajectory, the mode and the last pose
  equal bit for bit, the host-side keyframe images and dynamic masks too;
* the port's own round trip keeps that state, drops the caches of the old
  state (the keyframe view, the device pose, the matcher's warm start) and
  reads a file without `kf_score` or the host-side images, as the JAX
  package does;
* a run resumed from a file after 3 frames makes the decisions of an
  uninterrupted run over the next 7 (the same keyframes, relocalization
  attempts and mode), with poses within 1e-4: the resumed system starts the
  matcher cold, where the uninterrupted one warm-starts it. This run uses
  the port's own tied TINY draw, on which the moving synthetic video makes
  keyframes at frames 1-3 and then loses tracking.
"""

import jax
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_torch.app import pipeline as tpipe
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.models.init import init_params
from monst3r_slam_torch.slam.frame import Mode
from tests.test_pipeline import synth_video
from tests.test_torch_slam import one_torch_thread  # noqa: F401
from tests.test_torch_slam_model import H, W, _JaxF32SLAM, _smooth_frame

MEM = dict(kf_frame_id="frame_id", kf_T_WC="T_WC", kf_X="X_canon", kf_C="C", kf_N="N",
           kf_score="score", kf_feat="feat", kf_pos="pos")


def _cfg(load, **over):
    c = load("config/base.yaml")
    c["tracking"]["Q_conf"] = 0.0
    c["local_opt"].update(Q_conf=0.0, solver="device")
    c["single_thread"] = True
    c["parallel"] = {"mesh": "off"}
    c["matching"]["mode"] = "tiled"
    c["tracking"].update(over)
    return c


@pytest.fixture(scope="module")
def weights():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    jp["dec_blocks2"], jp["head2"] = jp["dec_blocks"], jp["head1"]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _port(weights, **over):
    return tpipe.SLAMSystem(params=weights[1], model_cfg=TTINY,
                            cfg=_cfg(lambda p: tload_config(p, set_global=False), **over),
                            img_size=(H, W), kf_capacity=8, device="cpu", dtype=torch.float32)


def _uimg(img):
    return ((img * 0.5 + 0.5) * 255).astype(np.uint8)


def _run(slam, frames, first=0, force_kf_at=()):
    for i, img in enumerate(frames, first):
        slam.process_frame(i, i / 30.0, img, uimg=_uimg(img),
                           force_kf=True if i in force_kf_at else None)
    return slam


def _same_layout(a, b):
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def _assert_state(t, path):
    """The port system `t` holds the state of the file at `path`."""
    d = np.load(path)
    n = d["kf_T_WC"].shape[0]
    assert t.mem.count == t.n_kf == n
    for key, name in MEM.items():
        np.testing.assert_array_equal(getattr(t.mem, name)[:n].numpy(), d[key], err_msg=key)
    ne = t.graph.n_edges
    assert ne == d["graph_ii"].shape[0]
    np.testing.assert_array_equal(t.graph.ii[:ne], d["graph_ii"])
    np.testing.assert_array_equal(t.graph.jj[:ne], d["graph_jj"])
    np.testing.assert_array_equal(t.graph.idx[:ne].numpy(), d["graph_idx"])
    np.testing.assert_array_equal(t.graph.valid_match[:ne].numpy(), d["graph_valid"])
    np.testing.assert_array_equal(t.graph.Q[:ne].numpy(), d["graph_Q"])
    np.testing.assert_array_equal(np.stack(t.frame_poses), d["frame_poses"])
    assert t.frame_ids == d["frame_ids"].tolist() and int(t.mode) == int(d["mode"])
    np.testing.assert_array_equal(t.last_T_WC, d["last_T_WC"])
    np.testing.assert_array_equal(t._last_T_WC_dev.numpy(), d["last_T_WC"])
    for i in range(n):
        assert (t.kf_uimgs[i] is not None) == bool(d["kf_uimg_valid"][i])
        if t.kf_uimgs[i] is not None:
            np.testing.assert_array_equal(t.kf_uimgs[i], d["kf_uimg"][i])
        assert (t.kf_dyn_masks[i] is not None) == bool(d["kf_dyn_mask_valid"][i])


def test_state_files_cross_between_the_packages(weights, tmp_path):
    img = _smooth_frame(0)
    js = _JaxF32SLAM(params=weights[0], model_cfg=JTINY, cfg=_cfg(jload_config), img_size=(H, W),
                     kf_capacity=8)
    ts = _port(weights)
    for s in (js, ts):  # the last frame a keyframe: two keyframes, one edge pair
        _run(s, [img] * 3, force_kf_at=(2,))
    js.kf_dyn_masks[0] = np.zeros((H, W), bool)
    js.kf_dyn_masks[0][10:20, 10:20] = True
    js.save_state(tmp_path / "jax.npz")
    ts.save_state(tmp_path / "port.npz")
    _same_layout(np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz"))

    t2 = _port(weights)
    t2.load_state(tmp_path / "jax.npz")  # JAX -> port
    _assert_state(t2, tmp_path / "jax.npz")
    np.testing.assert_array_equal(t2.kf_dyn_masks[0], js.kf_dyn_masks[0])
    t2.save_state(tmp_path / "port_again.npz")
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port_again.npz")
    _same_layout(a, b)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    j2 = _JaxF32SLAM(params=weights[0], model_cfg=JTINY, cfg=_cfg(jload_config),
                     img_size=(H, W), kf_capacity=8)
    j2.load_state(tmp_path / "port.npz")  # port -> JAX
    d = np.load(tmp_path / "port.npz")
    assert int(j2.mem.count) == d["kf_T_WC"].shape[0] and j2.graph.n_edges == d["graph_ii"].shape[0]
    for key, name in MEM.items():
        np.testing.assert_array_equal(np.asarray(getattr(j2.mem, name))[: int(j2.mem.count)],
                                      d[key], err_msg=key)
    np.testing.assert_array_equal(np.asarray(j2.graph.idx[: j2.graph.n_edges]), d["graph_idx"])
    assert j2.frame_ids == ts.frame_ids and j2.mode == ts.mode


def test_port_round_trip_drops_the_old_caches(weights, tmp_path):
    s = _run(_port(weights), [_smooth_frame(0)] * 3, force_kf_at=(2,))
    assert s.idx_f2k is None and s._kf_cache is None  # the keyframe event reset both
    s.process_frame(3, 0.1, _smooth_frame(0))
    assert s.idx_f2k is not None and s._kf_cache is not None
    s.save_state(tmp_path / "s.npz")
    s2 = _run(_port(weights), [_smooth_frame(1)] * 2)  # another state, with warm caches
    assert s2.idx_f2k is not None and s2._kf_cache is not None
    s2.load_state(tmp_path / "s.npz")
    _assert_state(s2, tmp_path / "s.npz")
    assert s2.idx_f2k is None and s2._kf_cache is None and s2.mode == Mode.TRACKING
    assert not np.allclose(s2.keyframe_colors(), 0.5)  # the exports keep their colours
    # a file from before the score and the host-side images were kept
    d = dict(np.load(tmp_path / "s.npz"))
    for k in ("kf_score", "kf_uimg", "kf_uimg_valid", "kf_dyn_mask", "kf_dyn_mask_valid"):
        d.pop(k)
    np.savez(tmp_path / "old.npz", **d)
    s3 = _port(weights)
    s3.load_state(tmp_path / "old.npz")
    assert s3.mem.count == 2 and s3.kf_uimgs == [None, None]
    assert float(s3.mem.score[:2].abs().sum()) == 0.0
    s3.process_frame(4, 0.2, _smooth_frame(0))
    assert s3.mode == Mode.TRACKING and len(s3.frame_poses) == 5


def test_resumed_run_decides_as_an_uninterrupted_one(tmp_path):
    tp = init_params(torch.Generator().manual_seed(0), TTINY)
    tp["dec_blocks2"], tp["head2"] = tp["dec_blocks"], tp["head1"]

    def make():
        return _port((None, tp), match_frac_thresh=0.5, min_match_frac=0.0, C_conf=0.0)

    frames = synth_video(10)
    whole = _run(make(), frames)
    first = _run(make(), frames[:3])
    first.save_state(tmp_path / "mid.npz")
    rest = make()
    rest.load_state(tmp_path / "mid.npz")
    _run(rest, frames[3:], first=3)
    assert rest.frame_ids == whole.frame_ids
    kf = whole.mem.frame_id[: whole.n_kf].tolist()
    assert kf == [0, 1, 2, 3]  # keyframe events before and after the resume
    assert rest.mem.frame_id[: rest.n_kf].tolist() == kf
    assert rest.n_reloc_attempts == whole.n_reloc_attempts > 0 and rest.mode == whole.mode
    np.testing.assert_allclose(np.stack(rest.frame_poses), np.stack(whole.frame_poses),
                               atol=1e-4)
