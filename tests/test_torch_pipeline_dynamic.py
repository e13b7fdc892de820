"""The port's dynamic (MonST3R + MASt3R) SLAMSystem against the JAX
package's, on the scenario of tests/test_pipeline_dynamic.py: TINY MASt3R and
no-descriptor TINY MonST3R weights (JAX's init carried over with
`params_from_jax`), `synth_video(5, seed=7)` at 64x80, the calibrated K, the
confidence and match gates opened, config/base.yaml's masking with the
native refiner and the temporal propagator. Both models run in f32 (the JAX
package's encode/decode are called with dtype float32 here).

It runs with OpenCV DIS flow (the same cv2 call on both sides), and with a
RAFT program at 2 iterations installed on both sides (the JAX RAFT's weights
carried over with `raft_params_from_numpy`). Random untied weights lose
every tracked frame there (modes 1, 2, 1, 2, 1: frames 1 and 3 are tracked
with their masks, then lost; 2 and 4 relocalize), so a third run ties each
model's decoder streams and heads to one draw on a repeated frame, as
chip_smoke.py drives the card, where every frame tracks with RAFT's mask
applied and becomes a keyframe event. GrabCut draws from OpenCV's global
RNG, so `cv2.setRNGSeed(frame)` is called before each side's frame, the two
sides interleaved frame by frame.

A fourth run is the DIS one with the SAM2 image refiner (SAM2_TEST, the
JAX weights carried over with `sam2_params_from_numpy`) installed on both
sides, which the temporal propagator then refines with.

Per frame: the same modes, keyframes and graph edges; masks equal except on
pixels whose error map lies within one uint8 step (1/255) of the threshold
on either side; the error maps within 1e-4 (DIS) or one uint8 step (RAFT).
Poses within 1e-3. Measured on the DIS run: masks equal on every pixel, the
maps within 3.8e-5, the poses equal."""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.app.pipeline import SLAMSystem as JSLAM
from monst3r_slam_tpu.dynamic import mask as jmask
from monst3r_slam_tpu.dynamic import raft as jraft
from monst3r_slam_tpu.dynamic import sam2 as jsam2
from monst3r_slam_tpu.dynamic.inference import DualParams as JDual
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.models.init import init_params
from monst3r_slam_tpu.slam import retrieval as jretrieval
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.app.pipeline import SLAMSystem as TSLAM
from monst3r_slam_torch.dynamic import mask as tmask
from monst3r_slam_torch.dynamic import raft as traft
from monst3r_slam_torch.dynamic import sam2 as tsam2
from monst3r_slam_torch.dynamic.inference import DualParams as TDual
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.slam import retrieval as tretrieval
from tests.test_pipeline import H, W, synth_video
from tests.test_torch_slam import one_torch_thread  # noqa: F401

K = np.asarray([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1.0]], np.float32)
STEP = 1.0 / 255.0


def _cfg(load, tied=False):
    cfg = load("config/base.yaml")
    cfg["single_thread"] = True
    cfg["parallel"] = {"mesh": "off"}
    if tied:  # the gates of tests/test_torch_slam_model.py
        # random RAFT flow is a smooth random field: at 0.35 the refined mask
        # covers 97% of the frame and nothing tracks; at 0.8, 63-65%
        cfg["dynamic_mask_threshold"] = 0.8
        cfg["tracking"]["Q_conf"] = 0.0
        cfg["local_opt"].update(Q_conf=0.0, solver="device")
        cfg["matching"]["mode"] = "tiled"
    else:
        cfg["tracking"].update(Q_conf=-1e9, C_conf=-1e9, min_match_frac=0.0)
        cfg["local_opt"].update(Q_conf=-1e9, min_match_frac=0.0, solver="device")
    cfg["use_dynamic_mask"] = True
    cfg["use_calib"] = True
    for key in ("debug_save_dynamic_mask", "debug_save_final_valid_opt_mask",
                "debug_save_pointmap_visualization", "debug_save_3d_pointclouds"):
        cfg[key] = False
    return cfg


@pytest.fixture
def jax_f32(monkeypatch):
    """The JAX package's model in f32, as the port's runs on the CPU."""
    enc, dec = jmodel.encode, jmodel.decode
    monkeypatch.setattr(jmodel, "encode", lambda *a, **k: enc(*a, **{**k, "dtype": jnp.float32}))
    monkeypatch.setattr(jmodel, "decode", lambda *a, **k: dec(*a, **{**k, "dtype": jnp.float32}))


def _systems(tied=False):
    mast3r = init_params(jax.random.PRNGKey(0), JTINY)
    nodesc = dataclasses.replace(JTINY, desc_dim=None, two_confs=False)
    monst3r = init_params(jax.random.PRNGKey(1), nodesc)
    if tied:  # each model's decoder streams and heads share one draw
        for p in (mast3r, monst3r):
            p["dec_blocks2"], p["head2"] = p["dec_blocks"], p["head1"]
    rparams = jretrieval.init_retrieval_params(jax.random.PRNGKey(2), JTINY.enc_dim, hdims=(32,))
    codebook = np.asarray(jretrieval.make_random_codebook(jax.random.PRNGKey(3), 128, 32))
    js = JSLAM(params=mast3r, model_cfg=JTINY, cfg=_cfg(jload_config, tied), img_size=(H, W),
               K=jnp.asarray(K), retrieval_params=rparams,
               retrieval_db=jretrieval.ASMKDatabase(jnp.asarray(codebook)), kf_capacity=16,
               dual=JDual(monst3r, nodesc, mast3r, JTINY))
    tnodesc = dataclasses.replace(TTINY, desc_dim=None, two_confs=False)
    tp = {name: params_from_jax(jax.tree.map(np.asarray, p)) for name, p in
          (("mast3r", mast3r), ("monst3r", monst3r))}
    ts = TSLAM(params=tp["mast3r"], model_cfg=TTINY,
               cfg=_cfg(lambda p: tload_config(p, set_global=False), tied), img_size=(H, W),
               K=torch.from_numpy(K),
               retrieval_params=tretrieval.retrieval_params_from_numpy(
                   jax.tree.map(np.asarray, rparams)),
               retrieval_db=tretrieval.ASMKDatabase(codebook.copy()), kf_capacity=16,
               device="cpu", dtype=torch.float32,
               dual=TDual(tp["monst3r"], tnodesc, tp["mast3r"], TTINY))
    return js, ts


class _Recorder:
    """Keeps the error map each side's mask was thresholded from."""

    def __init__(self):
        self.maps = []

    def wrap_map(self, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.maps.append(np.asarray(out))
            return out
        return wrapped


def _run_twin(js, ts, jrec, trec, frames=None):
    j_masks, t_masks, j_modes, t_modes = [], [], [], []
    for i, img in enumerate(synth_video(5, seed=7) if frames is None else frames):
        uimg = np.uint8(np.clip((img + 1) / 2, 0, 1) * 255)
        for slam, masks, modes in ((js, j_masks, j_modes), (ts, t_masks, t_modes)):
            cv2.setRNGSeed(i)
            n_maps = len((jrec if slam is js else trec).maps)
            slam.process_frame(i, i / 30.0, img, uimg=uimg)
            masked = len((jrec if slam is js else trec).maps) > n_maps
            masks.append(np.asarray(slam._last_dyn_mask) if masked else None)
            modes.append(int(slam.mode))
    js.finalize()
    ts.finalize()
    return j_masks, t_masks, j_modes, t_modes


def _check(js, ts, jrec, trec, run, map_tol, modes=(1, 2, 1, 2, 1)):
    j_masks, t_masks, j_modes, t_modes = run
    assert t_modes == j_modes == list(modes)
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.graph.edge_list() == js.graph.edge_list()
    assert [m is None for m in t_masks] == [m is None for m in j_masks]
    # a frame is masked when it is tracked: when the previous one left TRACKING
    assert len(trec.maps) == len(jrec.maps) == list(modes[:-1]).count(1)
    thr = ts.dyn_threshold
    for jm, tm, je, te in zip([m for m in j_masks if m is not None],
                              [m for m in t_masks if m is not None], jrec.maps, trec.maps):
        np.testing.assert_allclose(te, je, atol=map_tol)
        near = (np.abs(je - thr) <= STEP) | (np.abs(te - thr) <= STEP)
        np.testing.assert_array_equal(tm[~near], jm[~near])
    assert any(m.any() for m in t_masks if m is not None)  # a mask was applied
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=1e-3)


def test_dynamic_pipeline_dis_matches_jax(jax_f32, monkeypatch):
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jmask, "flow_error_map", jrec.wrap_map(jmask.flow_error_map))
    monkeypatch.setattr(tmask, "flow_error_map", trec.wrap_map(tmask.flow_error_map))
    js, ts = _systems()
    assert ts._mask_propagator is not None and ts.dyn_refine  # base.yaml refines
    _check(js, ts, jrec, trec, _run_twin(js, ts, jrec, trec), 1e-4)


@pytest.fixture
def sam2_both():
    """The same SAM2_TEST image refiner (random weights, the default prompt
    budget and IoU floor) installed on both sides."""
    jp = jax.jit(jsam2.init_sam2_params, static_argnums=1)(jax.random.PRNGKey(5), jsam2.SAM2_TEST)
    tref = tsam2.Sam2Refiner(tsam2.sam2_params_from_numpy(jax.tree.map(np.asarray, jp)),
                             tsam2.SAM2_TEST)
    jmask.set_mask_refiner(jsam2.Sam2Refiner(jp, jsam2.SAM2_TEST))
    tmask.set_mask_refiner(tref)
    yield tref
    jmask.set_mask_refiner(None)
    tmask.set_mask_refiner(None)


def test_dynamic_pipeline_sam2_refiner_matches_jax(jax_f32, sam2_both, monkeypatch):
    """The DIS scenario with the SAM2 image refiner installed on both sides:
    the temporal propagator refines each frame's seeds with it."""
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jmask, "flow_error_map", jrec.wrap_map(jmask.flow_error_map))
    monkeypatch.setattr(tmask, "flow_error_map", trec.wrap_map(tmask.flow_error_map))
    js, ts = _systems()
    _check(js, ts, jrec, trec, _run_twin(js, ts, jrec, trec), 1e-4)
    refiner = sam2_both
    assert refiner.calls == len(trec.maps) and refiner.replaced + refiner.rejected >= 1


@pytest.fixture
def raft_both():
    """The same random RAFT (2 iterations) installed on both sides as flow
    estimator and fused program, each program recording its maps."""
    cfg_j, cfg_t = jraft.RAFTConfig(iters=2), traft.RAFTConfig(iters=2)
    jparams = jraft.init_raft_params(jax.random.PRNGKey(4), cfg_j)
    tparams = traft.raft_params_from_numpy(jax.tree.map(np.asarray, jparams))
    jrec, trec = _Recorder(), _Recorder()
    jmask.set_flow_estimator(jraft.make_raft_flow_estimator(jparams, cfg_j))
    jmask.set_flow_error_program(
        jrec.wrap_map(jraft.make_fused_flow_error_program(jparams, cfg_j)), takes_overlap_cb=True)
    tmask.set_flow_estimator(traft.make_raft_flow_estimator(tparams, cfg_t))
    tmask.set_flow_error_program(
        trec.wrap_map(traft.make_fused_flow_error_program(tparams, cfg_t)), takes_overlap_cb=True)
    yield jrec, trec
    for mod in (jmask, tmask):
        mod.set_flow_estimator(None)
        mod.set_flow_error_program(None)


def test_dynamic_pipeline_raft_matches_jax(jax_f32, raft_both):
    jrec, trec = raft_both
    js, ts = _systems()
    _check(js, ts, jrec, trec, _run_twin(js, ts, jrec, trec), STEP + 1e-6)


def test_dynamic_pipeline_tracks_masked_frames_as_jax(jax_f32, raft_both):
    """Each model's decoder streams and heads tied to one draw and one frame
    repeated, as chip_smoke.py drives the card (random weights carry no
    geometry: any change between two views, even a moving square, breaks
    their pointmaps' match). The random RAFT's flow masks part of every
    frame, and every frame tracks on the rest. The mask leaves too few
    matches for the keyframe gate, so every tracked frame is a keyframe
    event, whose edges both decoders decode before the global solve."""
    jrec, trec = raft_both
    js, ts = _systems(tied=True)
    run = _run_twin(js, ts, jrec, trec, frames=synth_video(1) * 3)
    _check(js, ts, jrec, trec, run, STEP + 1e-6, modes=(1, 1, 1))
    assert ts.n_kf == 3 and ts.graph.n_solves == 2
    assert all(m.any() for m in run[1][1:])
