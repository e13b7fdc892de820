"""The port's Easi3R SLAMSystem against the JAX package's, on the scenario
of tests/test_pipeline_easi3r.py: TINY MASt3R and no-descriptor TINY Easi3R
(DUSt3R-architecture) weights, JAX's init carried over with
`params_from_jax`, `synth_video(5, seed=11)` at 64x80, config/base.yaml
synchronous with the confidence and match gates opened and
`use_dynamic_mask` off (the masks come from the attention). Both sides
compute in f32: the JAX package's MASt3R encode/decode are called with
dtype float32, and its Easi3R decoder, which fixes bf16 inside
`easi3r_double_inference_pair`, is traced with `_decode_pair_attn` forced
to f32.

* The pair inference: C and Q zeroed exactly on the attention mask and
  untouched elsewhere, D from MASt3R; the masks equal JAX's, X and C within
  1e-4 of their scale (the f32 twin of tests/test_torch_easi3r.py: 2e-5).
* The pipeline: the same modes, keyframes and graph edges per frame; poses
  within 1e-3, the tolerance of the other f32 twins in tiled mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.app.pipeline import SLAMSystem as JSLAM
from monst3r_slam_tpu.dynamic import easi3r as jeasi3r
from monst3r_slam_tpu.dynamic.inference import EasiParams as JEasi
from monst3r_slam_tpu.dynamic.inference import easi3r_asymmetric_inference as jinfer
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.models.init import init_params
from monst3r_slam_tpu.slam import retrieval as jretrieval
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.app.pipeline import SLAMSystem as TSLAM
from monst3r_slam_torch.dynamic import easi3r as teasi3r
from monst3r_slam_torch.dynamic.inference import EasiParams as TEasi
from monst3r_slam_torch.dynamic.inference import easi3r_asymmetric_inference as tinfer
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.slam import retrieval as tretrieval
from tests.test_pipeline import H, W, synth_video
from tests.test_torch_pipeline_dynamic import jax_f32  # noqa: F401
from tests.test_torch_slam import one_torch_thread  # noqa: F401

JNODESC = dataclasses.replace(JTINY, desc_dim=None, two_confs=False)
TNODESC = dataclasses.replace(TTINY, desc_dim=None, two_confs=False)


@pytest.fixture(scope="module")
def weights():
    mast3r = init_params(jax.random.PRNGKey(0), JTINY)
    easi = init_params(jax.random.PRNGKey(1), JNODESC)
    jp = JEasi(easi, JNODESC, mast3r, JTINY, k_mad=2.0)
    tp = TEasi(params_from_jax(jax.tree.map(np.asarray, easi)), TNODESC,
               params_from_jax(jax.tree.map(np.asarray, mast3r)), TTINY, k_mad=2.0)
    return jp, tp


@pytest.fixture
def jax_easi3r_f32(jax_f32, monkeypatch):  # noqa: F811
    """The JAX package's Easi3R decoder in f32: a new jitted function that
    traces `easi3r_double_inference_pair` with `_decode_pair_attn` forced to
    f32, in the module's place (the pair inference imports it at call
    time); with `jax_f32`, its MASt3R model in f32 too."""
    body = jeasi3r.easi3r_double_inference_pair.__wrapped__

    def double_f32(params, cfg, feat1, pos1, feat2, pos2, shape, k_mad=2.0):
        return body(params, cfg, feat1, pos1, feat2, pos2, shape, k_mad)

    monkeypatch.setattr(jeasi3r, "_decode_pair_attn",
                        functools.partial(jeasi3r._decode_pair_attn, dtype=jnp.float32))
    monkeypatch.setattr(jeasi3r, "easi3r_double_inference_pair",
                        jax.jit(double_f32, static_argnames=("cfg", "shape", "k_mad")))


def test_easi3r_inference_gates_c_and_q_on_the_mask(weights, jax_easi3r_f32):
    jp, tp = weights
    imgs = synth_video(2, seed=5)
    jf = [a for img in imgs for a in jmodel.encode(jp.easi3r, JNODESC, jnp.asarray(img)[None])]
    tf = [torch.from_numpy(np.array(a)) for a in jf]
    ref = jinfer(jp, *jf, (H, W))
    out = tinfer(tp, *tf, (H, W), dtype=torch.float32)
    raw = teasi3r.easi3r_double_inference_pair(tp.easi3r, TNODESC, *tf, (H, W), k_mad=tp.k_mad,
                                               dtype=torch.float32)
    plain = tmodel.decode(tp.mast3r, TTINY, *tf, (H, W), torch.float32)
    assert out.X1.shape == (1, H, W, 3) and out.D1.shape[-1] == TTINY.desc_dim
    for v in ("1", "2"):
        keep = ~getattr(raw, "dyn_mask" + v)
        assert torch.equal(getattr(out, "C" + v), getattr(raw, "C" + v) * keep)
        assert torch.equal(getattr(out, "Q" + v), getattr(plain, "Q" + v) * keep)
        assert torch.equal(getattr(out, "X" + v), getattr(raw, "X" + v))
        assert torch.equal(getattr(out, "D" + v), getattr(plain, "D" + v))
        # the JAX package zeroes on the same mask
        jzero = np.asarray(getattr(ref, "C" + v)) == 0
        np.testing.assert_array_equal(jzero, (~keep).numpy() | (getattr(out, "C" + v) == 0).numpy())
    assert bool(raw.dyn_mask1.any()) and (out.Q1[raw.dyn_mask1] == 0).all()
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        np.testing.assert_allclose(b, a, atol=1e-4 * np.abs(a).max(), rtol=0)


def _cfg(load):
    cfg = load("config/base.yaml")
    cfg["single_thread"] = True
    cfg["parallel"] = {"mesh": "off"}
    cfg["tracking"].update(Q_conf=-1e9, C_conf=-1e9, min_match_frac=0.0)
    cfg["local_opt"].update(Q_conf=-1e9, min_match_frac=0.0, solver="device")
    cfg["use_dynamic_mask"] = False  # Easi3R masks inside the pair decode
    return cfg


def test_easi3r_pipeline_matches_jax(weights, jax_easi3r_f32):
    jp, tp = weights
    rparams = jretrieval.init_retrieval_params(jax.random.PRNGKey(2), JTINY.enc_dim, hdims=(32,))
    codebook = np.asarray(jretrieval.make_random_codebook(jax.random.PRNGKey(3), 128, 32))
    js = JSLAM(params=jp.mast3r, model_cfg=JTINY, cfg=_cfg(jload_config), img_size=(H, W),
               retrieval_params=rparams,
               retrieval_db=jretrieval.ASMKDatabase(jnp.asarray(codebook)), kf_capacity=16,
               easi3r=jp)
    ts = TSLAM(params=tp.mast3r, model_cfg=TTINY,
               cfg=_cfg(lambda p: tload_config(p, set_global=False)), img_size=(H, W),
               retrieval_params=tretrieval.retrieval_params_from_numpy(
                   jax.tree.map(np.asarray, rparams)),
               retrieval_db=tretrieval.ASMKDatabase(codebook.copy()), kf_capacity=16,
               device="cpu", dtype=torch.float32, easi3r=tp)
    j_modes, t_modes = [], []
    for i, img in enumerate(synth_video(5, seed=11)):
        uimg = np.uint8(np.clip((img + 1) / 2, 0, 1) * 255)
        for slam, modes in ((js, j_modes), (ts, t_modes)):
            slam.process_frame(i, i / 30.0, img, uimg=uimg)
            modes.append(int(slam.mode))
    js.finalize()
    ts.finalize()
    assert t_modes == j_modes
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.graph.edge_list() == js.graph.edge_list()
    poses = np.stack(ts.frame_poses)
    assert len(poses) == 5 and np.isfinite(poses).all() and ts.n_kf >= 1
    np.testing.assert_allclose(np.linalg.norm(poses[:, 3:7], axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(poses, np.stack(js.frame_poses), atol=1e-3)
    print("modes", t_modes, "keyframes", ts.keyframe_trajectory()[1].tolist(),
          "edges", ts.graph.edge_list())
