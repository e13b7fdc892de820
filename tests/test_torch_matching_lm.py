"""Twins of the JAX package's iterative-projection (LM) matcher in the port
(`monst3r_slam_torch/core/image.py`, `ops/matching.py`), on the same numpy
inputs:

* `img_gradient` within 4e-7 (f32 sums of a 3x3 window in another order);
* `iter_proj` on the identity and on a three-pixel shift: the convergence
  flags equal, converged positions within 1e-3 px and the others (the
  clamped border) within 0.02 px, the distance by which one ulp of input
  moves JAX's own LM iterates; and on a flat patch (rays exactly (0, 0, 1),
  so both gradients are exactly 0) whose tiny `lambda_init` drives
  `det_inv` to inf: the step is NaN and both sides reject it, equal bit for
  bit;
* `refine_matches` equal bit for bit, on random descriptors and on
  descriptors in {-1, 0, 1} whose window scores tie exactly (the first
  maximum in u-major order wins on both sides);
* `match` end to end on sub-pixel shifts: indices and `valid` equal on at
  least 99.9% of the pixels (a pixel whose LM iterate lands in another
  integer cell refines in another window);
* `matcher_mode` / `make_matcher` with `lm`, and the SLAMSystem twin with
  `matching.mode: lm` (TINY tied weights in f32, as
  tests/test_torch_slam_model.py): same modes, keyframes and edges, poses
  within 1e-4; the edges' matches equal on at least 95% of the pixels (the
  tied model decodes a frame and its copy to equal pointmaps, so every LM
  answer sits on an integer pixel, where truncation turns on the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.core.image import img_gradient as j_img_gradient
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.ops import matching as jm
from monst3r_slam_torch.app import pipeline as tpipe
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.core.image import img_gradient as t_img_gradient
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.ops import matching as tm
from tests.test_torch_slam import one_torch_thread  # noqa: F401
from tests.test_torch_slam_model import H, W, _JaxF32SLAM, _smooth_frame


def smooth_pointmap(h, w, shift=(0.0, 0.0), fov=0.8):
    """Smooth positive depth over a pinhole ray grid, sampled `shift` pixels
    (x, y) away from the grid."""
    u = (np.arange(w, dtype=np.float32) + shift[0]) * (2 * fov / (w - 1)) - fov
    v = ((np.arange(h, dtype=np.float32) + shift[1]) * (2 * fov / (w - 1))
         - fov * (h - 1) / (w - 1))
    uu, vv = np.meshgrid(u, v)
    z = 2.0 + 0.5 * np.sin(2 * uu) * np.cos(3 * vv)
    return np.stack([uu * z, vv * z, z], axis=-1).astype(np.float32)[None]


def _t(x):
    return torch.from_numpy(np.array(x))


def _iter_proj_both(X11, X21, cfg_kw=None):
    cfg_kw = cfg_kw or {}
    rj, pj, pij = jm.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), None)
    pJ, cJ = jm.iter_proj(rj, pj, pij, jm.MatchingConfig(**cfg_kw))
    rt, pt, pit = tm.prep_for_iter_proj(_t(X11), _t(X21), None)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=4e-7)
    np.testing.assert_array_equal(pit.numpy(), np.asarray(pij))
    pT, cT = tm.iter_proj(rt, pt, pit, tm.MatchingConfig(**cfg_kw))
    return (np.asarray(pJ), np.asarray(cJ)), (pT.numpy(), cT.numpy())


def test_img_gradient_matches_jax():
    img = np.random.default_rng(0).standard_normal((2, 9, 11, 5)).astype(np.float32)
    for j, t in zip(j_img_gradient(jnp.asarray(img)), t_img_gradient(_t(img))):
        assert t.shape == img.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=4e-7)


@pytest.mark.parametrize("shift", [0, 3])
def test_iter_proj_matches_jax(shift):
    X = smooth_pointmap(24, 32)
    X21 = np.roll(X, -shift, axis=2)
    (pJ, cJ), (pT, cT) = _iter_proj_both(X, X21)
    np.testing.assert_array_equal(cT, cJ)
    np.testing.assert_allclose(pT[cJ], pJ[cJ], atol=1e-3)
    np.testing.assert_allclose(pT, pJ, atol=0.02)
    assert cT.mean() > 0.5  # the scene converges where the shift keeps it inside


def test_iter_proj_flat_patch_inf_step_is_rejected_as_in_jax():
    """A constant pointmap has zero gradients; with lambda_init 1e-30 the
    damped 2x2 determinant underflows to 0, det_inv is inf and the step
    NaN: both sides reject it and keep the clipped start."""
    X = np.broadcast_to(np.float32([0.0, 0.0, 2.0]), (1, 12, 16, 3)).copy()
    X21 = smooth_pointmap(12, 16)
    (pJ, cJ), (pT, cT) = _iter_proj_both(X, X21, dict(lambda_init=1e-30))
    start = np.stack(np.meshgrid(np.clip(np.arange(16), 1, 14), np.clip(np.arange(12), 1, 10)),
                     -1).reshape(1, -1, 2)
    np.testing.assert_array_equal(pT, start)  # every step was rejected
    np.testing.assert_array_equal(pT, pJ)
    np.testing.assert_array_equal(cT, cJ)
    assert np.isfinite(pT).all()


@pytest.mark.parametrize("ties", [False, True])
def test_refine_matches_matches_jax(ties):
    rng = np.random.default_rng(1)
    h, w, f, n = 16, 20, 8, 40
    if ties:  # small integers: exact scores, and most windows hold equal maxima
        D11 = rng.integers(-1, 2, (2, h, w, f)).astype(np.float32)
        D21 = rng.integers(-1, 2, (2, n, f)).astype(np.float32)
    else:
        D11 = rng.standard_normal((2, h, w, f)).astype(np.float32)
        D21 = rng.standard_normal((2, n, f)).astype(np.float32)
    p0 = np.stack([rng.integers(0, w, (2, n)), rng.integers(0, h, (2, n))], -1).astype(np.int32)
    for kw in (dict(), dict(radius=2, dilation_max=3)):
        pj = jm.refine_matches(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p0),
                               jm.MatchingConfig(**kw))
        pt = tm.refine_matches(_t(D11), _t(D21), _t(p0).long(), tm.MatchingConfig(**kw))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_match_matches_jax_end_to_end():
    h, w = 32, 48
    rng = np.random.default_rng(2)
    X = np.concatenate([smooth_pointmap(h, w)] * 2)
    X21 = np.concatenate([smooth_pointmap(h, w, (1.3, 0.4)), smooth_pointmap(h, w, (-2.6, 1.7))])
    D = rng.standard_normal((2, h, w, 16)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    D21 = np.roll(D, 1, axis=2)
    for warm in (None, np.roll(np.arange(h * w), 2)[None].repeat(2, 0)):
        ij, vj = jm.match(*map(jnp.asarray, (X, X21, D, D21)),
                          None if warm is None else jnp.asarray(warm))
        it, vt = tm.match(*map(_t, (X, X21, D, D21)), None if warm is None else _t(warm))
        assert it.shape == (2, h * w) and vt.shape == (2, h * w, 1) and vt.dtype == torch.bool
        ij, it = np.asarray(ij), it.numpy()
        assert (it == ij).mean() >= 0.999 and (vt.numpy() == np.asarray(vj)).mean() >= 0.999
        assert np.asarray(vj).mean() > 0.5


def test_matcher_mode_takes_lm():
    cfg = {"matching": {"mode": "lm", "max_iter": 3, "lambda_init": 1e-6, "radius": 1}}
    assert tpipe.matcher_mode(cfg, "cpu") == "lm"
    mcfg = tpipe.matching_config_from_dict(cfg)
    assert (mcfg.max_iter, mcfg.lambda_init, mcfg.radius) == (3, 1e-6, 1)
    X = smooth_pointmap(16, 32)
    D = np.random.default_rng(3).standard_normal((1, 16, 32, 8)).astype(np.float32)
    idx, valid = tpipe.make_matcher(cfg, "cpu")(_t(X), _t(X), _t(D), _t(D))
    ref = tm.match(_t(X), _t(X), _t(D), _t(D), cfg=mcfg)
    assert torch.equal(idx, ref[0]) and torch.equal(valid, ref[1])


def test_lm_slam_matches_jax():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    jp["dec_blocks2"], jp["head2"] = jp["dec_blocks"], jp["head1"]
    tp = params_from_jax(jax.tree.map(np.asarray, jp))

    def cfg(load):
        c = load("config/base.yaml")
        c["tracking"]["Q_conf"] = 0.0
        c["local_opt"].update(Q_conf=0.0, solver="device")
        c["single_thread"] = True
        c["parallel"] = {"mesh": "off"}
        c["matching"]["mode"] = "lm"
        return c

    js = _JaxF32SLAM(params=jp, model_cfg=JTINY, cfg=cfg(jload_config), img_size=(H, W),
                     kf_capacity=8)
    ts = tpipe.SLAMSystem(params=tp, model_cfg=TTINY,
                          cfg=cfg(lambda p: tload_config(p, set_global=False)),
                          img_size=(H, W), kf_capacity=8, device="cpu", dtype=torch.float32)
    assert ts.match_mode == "lm" and ts.match_tcfg is None
    img = _smooth_frame(0)
    j_modes, t_modes = [], []
    for i in range(3):  # the last frame is made a keyframe: LM edge matches + global GN
        js.process_frame(i, i / 30.0, img, force_kf=True if i == 2 else None)
        ts.process_frame(i, i / 30.0, img, force_kf=True if i == 2 else None)
        j_modes.append(int(js.mode))
        t_modes.append(int(ts.mode))
    assert t_modes == j_modes == [1, 1, 1]
    np.testing.assert_array_equal(ts.last_summary[8:], np.asarray(js.last_summary)[8:])
    assert ts.n_kf == js.n_kf >= 2 and ts.graph.n_solves >= 1
    assert ts.graph.edge_list() == js.graph.edge_list()
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=1e-4)
    e = ts.graph.n_edges
    agree = (ts.graph.idx[:e].numpy() == np.asarray(js.graph.idx[:e])).mean()
    assert agree >= 0.95
