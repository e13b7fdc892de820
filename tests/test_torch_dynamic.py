"""The port's dynamic-mask math (`dynamic/mask.py`), native refiner and
temporal propagator (`dynamic/refine.py`) and mask overlay (`viz/debug.py`)
against the JAX package's, on the same numpy inputs from a seed.

Tolerances: the ego-motion flow within 1e-4 px and the error map within
1e-6 (f32 order); masks equal (DIS flow is the same cv2 call on both sides);
the refiner's and the propagator's host numpy/scipy/OpenCV code equal bit
for bit. `cv2.grabCut` initializes its colour models from OpenCV's global
RNG, so `cv2.setRNGSeed` is called before each side's call of anything that
refines. The overlay PNGs are byte-identical."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.core import lie as jlie
from monst3r_slam_tpu.dynamic import mask as jmask
from monst3r_slam_tpu.dynamic import refine as jrefine
from monst3r_slam_tpu.viz import debug as jdebug
from monst3r_slam_torch.dynamic import mask as tmask
from monst3r_slam_torch.dynamic import refine as trefine
from monst3r_slam_torch.viz import debug as tdebug

H, W = 48, 64


def _poses():
    T_i = np.asarray(jlie.sim3_retr(jlie.sim3_identity(),
                                    jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.01, 0.03, 0.05])))
    T_j = np.asarray(jlie.sim3_retr(jnp.asarray(T_i),
                                    jnp.asarray([0.03, 0.01, -0.02, 0.01, 0.02, 0.0, -0.02])))
    return T_i, T_j


K = np.asarray([[50.0, 0, W / 2 - 0.5], [0, 52.0, H / 2 + 0.3], [0, 0, 1]], np.float32)


def _scene(i=0, seed=0):
    """A textured background with a bright blob at x = 20 + 4 i, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([np.sin(0.3 * xx + 0.2 * yy), np.cos(0.25 * yy - 0.1 * xx),
                    np.sin(0.15 * (xx - yy))], -1) * 0.25 + 0.4
    img += 0.03 * rng.standard_normal(img.shape)
    blob = (xx - 20 - 4 * i) ** 2 + (yy - 24) ** 2 < 64
    img[blob] = (0.95, 0.1, 0.1)
    return np.uint8(np.clip(img, 0, 1) * 255), blob


def _err(blob, seed=0):
    rng = np.random.default_rng(seed)
    from scipy import ndimage

    e = ndimage.gaussian_filter(blob.astype(np.float32), 2.0) * 0.9
    return np.clip(e + 0.05 * rng.random(blob.shape), 0, 1).astype(np.float32)


def test_ego_motion_flow_and_error_map_match_jax():
    T_i, T_j = _poses()
    depth = (1.5 + np.random.default_rng(1).random((H, W))).astype(np.float32)
    ref = np.asarray(jmask.ego_motion_flow(jnp.asarray(T_i), jnp.asarray(T_j), jnp.asarray(depth),
                                           jnp.asarray(K)))
    got = tmask.ego_motion_flow(T_i, T_j, torch.from_numpy(depth), K).numpy()
    assert np.abs(ref).max() > 1.0  # the pose pair moves pixels
    np.testing.assert_allclose(got, ref, atol=1e-4)
    flow = np.random.default_rng(2).standard_normal((H, W, 2)).astype(np.float32)
    e_ref = np.asarray(jmask.flow_error_map(jnp.asarray(flow), jnp.asarray(ref)))
    e_got = tmask.flow_error_map(torch.from_numpy(flow), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(e_got, e_ref, atol=1e-6)
    assert (tmask.flow_error_map(torch.ones(4, 4, 2), torch.zeros(4, 4, 2)) == 0).all()


@pytest.mark.parametrize("refine", [False, True])
def test_get_dynamic_mask_dis_matches_jax(refine):
    """OpenCV DIS flow of the moving blob against the ego-motion flow, on
    both sides; with `refine` the native hysteresis + GrabCut refiner."""
    (u0, _), (u1, _) = _scene(0), _scene(1)
    T_i, T_j = _poses()
    depth = np.full((H, W), 2.0, np.float32)
    args = (u0, u1)
    cv2.setRNGSeed(3)
    ref = jmask.get_dynamic_mask(*args, jnp.asarray(T_i), jnp.asarray(T_j), jnp.asarray(depth),
                                 jnp.asarray(K), threshold=0.35, refine=refine)
    cv2.setRNGSeed(3)
    got = tmask.get_dynamic_mask(*args, T_i, T_j, torch.from_numpy(depth), K, threshold=0.35,
                                 refine=refine)
    assert got.dtype == bool and got.shape == (H, W) and got.any()
    np.testing.assert_array_equal(got, ref)


def test_overlap_cb_runs_exactly_once():
    """Every route of get_dynamic_mask calls overlap_cb exactly once: without
    K, on the host flow (up front), with a program that takes the callback
    (inside it, after its enqueue), and with one that does not (up front)."""
    (u0, _), (u1, _) = _scene(0), _scene(1)
    T_i, T_j = _poses()
    depth = np.full((H, W), 2.0, np.float32)
    order = []

    def cb():
        order.append("cb")

    def takes(img_i, img_j, T_WCi, T_WCj, depth_i, K, overlap_cb=None):
        order.append("enqueue")
        overlap_cb()
        order.append("read")
        return np.zeros((H, W), np.float32)

    def plain(img_i, img_j, T_WCi, T_WCj, depth_i, K):
        order.append("program")
        return np.zeros((H, W), np.float32)

    m = tmask.get_dynamic_mask(u0, u1, T_i, T_j, depth, None, overlap_cb=cb)
    assert order == ["cb"] and not m.any()
    order.clear()
    tmask.get_dynamic_mask(u0, u1, T_i, T_j, depth, K, overlap_cb=cb)
    assert order == ["cb"]
    try:
        for fn, want in ((takes, ["enqueue", "cb", "read"]), (plain, ["cb", "program"])):
            order.clear()
            tmask.set_flow_error_program(fn)
            assert tmask._flow_error_program[1] == (fn is takes)
            tmask.get_dynamic_mask(u0, u1, T_i, T_j, depth, K, overlap_cb=cb)
            assert order == want
    finally:
        tmask.set_flow_error_program(None)


def test_apply_dynamic_mask_native_matches_jax():
    rng = np.random.default_rng(4)
    C, Q = (rng.random((1, H, W)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal((1, H, W, 24)).astype(np.float32)
    m = rng.random((H, W)) < 0.3
    ref = jmask.apply_dynamic_mask_native(jnp.asarray(C), jnp.asarray(D), jnp.asarray(Q),
                                          jnp.asarray(m))
    got = tmask.apply_dynamic_mask_native(torch.from_numpy(C), torch.from_numpy(D),
                                          torch.from_numpy(Q), m)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_refiner_functions_match_jax():
    img, blob = _scene(0)
    err = _err(blob)
    raw = err > 0.35
    np.testing.assert_array_equal(trefine.hysteresis_mask(err, 0.35, 0.15),
                                  jrefine.hysteresis_mask(err, 0.35, 0.15))
    np.testing.assert_array_equal(
        np.asarray(tmask.connected_component_centroids(raw)),
        np.asarray(jmask.connected_component_centroids(raw)))
    for scale in (1, 3):
        cv2.setRNGSeed(5)
        ref = jrefine.grabcut_refine(img, raw, scale=scale)
        cv2.setRNGSeed(5)
        got = trefine.grabcut_refine(img, raw, scale=scale)
        np.testing.assert_array_equal(got, ref)
    for use_grabcut in (False, True):
        cv2.setRNGSeed(6)
        ref = jrefine.refine_dynamic_mask(img, err, raw, use_grabcut=use_grabcut)
        cv2.setRNGSeed(6)
        got = trefine.make_native_refiner(use_grabcut=use_grabcut)(img, err, raw, 0.35, 20)
        assert got.any()
        np.testing.assert_array_equal(got, ref)
    flow = np.random.default_rng(7).normal(2.0, 1.0, (H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(trefine.forward_warp_mask(raw, flow),
                                  jrefine.forward_warp_mask(raw, flow))


@pytest.mark.parametrize("installed", [False, True])
def test_temporal_propagator_sequence_matches_jax(installed):
    """Four frames of the moving blob, the third with no fresh evidence (it
    coasts: only the carried support can seed it). With
    `installed` the propagator's own adapter is also the installed refiner:
    it must not call back into itself."""
    jp, tp = jrefine.TemporalMaskPropagator(), trefine.TemporalMaskPropagator()
    if installed:
        jmask.set_mask_refiner(jp.as_refiner())
        tmask.set_mask_refiner(tp.as_refiner())
    try:
        for i in range(4):
            img, blob = _scene(i, seed=i)
            err = _err(blob, seed=i) * (0.3 if i == 2 else 1.0)
            raw = err > 0.35
            cv2.setRNGSeed(10 + i)
            ref = jp(img, err, raw, 0.35, 20)
            cv2.setRNGSeed(10 + i)
            got = tp(img, err, raw, 0.35, 20)
            np.testing.assert_array_equal(got, ref)
            assert got.any() or i == 2, i
            assert tp._coast == jp._coast == (1 if i == 2 else 0)
    finally:
        jmask.set_mask_refiner(None)
        tmask.set_mask_refiner(None)
    tp.reset()
    assert tp.prev_mask is None and tp._coast == 0


def test_save_mask_overlay_is_byte_identical(tmp_path):
    img, blob = _scene(0)
    for name, src in (("u8", img), ("unit", img.astype(np.float32) / 255.0),
                      ("chw", np.transpose(img, (2, 0, 1)))):
        jdebug.save_mask_overlay(tmp_path / "j" / f"{name}.png", src, blob, color=(0, 255, 0))
        tdebug.save_mask_overlay(tmp_path / "t" / f"{name}.png", src, blob, color=(0, 255, 0))
        assert (tmp_path / "t" / f"{name}.png").read_bytes() == \
            (tmp_path / "j" / f"{name}.png").read_bytes()


@pytest.mark.parametrize("with_dq", [True, False])
def test_apply_dynamic_mask_to_pointmaps_matches_jax(with_dq):
    """The flat-layout zeroing (B, hw, ...) with and without D and Q,
    equal to JAX's."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2, H * W, 3)).astype(np.float32)
    C, Q = (rng.random((2, H * W, 1)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal((2, H * W, 24)).astype(np.float32)
    m = rng.random((2, H * W)) < 0.3
    args = (X, C, D, Q) if with_dq else (X, C, None, None)
    ref = jmask.apply_dynamic_mask_to_pointmaps(
        *(None if a is None else jnp.asarray(a) for a in args), jnp.asarray(m))
    got = tmask.apply_dynamic_mask_to_pointmaps(
        *(None if a is None else torch.from_numpy(a) for a in args), torch.from_numpy(m))
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0] is not None and not got[1][torch.from_numpy(m)].any()
