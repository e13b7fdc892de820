"""Twins of the JAX package's pointmap fusion and keyframe slot access
(`slam/frame.py`) in the port, on the same numpy inputs:

* every `filtering_mode` on a first observation (N_old == 0, which
  replaces) and on a later one, with `best_score` under both
  `filtering_score` values, better and worse scores; outputs equal to 1e-6
  (the modes are selections and one weighted mean; `weighted_spherical`'s
  trigonometry within 2e-6 of scale), N equal, the median score equal and
  the mean score within 5e-7 of itself (f32 sums in another order);
* `conf_score` on even and odd counts (the median, equal, is the midpoint of
  the two middle values, as `jnp.median`'s; the mean within 5e-7);
* `weighted_spherical` at r = 0 and on the poles (theta 0 and pi, where
  arctan2 meets x = y = 0);
* an unknown mode or score raises `ValueError` on both sides;
* `kf_set` (count bumped to max(count, idx + 1)), `kf_append`, `kf_get` and
  `kf_update_pointmap` (`N_updates` counted) against JAX's functional ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.slam import frame as jf
from monst3r_slam_torch.slam import frame as tf

MODES = ("first", "recent", "best_score", "indep_conf", "weighted_pointmap",
         "weighted_spherical")


def _obs(seed, n=37):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3)).astype(np.float32) + np.float32([0, 0, 2])
    C = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    return X, C


def _both(X_old, C_old, N_old, X_new, C_new, mode, score_old, fscore):
    j = jf.fuse_pointmap(jnp.asarray(X_old), jnp.asarray(C_old), jnp.asarray(N_old, jnp.int32),
                         jnp.asarray(X_new), jnp.asarray(C_new), mode,
                         jnp.asarray(score_old, jnp.float32), fscore)
    t = tf.fuse_pointmap(torch.from_numpy(X_old), torch.from_numpy(C_old),
                         torch.tensor(N_old, dtype=torch.int32), torch.from_numpy(X_new),
                         torch.from_numpy(C_new), mode, torch.tensor(score_old), fscore)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_old", [0, 3])
def test_fuse_pointmap_matches_jax(mode, n_old):
    X_old, C_old = _obs(0)
    X_new, C_new = _obs(1)
    for fscore in ("median", "mean"):
        for score_old in (0.5, 9.0):  # below and above the new observation's score
            (jX, jC, jN, jS), (tX, tC, tN, tS) = _both(X_old, C_old, n_old, X_new, C_new, mode,
                                                       score_old, fscore)
            tol = 2e-6 * np.abs(jX).max() if mode == "weighted_spherical" else 1e-6
            np.testing.assert_allclose(tX, jX, atol=tol)
            np.testing.assert_allclose(tC, jC, atol=1e-6)
            assert tN.dtype == np.int32 and int(tN) == int(jN)
            np.testing.assert_allclose(tS, jS, rtol=0 if fscore == "median" else 5e-7)
            if mode == "best_score" and n_old:
                assert (float(tS) == score_old) == (score_old == 9.0)  # 9 is never beaten


@pytest.mark.parametrize("n", [6, 7])
def test_conf_score_matches_jax(n):
    C = np.random.default_rng(2).uniform(0, 4, (n, 1)).astype(np.float32)
    for fscore in ("median", "mean"):
        j = float(jf.conf_score(jnp.asarray(C), fscore))
        t = float(tf.conf_score(torch.from_numpy(C), fscore))
        assert abs(t - j) <= (0 if fscore == "median" else 5e-7) * abs(j)
    assert float(tf.conf_score(torch.tensor([[1.0], [2.0], [4.0], [8.0]]))) == 3.0


def test_weighted_spherical_at_the_origin_and_the_poles():
    X_old = np.float32([[0, 0, 0], [0, 0, 2], [0, 0, -3], [1e-20, 0, 0], [0, -0.0, 1]])
    X_new = np.float32([[0, 0, 0], [0, 0, 1], [0, 0, -1], [0, 0, 0], [0, 0, 4]])
    C = np.ones((5, 1), np.float32)
    (jX, jC, jN, _), (tX, tC, tN, _) = _both(X_old, C, 2, X_new, C, "weighted_spherical", 0.0,
                                             "median")
    assert np.isfinite(tX).all()
    np.testing.assert_allclose(tX, jX, atol=2e-6)
    np.testing.assert_allclose(tX[:3], [[0, 0, 0], [0, 0, 1.5], [0, 0, -2]], atol=1e-6)


def test_unknown_mode_or_score_raises():
    X, C = _obs(0)
    with pytest.raises(ValueError):
        jf.fuse_pointmap(jnp.asarray(X), jnp.asarray(C), jnp.asarray(1), jnp.asarray(X),
                         jnp.asarray(C), "nearest")
    with pytest.raises(ValueError, match="unknown filtering_mode"):
        tf.fuse_pointmap(torch.from_numpy(X), torch.from_numpy(C), torch.tensor(1),
                         torch.from_numpy(X), torch.from_numpy(C), "nearest")
    with pytest.raises(ValueError, match="unknown filtering_score"):
        tf.conf_score(torch.from_numpy(C), "max")


def _frames(seed, h=4, w=8, enc_dim=6, patch=4):
    """The same keyframe as a JAX and a port Frame."""
    rng = np.random.default_rng(seed)
    hw, n = h * w, (h * w) // patch**2
    a = dict(T_WC=rng.standard_normal(8).astype(np.float32),
             X=rng.standard_normal((hw, 3)).astype(np.float32),
             C=rng.uniform(1, 2, (hw, 1)).astype(np.float32),
             feat=rng.standard_normal((1, n, enc_dim)).astype(np.float32),
             pos=rng.integers(0, 5, (1, n, 2)).astype(np.int32), score=np.float32(rng.uniform()))
    j = jf.Frame(frame_id=jnp.asarray(seed, jnp.int32), img=jnp.zeros((0,)),
                 T_WC=jnp.asarray(a["T_WC"]), X_canon=jnp.asarray(a["X"]), C=jnp.asarray(a["C"]),
                 N=jnp.asarray(2, jnp.int32), N_updates=jnp.asarray(1, jnp.int32),
                 feat=jnp.asarray(a["feat"]), pos=jnp.asarray(a["pos"]),
                 score=jnp.asarray(a["score"]))
    t = tf.Frame(frame_id=seed, T_WC=torch.from_numpy(a["T_WC"]), X_canon=torch.from_numpy(a["X"]),
                 C=torch.from_numpy(a["C"]), N=torch.tensor(2, dtype=torch.int32),
                 feat=torch.from_numpy(a["feat"]), pos=torch.from_numpy(a["pos"]),
                 score=torch.tensor(a["score"]), N_updates=torch.tensor(1, dtype=torch.int32))
    return j, t


def _assert_memories_equal(tm, jm_):
    """Equal, the best-score statistic (a mean here) within 5e-7 of itself."""
    assert tm.count == int(jm_.count)
    for f in dataclasses.fields(tm):
        if f.name != "count":
            np.testing.assert_allclose(getattr(tm, f.name).numpy(),
                                       np.asarray(getattr(jm_, f.name)),
                                       rtol=5e-7 if f.name == "score" else 0, err_msg=f.name)


def test_keyframe_slot_access_matches_jax():
    h, w, enc_dim, patch = 4, 8, 6, 4
    jm_ = jf.make_keyframe_memory(4, h, w, enc_dim, patch)
    tm = tf.make_keyframe_memory(4, h, w, enc_dim, patch)
    j0, t0 = _frames(0)
    j2, t2 = _frames(2)
    jm_ = jf.kf_append(jm_, j0)
    assert tf.kf_append(tm, t0) == 0
    jm_ = jf.kf_set(jm_, jnp.asarray(2, jnp.int32), j2)  # past the end: count to 3
    assert tf.kf_set(tm, 2, t2) == 2
    _assert_memories_equal(tm, jm_)
    jm_ = jf.kf_set(jm_, jnp.asarray(0, jnp.int32), j2)  # inside: count stays
    tf.kf_set(tm, 0, t2)
    _assert_memories_equal(tm, jm_)
    X, C = _obs(5, h * w)
    for mode in ("weighted_pointmap", "best_score"):
        jm_ = jf.kf_update_pointmap(jm_, jnp.asarray(2, jnp.int32), jnp.asarray(X),
                                    jnp.asarray(C), mode, "mean")
        tf.kf_update_pointmap(tm, 2, torch.from_numpy(X), torch.from_numpy(C), mode, "mean")
    _assert_memories_equal(tm, jm_)
    assert int(tm.N_updates[2]) == 3  # the frame's 1, plus two updates
    jg, tg = jf.kf_get(jm_, jnp.asarray(2, jnp.int32)), tf.kf_get(tm, 2)
    for name in ("frame_id", "T_WC", "X_canon", "C", "N", "N_updates", "feat", "pos", "score"):
        np.testing.assert_allclose(np.asarray(getattr(tg, name)), np.asarray(getattr(jg, name)),
                                   rtol=5e-7 if name == "score" else 0, err_msg=name)
    with pytest.raises(RuntimeError, match="outside the memory"):
        tf.kf_set(tm, 4, t0)


def test_make_empty_frame_and_average_conf_match_jax():
    """`make_empty_frame` against JAX's field by field (the port keeps feat,
    pos and img batched), and `get_average_conf` on it and on a fused frame
    (N = 0 divides by 1), exactly."""
    h, w, enc_dim, patch = 8, 12, 6, 4
    jfr, tfr = jf.make_empty_frame(h, w, enc_dim, patch), tf.make_empty_frame(h, w, enc_dim, patch)
    for name in ("T_WC", "X_canon", "C", "N", "N_updates", "feat", "pos", "score", "img"):
        a, b = getattr(tfr, name), np.asarray(getattr(jfr, name))
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        np.testing.assert_array_equal(a.numpy().reshape(b.shape), b, err_msg=name)
    assert tfr.frame_id == int(jfr.frame_id) == 0
    np.testing.assert_array_equal(tfr.get_average_conf().numpy(),
                                  np.asarray(jfr.get_average_conf()))
    X, C = _obs(7, h * w)
    for n in (0, 3):
        jfr = dataclasses.replace(jfr, X_canon=jnp.asarray(X), C=jnp.asarray(C),
                                  N=jnp.asarray(n, jnp.int32))
        tfr = dataclasses.replace(tfr, X_canon=torch.from_numpy(X), C=torch.from_numpy(C),
                                  N=torch.tensor(n, dtype=torch.int32))
        np.testing.assert_array_equal(tfr.get_average_conf().numpy(),
                                      np.asarray(jfr.get_average_conf()))
