"""The port's geometry oracle (`monst3r_slam_torch/utils/oracle.py`) against
the JAX package's (`monst3r_slam_tpu/utils/oracle.py`), and the oracle
recipe of bench.py's `OracleBenchSLAM` driving both packages' SLAMSystem.

* Each function on the same poses and RFF arrays, f32 on both sides:
  within 1e-5 for the Newton solve's points (25 steps, different f32
  evaluation order of the same formulas; the points sit at depth ~3) and
  1e-5 for everything computed from them; the trajectory within 1e-6.
* The cross-view consistency check of tests/test_ate_regression.py:215-230
  on the port's oracle alone.
* The oracle SLAM twin: the real TINY encode and decode run on both sides
  (f32), then each side's decode outputs are replaced by its own
  package's `render_pair` (the port's side is chip_smoke.py's
  `oracle_slam_class`, the class its `oracle` phase drives on the card) of the frames' ground-truth poses, with C = Q =
  2.0; 12 frames at 64x80 on the bench's trajectory (0.12 a frame)
  through config/base.yaml (synchronous, retrieval on a shared random
  codebook) with the keyframe gate raised to 0.9, no keyframe forced, with
  decisions resolved at once (`defer_tracking_sync: 0`: keyframes every
  2 frames) and two frames late (2, the worker's default: each keyframe
  repeated on the next frame, tracked before the first took effect). Same
  modes, keyframes and graph edges; poses within 1e-3, the tiled oracle
  twins' tolerance (tests/test_torch_slam.py; measured 3.1e-4).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import oracle_slam_class
from monst3r_slam_tpu.app import pipeline as jpipe
from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.slam import retrieval as jretrieval
from monst3r_slam_tpu.utils import oracle as joracle
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.app.evaluate import ate_rmse
from monst3r_slam_torch.core import lie as tlie
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.slam import retrieval as tretrieval
from monst3r_slam_torch.utils import oracle as toracle
from tests.test_torch_slam import close_backend_workers, one_torch_thread  # noqa: F401

H, W = 64, 80
FX = FY = 0.6 * W
DESC_F = 24


def _rff(desc_dim=DESC_F, scale=1.5, seed=42):
    rng = np.random.default_rng(seed)
    return {"W": (scale * rng.standard_normal((3, desc_dim))).astype(np.float32),
            "b": rng.uniform(0, 2 * np.pi, desc_dim).astype(np.float32)}


def _poses(n=4, step=0.12):
    return np.stack(toracle.gt_trajectory(n, step=step))


def test_gt_trajectory_matches_jax():
    for step in (0.06, 0.12):
        np.testing.assert_allclose(np.stack(toracle.gt_trajectory(9, step=step)),
                                   np.stack(joracle.gt_trajectory(9, step=step)), atol=1e-6)
    assert all(p.dtype == np.float32 and p.shape == (8,) for p in toracle.gt_trajectory(3))


def test_surface_rays_and_newton_step_match_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-3, 3, 200).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(toracle.surface_z(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(joracle.surface_z(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-6)
    r_t, r_j = toracle.pixel_rays(H, W, FX, FY), joracle.pixel_rays(H, W, FX, FY)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    t = np.asarray([0.1, -0.2, 0.05], np.float32)
    tau = rng.uniform(2.5, 3.5, 50).astype(np.float32)
    m = rng.standard_normal((50, 3)).astype(np.float32)
    got = toracle._surface_g_and_dg(*(torch.from_numpy(a) for a in (t, tau, m)))
    ref = joracle._surface_g_and_dg(*(jnp.asarray(a) for a in (t, tau, m)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_render_frame_and_image_match_jax():
    for T in _poses():
        Xc_t, Xw_t = toracle.render_frame(torch.from_numpy(T), H, W, FX, FY)
        Xc_j, Xw_j = joracle.render_frame(jnp.asarray(T), H, W, FX, FY)
        np.testing.assert_allclose(Xc_t.numpy(), np.asarray(Xc_j), atol=1e-5)
        np.testing.assert_allclose(Xw_t.numpy(), np.asarray(Xw_j), atol=1e-5)
        img_t = toracle.render_image(torch.from_numpy(T), H, W, FX, FY)
        img_j = joracle.render_image(jnp.asarray(T), H, W, FX, FY)
        assert img_t.shape == img_j.shape == (1, H, W, 3)
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5)
    # a batch of poses renders as each pose alone
    P = torch.from_numpy(_poses())
    Xc_b, _ = toracle.render_frame(P, H, W, FX, FY)
    np.testing.assert_array_equal(Xc_b[2].numpy(), toracle.render_frame(P[2], H, W, FX, FY)[0])
    assert toracle.render_image(P, H, W, FX, FY).shape == (4, H, W, 3)


def test_world_desc_and_render_pair_match_jax():
    rff = _rff()
    t_rff = {k: torch.from_numpy(v) for k, v in rff.items()}
    j_rff = {k: jnp.asarray(v) for k, v in rff.items()}
    X = np.random.default_rng(1).standard_normal((300, 3)).astype(np.float32)
    np.testing.assert_allclose(toracle.world_desc(t_rff, torch.from_numpy(X)).numpy(),
                               np.asarray(joracle.world_desc(j_rff, jnp.asarray(X))), atol=1e-5)
    P = _poses(5)
    Ti, Tj = P[[0, 1, 3]], P[[1, 3, 4]]  # batched over pose pairs, as the bench vmaps it
    got = toracle.render_pair(torch.from_numpy(Ti), torch.from_numpy(Tj), t_rff, H, W, FX, FY)
    ref = jax.vmap(lambda a, b: joracle.render_pair(a, b, j_rff, H, W, FX, FY))(
        jnp.asarray(Ti), jnp.asarray(Tj))
    for g, r, c in zip(got, ref, (3, DESC_F, 3, DESC_F)):
        assert g.shape == r.shape == (3, H * W, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_make_rff_is_seeded():
    def draw(seed):
        return toracle.make_rff(DESC_F, scale=12.0, generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(42), draw(42), draw(43)
    assert a["W"].shape == (3, DESC_F) and a["b"].shape == (DESC_F,)
    assert a["W"].dtype == a["b"].dtype == torch.float32
    assert torch.equal(a["W"], b["W"]) and torch.equal(a["b"], b["b"])
    assert not torch.equal(a["W"], c["W"])
    assert 0.0 <= float(a["b"].min()) and float(a["b"].max()) < 2 * np.pi


def test_port_oracle_renders_consistent_geometry():
    """tests/test_ate_regression.py:215-230 on the port's oracle: world
    points lie on the surface, and frame j's points mapped back into its
    camera equal its direct ray intersection."""
    gt = toracle.gt_trajectory(3, step=0.12)
    _, Xi_w = toracle.render_frame(torch.from_numpy(gt[0]), H, W, FX, FY)
    Xj_cam, Xj_w = toracle.render_frame(torch.from_numpy(gt[2]), H, W, FX, FY)
    for Xw in (Xi_w, Xj_w):
        np.testing.assert_allclose(Xw[:, 2].numpy(), toracle.surface_z(Xw[:, 0], Xw[:, 1]).numpy(),
                                   atol=1e-4)
    X_back = tlie.sim3_act(tlie.sim3_inv(torch.from_numpy(gt[2])), Xj_w)
    np.testing.assert_allclose(X_back.numpy(), Xj_cam.numpy(), atol=1e-4)
    # and render_pair's view-j points are frame j's, moved into camera i
    rff = {k: torch.from_numpy(v) for k, v in _rff().items()}
    _, _, X2, D2 = toracle.render_pair(torch.from_numpy(gt[0]), torch.from_numpy(gt[2]), rff,
                                       H, W, FX, FY)
    X2_w = tlie.sim3_act(torch.from_numpy(gt[0]), X2)
    np.testing.assert_allclose(X2_w.numpy(), Xj_w.numpy(), atol=1e-4)
    np.testing.assert_allclose(D2.numpy(), toracle.world_desc(rff, Xj_w).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# The oracle SLAM twin
# ---------------------------------------------------------------------------


class JaxOracleSLAM(jpipe.SLAMSystem):
    """bench.py's OracleBenchSLAM recipe (frame ids pinned in make_frame,
    keyframe slots mapped to ids, the edge lists recorded per thread), in
    f32, with the real decode's outputs replaced by the oracle's and
    without the bench's 1e-6 tanh mix, which only kept XLA from dropping
    the decode inside one jitted program."""

    def __post_init__(self):
        super().__post_init__()
        self.gt, self._cur_fid, self.kf_fids = {}, None, []
        self._edge_tls = threading.local()
        self._rff = {k: jnp.asarray(v) for k, v in _rff().items()}

    def encode(self, img_nhwc):
        return jmodel.encode(self.params, self.model_cfg, img_nhwc, dtype=jnp.float32)

    def make_frame(self, frame_id, img_np):
        self._cur_fid = int(frame_id)
        return super().make_frame(frame_id, img_np)

    def _append_keyframe(self, frame):
        idx = super()._append_keyframe(frame)
        self.kf_fids[idx:idx + 1] = [int(np.asarray(frame.frame_id))]
        return idx

    def add_factors(self, kf_i_list, kf_j_list, min_match_frac, is_reloc=False,
                    track_cache=None):
        self._edge_tls.ctx = (list(kf_i_list), list(kf_j_list), not is_reloc
                              and track_cache is not None
                              and kf_i_list[-1] == kf_j_list[-1] - 1
                              and track_cache.get("kf_idx") == kf_i_list[-1])
        try:
            return super().add_factors(kf_i_list, kf_j_list, min_match_frac, is_reloc,
                                       track_cache=track_cache)
        finally:
            self._edge_tls.ctx = None

    def _decode_fids(self, feat_i, feat_j, B):
        """Frame ids of the decode's pair rows. The edge decode's layout is
        JAX's add_factors': every i -> j, then every j -> i but the last
        one's when the tracking decode is reused, padded with row 0 (the
        bench's own copy predates that reuse)."""
        ctx = getattr(self._edge_tls, "ctx", None)
        if ctx is not None:
            ii, jj, use_cache = ctx
            n_ji = len(ii) - 1 if use_cache else len(ii)
            a, b = ii + jj[:n_ji], jj + ii[:n_ji]
            a, b = a + [a[0]] * (B - len(a)), b + [b[0]] * (B - len(b))
            return [self.kf_fids[s] for s in a], [self.kf_fids[s] for s in b]
        if feat_j is feat_i:  # _mono_init: the frame against itself
            return [self._cur_fid], [self._cur_fid]
        return [self._cur_fid], [self.kf_fids[self.n_kf - 1]]

    def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
        out = jmodel.decode(self.params, self.model_cfg, feat_i, pos_i, feat_j, pos_j,
                            self.img_size, dtype=jnp.float32)
        fi, fj = self._decode_fids(feat_i, feat_j, feat_i.shape[0])
        X1, D1, X2, D2 = jax.vmap(lambda a, b: joracle.render_pair(
            a, b, self._rff, H, W, FX, FY))(jnp.asarray(np.stack([self.gt[f] for f in fi])),
                                            jnp.asarray(np.stack([self.gt[f] for f in fj])))
        two = jnp.full(out.C1.shape, 2.0)
        return jmodel.PairOutput(X1=X1.reshape(out.X1.shape), C1=two, D1=D1.reshape(out.D1.shape),
                                 Q1=two, X2=X2.reshape(out.X2.shape), C2=two,
                                 D2=D2.reshape(out.D2.shape), Q2=two)


def _cfg(load, defer):
    c = load("config/base.yaml")
    c["single_thread"] = True
    c["defer_tracking_sync"] = defer
    c["parallel"] = {"mesh": "off"}
    c["matching"]["mode"] = "tiled"
    # the 64x80 view is as wide as the bench's 384x512 one, and at the
    # shipped 0.333 its 12 frames would make no keyframe: this gate makes
    # one every 2 frames (tests/test_ate_regression.py raises it so too)
    c["tracking"]["match_frac_thresh"] = 0.9
    return c


@pytest.mark.parametrize("defer", [0, 2])
def test_oracle_slam_matches_jax(defer):
    n = 12
    gt = toracle.gt_trajectory(n, step=0.12)
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    rparams = jretrieval.init_retrieval_params(jax.random.PRNGKey(2), JTINY.enc_dim, hdims=(32,))
    codebook = np.asarray(jretrieval.make_random_codebook(jax.random.PRNGKey(3), 128, 32))
    js = JaxOracleSLAM(params=jp, model_cfg=JTINY, cfg=_cfg(jload_config, defer), img_size=(H, W),
                       retrieval_params=rparams,
                       retrieval_db=jretrieval.ASMKDatabase(jnp.asarray(codebook)),
                       kf_capacity=16)
    ts = oracle_slam_class({k: torch.from_numpy(v) for k, v in _rff().items()}, FX)(
        params=params_from_jax(jax.tree.map(np.asarray, jp)), model_cfg=TTINY,
        cfg=_cfg(lambda p: tload_config(p, set_global=False), defer), img_size=(H, W),
        retrieval_params=tretrieval.retrieval_params_from_numpy(jax.tree.map(np.asarray, rparams)),
        retrieval_db=tretrieval.ASMKDatabase(codebook.copy()), kf_capacity=16,
        device="cpu", dtype=torch.float32)
    imgs = toracle.render_image(torch.from_numpy(np.stack(gt)), H, W, FX, FY).numpy()
    u8 = np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)
    j_modes, t_modes = [], []
    for i, T in enumerate(gt):
        img = u8[i].astype(np.float32) / 127.5 - 1.0
        for s, modes in ((js, j_modes), (ts, t_modes)):
            s.gt[i] = T
            s.process_frame(i, i / 30.0, img, uimg=u8[i])
            modes.append(int(s.mode))
    js.finalize()
    ts.finalize()
    assert t_modes == j_modes == [1] * n  # every frame tracked
    assert ts.kf_fids == js.kf_fids and len(ts.kf_fids) >= 3  # organic keyframes
    # at defer 2 a keyframe takes effect one frame late, so the next frame is
    # tracked against the old keyframe and made a keyframe too, in both
    # packages (chip_smoke.py's oracle run counts such repeats apart)
    repeats = [b for a, b in zip(ts.kf_fids, ts.kf_fids[1:]) if b - a == 1]
    assert bool(repeats) == (defer == 2), ts.kf_fids
    assert ts.graph.edge_list() == js.graph.edge_list() and ts.graph.n_edges >= 1
    t_poses, j_poses = np.stack(ts.frame_poses), np.stack(js.frame_poses)
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-3)
    t = np.arange(n, dtype=np.float64)
    gt_xyz = np.stack([T[:3] for T in gt]).astype(np.float64)
    rmse, m = ate_rmse(t, t_poses[:, :3].astype(np.float64), t, gt_xyz)
    extent = np.linalg.norm(gt_xyz[-1] - gt_xyz[0])
    assert m == n and rmse < 0.033 * extent, (rmse, extent)
