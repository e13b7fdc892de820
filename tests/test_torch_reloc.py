"""Retrieval, loop closure and relocalization of the port's SLAMSystem
against the JAX package's, on the adversarial oracle of
tests/test_ate_regression.py:240-373: noisy, outlier-ridden pointmaps of an
out-and-back trajectory, pose-dependent encoder features for ASMK, and a
frame of garbage geometry (frame 5) that loses tracking. Both packages run
12 frames with the same retrieval head weights (JAX's init carried over)
and the same bootstrap database settings, drawing the noise from one
seeded stream in the same order. They must make the same mode sequence,
relocalization attempts and successes, keyframes and graph edges, with at
least one loop-closure edge (|i - j| >= 2), and poses within 5e-3. The
matches are the same (tiled mode); the poses differ by f32 summation order,
which the noise and the 6% outliers at normal confidence amplify through
the Huber-weighted tracking's stop rule: measured ~7e-4 on most frames and
3.7e-3 at most (frame 10, after a loop-closure solve), against ~1e-4 on the
noise-free oracle of tests/test_torch_slam.py. The scene is that sensitive
in the JAX package alone: one more global GN iteration (11 in place of
`local_opt.max_iters` 10) moves its frame poses by up to 6.9e-3 and a
keyframe pose by 1.2e-2, with the same modes and edges.
"""

import jax
import numpy as np
import torch

from monst3r_slam_tpu.slam import retrieval as jretrieval
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.slam import retrieval as tretrieval
from tests.test_ate_regression import H, W, _loop_trajectory, _run_noisy
from tests.test_torch_slam import TorchOracleSLAM, one_torch_thread  # noqa: F401


class TorchNoisyOracleSLAM(TorchOracleSLAM):
    """The port's twin of tests/test_ate_regression.py::NoisyOracleSLAM:
    the same noise stream, consumed in the same order."""

    def __post_init__(self):
        super().__post_init__()
        self._noise = np.random.default_rng(7)
        self.break_frames = set()
        rng = np.random.default_rng(5)
        self._feat_W = rng.normal(size=(8, self.model_cfg.enc_dim)) * 2.0
        self._feat_B = rng.uniform(0, 2 * np.pi, self.model_cfg.enc_dim)

    def encode(self, img_nhwc):
        feat, pos = super().encode(img_nhwc)
        fid = self._pending_id
        T = self._oracle_frames[fid][2]
        z = np.concatenate([T[:3] * 3.0, T[3:7], T[7:8]])
        f = np.sin(z @ self._feat_W + self._feat_B).astype(np.float32)
        n = feat.shape[1]
        toks = np.tile(f, (n, 1))
        toks += 0.3 * np.sin(np.arange(n, dtype=np.float32)[:, None] * 0.7
                             + np.arange(self.model_cfg.enc_dim)[None] * 0.13)
        feat = torch.from_numpy(toks[None].astype(np.float32))
        feat[:, 0, 0] = float(fid)
        return feat, pos

    def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
        fi = int(feat_i[0, 0, 0])
        out = super()._decode_pair(feat_i, pos_i, feat_j, pos_j)
        rng = self._noise

        def corrupt_X(X):
            X = X.numpy()
            X = X * (1.0 + 0.01 * rng.standard_normal(X.shape[:-1]))[..., None]
            outl = rng.random(X.shape[:-1]) < 0.06
            scale = rng.uniform(0.5, 2.0, X.shape[:-1])
            X = np.where(outl[..., None], X * scale[..., None], X)
            return torch.from_numpy(X.astype(np.float32))

        def corrupt_D(D):
            D = D.numpy() + 0.05 * rng.standard_normal(tuple(D.shape))
            return torch.from_numpy((D / np.linalg.norm(D, axis=-1, keepdims=True)).astype(np.float32))

        def conf(shape):
            return torch.from_numpy(rng.uniform(1.0, 3.0, tuple(shape)).astype(np.float32))

        X1 = corrupt_X(out.X1)
        if fi in self.break_frames:  # garbage geometry: tracking must fail
            X1 = torch.from_numpy(rng.uniform(-5, 5, tuple(out.X1.shape)).astype(np.float32))
        return tmodel.PairOutput(
            X1=X1, C1=conf(out.C1.shape), D1=corrupt_D(out.D1), Q1=conf(out.Q1.shape),
            X2=corrupt_X(out.X2), C2=conf(out.C2.shape), D2=corrupt_D(out.D2),
            Q2=conf(out.Q2.shape),
        )


def _run_noisy_torch(n_frames, break_frames):
    """The port's twin of tests/test_ate_regression.py::_run_noisy."""
    cfg = tload_config("config/base.yaml", set_global=False)
    cfg["tracking"].update(Q_conf=1.2, C_conf=1.2, match_frac_thresh=0.925)
    cfg["local_opt"].update(Q_conf=1.2, solver="device")
    cfg.update(single_thread=True, parallel={"mesh": "off"}, defer_tracking_sync=False,
               retrieval={"k": 3, "min_thresh": 1e-4})
    cfg["matching"]["mode"] = "tiled"
    jparams = jretrieval.init_retrieval_params(jax.random.PRNGKey(1), TTINY.enc_dim, hdims=(32,))
    slam = TorchNoisyOracleSLAM(
        params={}, model_cfg=TTINY, cfg=cfg, img_size=(H, W), kf_capacity=32, device="cpu",
        retrieval_params=tretrieval.retrieval_params_from_numpy(jax.tree.map(np.asarray, jparams)),
        retrieval_db=tretrieval.ASMKDatabase(None, n_words=64),
    )
    slam.break_frames = set(break_frames)
    modes = []
    for i, T in enumerate(_loop_trajectory(n_frames)):
        slam.register_frame(T)
        slam.process_frame(i, float(i) / 30.0, np.zeros((H, W, 3), np.float32))
        modes.append(int(slam.mode))
    slam.finalize()
    return slam, modes


def test_noisy_oracle_relocalization_matches_jax():
    n = 12
    _, js, j_modes = _run_noisy(n, with_backend=True, break_frames={5})
    ts, t_modes = _run_noisy_torch(n, break_frames={5})
    assert t_modes == [int(m) for m in j_modes]
    assert 2 in t_modes  # the break lost tracking (mode 2: RELOC)
    assert t_modes[-1] == 1  # and tracking resumed
    assert (ts.n_reloc_attempts, ts.n_relocs) == (js.n_reloc_attempts, js.n_relocs)
    assert ts.n_relocs >= 1
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    edges = ts.graph.edge_list()
    assert edges == js.graph.edge_list()
    assert any(abs(i - j) >= 2 for i, j in edges), f"no loop-closure edge: {edges}"
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=5e-3)
