"""Factor graph: fixed-capacity edge store + the global solve.

Port of the JAX package's `slam/factor_graph.py`. Both directions of every
accepted edge are stored; edge e relates keyframes (ii[e], jj[e]), and
`idx[e][k]` maps pixel k of keyframe jj[e] to a pixel of keyframe ii[e].
Edge tensors grow by doubling; a solve pads the pose and edge counts to
powers of two (and, over a device mesh, up to a multiple of its dp size),
with the padding masked out of the normal equations. The calibrated solve
first snaps every keyframe point onto its pixel ray.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from monst3r_slam_torch.core import geometry
from monst3r_slam_torch.slam import backend as backend_mod
from monst3r_slam_torch.slam.frame import KeyframeMemory, kf_update_poses


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class FactorGraph:
    def __init__(self, hw: int, edge_capacity: int = 16, device=None):
        self.hw = hw
        self.device = device
        self.capacity = edge_capacity
        self.n_edges = 0
        self.ii = np.zeros(edge_capacity, np.int64)
        self.jj = np.zeros(edge_capacity, np.int64)
        self.idx = torch.zeros((edge_capacity, hw), dtype=torch.int64, device=device)
        self.valid_match = torch.zeros((edge_capacity, hw), dtype=torch.bool, device=device)
        self.Q = torch.zeros((edge_capacity, hw), dtype=torch.float32, device=device)
        self.n_solves = 0  # global GN runs, and the iterations of the last one
        self.last_iters = 0

    def _grow(self, needed: int):
        if self.n_edges + needed <= self.capacity:
            return
        new_cap = _next_pow2(self.n_edges + needed, self.capacity * 2)
        pad = new_cap - self.capacity
        self.ii = np.concatenate([self.ii, np.zeros(pad, np.int64)])
        self.jj = np.concatenate([self.jj, np.zeros(pad, np.int64)])
        self.idx = torch.cat([self.idx, self.idx.new_zeros((pad, self.hw))])
        self.valid_match = torch.cat([self.valid_match, self.valid_match.new_zeros((pad, self.hw))])
        self.Q = torch.cat([self.Q, self.Q.new_zeros((pad, self.hw))])
        self.capacity = new_cap

    def add_edge_pair(self, i: int, j: int, idx_i2j, valid_j, Qj, idx_j2i, valid_i, Qi):
        """Store both directions of an accepted (i, j) edge."""
        self._grow(2)
        e = self.n_edges
        self.ii[e], self.jj[e] = i, j
        self.ii[e + 1], self.jj[e + 1] = j, i
        self.idx[e], self.idx[e + 1] = idx_i2j, idx_j2i
        self.valid_match[e], self.valid_match[e + 1] = valid_j, valid_i
        self.Q[e], self.Q[e + 1] = Qj, Qi
        self.n_edges += 2

    def edge_list(self) -> List[tuple]:
        return [(int(self.ii[e]), int(self.jj[e])) for e in range(0, self.n_edges, 2)]

    def solve(self, mem: KeyframeMemory, cfg: backend_mod.BackendConfig, use_calib: bool = False,
              K=None, img_size=None, host_solve: bool = False, mesh=None) -> None:
        """Run the global GN on the live keyframe memory and write the poses
        back into `mem` in place. `host_solve` solves each step in float64 on
        the host (config `local_opt.solver: host`); otherwise `mesh` splits
        the edges over its dp axis (config `parallel.mesh`)."""
        n_kf = mem.count
        if self.n_edges == 0 or n_kf <= cfg.pin:
            return
        P = min(_next_pow2(n_kf, cfg.pose_pad_lo), mem.capacity)
        Cs = mem.C[:P] / torch.clamp(mem.N[:P, None, None].float(), min=1.0)
        Twc_new = self.solve_poses(mem.T_WC[:P], mem.X_canon[:P], Cs, n_kf, cfg,
                                   use_calib=use_calib, K=K, img_size=img_size,
                                   host_solve=host_solve, mesh=mesh)
        kf_update_poses(mem, Twc_new, torch.arange(P, device=mem.T_WC.device))

    def solve_poses(self, Twc, Xs, Cs, n_kf: int, cfg: backend_mod.BackendConfig,
                    use_calib: bool = False, K=None, img_size=None, host_solve: bool = False,
                    mesh=None):
        """Global GN on explicit (P, ...) snapshots of the keyframe state
        (P >= n_kf, a power of two): the updated (P, 8) poses, or None when
        there is nothing to solve. The async backend solves its snapshot
        copies with this, never the live memory. With a `mesh` and no host
        solve, the padded edge count is rounded up to a multiple of the dp
        size and the edges split over dp (`gauss_newton_sharded`)."""
        if self.n_edges == 0 or n_kf <= cfg.pin:
            return None
        P = Twc.shape[0]
        E = _next_pow2(self.n_edges, cfg.edge_pad_lo)
        dev = Twc.device
        if use_calib:
            Xs = geometry.constrain_points_to_ray(img_size, Xs, K)
        if host_solve:
            solve = backend_mod.gauss_newton_host_solve
        elif mesh is not None:
            dp = mesh.shape["dp"]
            E = -(-E // dp) * dp
            solve = functools.partial(backend_mod.gauss_newton_sharded, mesh)
        else:
            solve = backend_mod.gauss_newton
        Twc_new, self.last_iters = solve(
            Twc, Xs, Cs,
            torch.from_numpy(np.resize(self.ii[: self.n_edges], E)).to(dev),
            torch.from_numpy(np.resize(self.jj[: self.n_edges], E)).to(dev),
            self._padded(self.idx, E), self._padded(self.valid_match, E),
            self._padded(self.Q, E),
            torch.arange(E, device=dev) < self.n_edges,
            cfg, n_poses=P, use_calib=use_calib, K=K, img_size=img_size,
        )
        self.n_solves += 1
        return Twc_new

    @staticmethod
    def _padded(arr, E):
        cur = arr.shape[0]
        if cur >= E:
            return arr[:E]
        return torch.cat([arr] * -(-E // cur))[:E]
