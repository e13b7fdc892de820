"""End-to-end SLAM pipeline: one process, device-resident state.

Port of the JAX package's `app/pipeline.py` for the MASt3R path of
`main.py`. Per frame: encode -> pair decode with the tracking keyframe ->
tiled match (kernel B on CUDA) -> pointmap fusion + GN tracking + keyframe
update (`_match_track_and_update`) -> host decisions, up to
`defer_tracking_sync` frames late. On a keyframe event: retrieval (ASMK on
the host), decode and match of the new graph edges (consecutive and
retrieved), and the global GN; on a lost frame, relocalization against the
retrieved keyframe.

`single_thread: True` runs the keyframe event's backend step on the main
thread. `single_thread: False` (the default of config/base.yaml) hands it to
a backend worker thread: the solve inputs are copied on the main thread
when the job is queued (the tracking step writes keyframe rows in place),
the worker solves the copies, superseded solves are skipped, and the main
thread folds the newest poses in between frames. Both threads enqueue their
work on the device's default stream, so stream order serializes the
worker's decodes and solves with tracking. `local_opt.solver: auto` solves
each GN step in float64 on the host (`native/solver.cpp`) when the backend
runs on the worker, and in f32 on the device otherwise.

With `dual` (the dynamic pipeline of `main_monster_slam.py`) frames cache
MonST3R encoder features and every pair decode runs the MonST3R decoder (X,
C) and the MASt3R decoder (D, Q) on them. With `use_dynamic_mask`, K and
both images, a tracked frame's decode is split: the MonST3R half first, the
flow-error program next (dynamic/mask.py), and the MASt3R half enqueued by
that program before its map is read back, so that the decode runs on the
card while the host thresholds and refines the mask; C, D and Q are then
zeroed on the frame's masked pixels and on its keyframe's stored mask.

With `easi3r` (the pipeline of `main_easier_slam.py`) frames cache Easi3R
(DUSt3R-architecture) encoder features, and every pair decode is the
two-pass attention-reweighted inference for X and C plus the MASt3R decoder
for D and Q, with the attention masks zeroing C and Q (dynamic/easi3r.py);
no flow mask, no reuse of the tracking decode for a graph edge.

With a `viewer` (viz/live.py), control messages are applied between frames
(pause, single step, relocalization, the display threshold, terminate), and
after a frame at most once a second the keyframe memory is read on the main
thread into a surfel snapshot (`_surfel_snapshot` per keyframe on the
device, then to the host) with the trajectory, the frustums and the current
frame with its dynamic mask.

With `matching.mode: lm` the tracked frame is matched by the
iterative-projection matcher (ops/matching.py), then fused, tracked and
folded into the keyframe by `_track_and_update`; graph edges and
relocalization use the same matcher. `save_state` / `load_state` write and
read the SLAM state as an `.npz` with the JAX package's keys, dtypes and
shapes. `process_chunk` tracks a batch of frames with one host read per
event-free chunk (app/chunked.py).

`parallel.mesh: auto` (config/base.yaml) builds a device mesh over every
visible card when there is more than one (parallel/mesh.py); `off`, or one
card, or the CPU builds none. With a mesh the factor-graph edge decode of
the plain MASt3R pipeline splits its pair batch over the mesh's dp axis
(`sharded_edge_decode`), the global Gauss-Newton splits its edges over dp
(`gauss_newton_sharded`), and `solver: auto` takes the device solve. The
`mesh` field passes a mesh of the caller's own (a grid that repeats one
card, say) in place of the configuration's.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import queue
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from monst3r_slam_torch.core import lie
from monst3r_slam_torch.dynamic import mask as dyn
from monst3r_slam_torch.dynamic.inference import (
    DualParams, EasiParams, combine, easi3r_asymmetric_inference, monst3r_asymmetric_inference,
)
from monst3r_slam_torch.models import mast3r as model_api
from monst3r_slam_torch.models.config import ModelConfig
from monst3r_slam_torch.native.build import solver_available
from monst3r_slam_torch.ops import matching, matching_tiled
from monst3r_slam_torch.parallel.inference import place_replicated, sharded_edge_decode
from monst3r_slam_torch.parallel.mesh import canonical_device, make_mesh
from monst3r_slam_torch.slam import retrieval as retrieval_mod
from monst3r_slam_torch.slam import tracker as tracker_mod
from monst3r_slam_torch.slam.backend import BackendConfig
from monst3r_slam_torch.slam.factor_graph import FactorGraph, _next_pow2
from monst3r_slam_torch.slam.frame import (
    Frame, Mode, fuse_pointmap, kf_append, kf_update_poses, make_keyframe_memory,
)
from monst3r_slam_torch.utils import timing


def tracking_config_from_dict(cfg: dict) -> tracker_mod.TrackingConfig:
    t = cfg.get("tracking", {})
    return tracker_mod.TrackingConfig(
        min_match_frac=t.get("min_match_frac", 0.05),
        max_iters=int(t.get("max_iters", 50)),
        C_conf=t.get("C_conf", 0.0),
        Q_conf=t.get("Q_conf", 1.5),
        rel_error=t.get("rel_error", 1e-3),
        delta_norm=t.get("delta_norm", 1e-3),
        huber=t.get("huber", 1.345),
        match_frac_thresh=t.get("match_frac_thresh", 0.333),
        sigma_ray=t.get("sigma_ray", 0.003),
        sigma_dist=t.get("sigma_dist", 10.0),
        sigma_pixel=t.get("sigma_pixel", 1.0),
        sigma_depth=t.get("sigma_depth", 10.0),
        pixel_border=t.get("pixel_border", -10.0),
        depth_eps=t.get("depth_eps", 1e-6),
        filtering_mode=t.get("filtering_mode", "weighted_pointmap"),
        filtering_score=t.get("filtering_score", "median"),
    )


def _pow2_floor(name: str, v: int) -> int:
    """Round a pad-bucket floor up to a power of two."""
    v = int(v)
    if v < 1:
        raise ValueError(f"{name} must be >= 1, got {v}")
    return 1 << (v - 1).bit_length()


def backend_config_from_dict(cfg: dict) -> BackendConfig:
    b = cfg.get("local_opt", {})
    return BackendConfig(
        pin=int(b.get("pin", 1)),
        C_conf=b.get("C_conf", 0.0),
        Q_conf=b.get("Q_conf", 1.5),
        max_iters=int(b.get("max_iters", 10)),
        sigma_ray=b.get("sigma_ray", 0.003),
        sigma_dist=b.get("sigma_dist", 10.0),
        sigma_pixel=b.get("sigma_pixel", 1.0),
        sigma_depth=b.get("sigma_depth", 10.0),
        delta_norm=b.get("delta_norm", 1e-8),
        pixel_border=b.get("pixel_border", -10.0),
        depth_eps=b.get("depth_eps", 1e-6),
        pixel_subsample=int(b.get("pixel_subsample", 1)),
        pose_pad_lo=_pow2_floor("pose_pad_lo", b.get("pose_pad_lo", 8)),
        edge_pad_lo=_pow2_floor("edge_pad_lo", b.get("edge_pad_lo", 8)),
    )


def matching_config_from_dict(cfg: dict) -> matching.MatchingConfig:
    m = cfg.get("matching", {})
    return matching.MatchingConfig(
        max_iter=int(m.get("max_iter", 10)),
        lambda_init=m.get("lambda_init", 1e-8),
        convergence_thresh=m.get("convergence_thresh", 1e-6),
        dist_thresh=m.get("dist_thresh", 0.1),
        radius=int(m.get("radius", 3)),
        dilation_max=int(m.get("dilation_max", 5)),
    )


def matcher_mode(cfg: dict, device) -> str:
    """'kernel' (the tile-matcher kernel's semantics; default on CUDA),
    'tiled' (the plain tiled path; default on CPU) or 'lm' (the
    iterative-projection matcher). The reference's 'pallas' names the same
    semantics as 'kernel'."""
    default = "kernel" if torch.device(device).type == "cuda" else "tiled"
    mode = cfg.get("matching", {}).get("mode", default)
    mode = "kernel" if mode == "pallas" else mode
    if mode not in ("kernel", "tiled", "lm"):
        raise ValueError(f"unknown matching mode {mode!r} (kernel, pallas, tiled or lm)")
    return mode


def make_matcher(cfg: dict, device):
    """Batched matcher for graph edges and relocalization (the tracking
    step of the tiled modes fuses its own)."""
    mcfg = matching_config_from_dict(cfg)
    mode = matcher_mode(cfg, device)
    if mode == "lm":
        def lm_match_fn(X11, X21, D11, D21, idx_init=None):
            return matching.match(X11, X21, D11, D21, idx_init, cfg=mcfg)

        return lm_match_fn
    use_kernel = mode == "kernel"
    tcfg = matching_tiled.TiledConfig()

    def match_fn(X11, X21, D11, D21, idx_init=None):
        return matching_tiled.match(X11, X21, D11, D21, idx_init, cfg=mcfg, tcfg=tcfg,
                                    use_kernel=use_kernel)

    return match_fn


def _track_update_body(
    mem_X, mem_C, mem_N, mem_S, kf_idx: int,
    idx_f2k, valid_match_k,
    X1, C1, Q1, X2, C2, Q2,
    frame_X, frame_C, frame_N, frame_S,
    T_WCf, T_WCk,
    track_cfg, img_size, fmode, fscore,
    K=None, use_calib: bool = False, frozen=None,
):
    """Frame fusion -> GN tracking -> keyframe fusion. The keyframe row of
    mem_X/C/N/S is updated IN PLACE after every read of its old value.
    `frozen` (a () bool tensor, chunked tracking) keeps the row as it was
    and runs the GN loop for its fixed `max_iters` steps with no host read.
    Returns (fX, fC, fN, fS, res, summary); summary is the 11-float decision
    vector [T_WCf(0:8), low_match, solver_failed, new_kf]."""
    fX, fC, fN, fS = fuse_pointmap(frame_X, frame_C, frame_N, X1, C1, fmode, frame_S, fscore)
    kX_old, kC_old, kN_old = mem_X[kf_idx], mem_C[kf_idx], mem_N[kf_idx]
    res = tracker_mod.track_pose(
        track_cfg, img_size, use_calib,
        idx_f2k, valid_match_k, Q1, Q2,
        fX, fC / torch.clamp(fN.float(), min=1.0),
        kX_old, kC_old / torch.clamp(kN_old.float(), min=1.0),
        T_WCf, T_WCk, K, fixed_iters=frozen is not None,
    )
    Xkk = lie.sim3_act(res.T_CkCf, X2)
    kX, kC, kN, kS = fuse_pointmap(kX_old, kC_old, kN_old, Xkk, C2, fmode, mem_S[kf_idx], fscore)
    ok = ~(res.low_match | res.solver_failed)
    if frozen is not None:
        ok = ok & ~frozen
    # in place: every read of the keyframe's old row is done above
    mem_X[kf_idx] = torch.where(ok, kX, kX_old)
    mem_C[kf_idx] = torch.where(ok, kC, kC_old)
    mem_N[kf_idx] = torch.where(ok, kN, kN_old)
    mem_S[kf_idx] = torch.where(ok, kS, mem_S[kf_idx])
    flags = torch.stack([res.low_match, res.solver_failed, res.new_kf]).float()
    summary = torch.cat([res.T_WCf, flags])
    return fX, fC, fN, fS, res, summary


def _match_track_and_update(
    mem_X, mem_C, mem_N, mem_S, kf_idx: int,
    X1, C1, Q1, D1, X2, C2, Q2, D2,
    idx_init,
    frame_X, frame_C, frame_N, frame_S,
    T_WCf, T_WCk,
    track_cfg: tracker_mod.TrackingConfig,
    img_size,
    fmode: str,
    fscore: str,
    mcfg: matching.MatchingConfig,
    tcfg,
    use_kernel: bool,
    use_init: bool,
    K=None,
    use_calib: bool = False,
):
    """Matching + fusion + GN tracking + keyframe update for one frame;
    `use_calib` tracks on the reprojection residual with the intrinsics K.
    Returns _track_update_body's outputs + (idx_f2k (1, hw), valid (1, hw, 1))."""
    h, w = img_size
    hw = h * w
    idx_f2k, valid_match_k = matching_tiled.match_tiled(
        X1.reshape(1, h, w, 3), X2.reshape(1, h, w, 3),
        D1.reshape(1, h, w, -1), D2.reshape(1, h, w, -1),
        idx_init.reshape(1, hw) if use_init else None,
        cfg=mcfg, tcfg=tcfg, use_init=use_init, use_kernel=use_kernel,
    )
    outs = _track_update_body(
        mem_X, mem_C, mem_N, mem_S, kf_idx, idx_f2k[0], valid_match_k[0],
        X1.reshape(hw, 3), C1.reshape(hw, 1), Q1.reshape(hw, 1),
        X2.reshape(hw, 3), C2.reshape(hw, 1), Q2.reshape(hw, 1),
        frame_X, frame_C, frame_N, frame_S,
        T_WCf, T_WCk, track_cfg, img_size, fmode, fscore, K=K, use_calib=use_calib,
    )
    return outs + (idx_f2k, valid_match_k)


def _track_and_update(
    mem_X, mem_C, mem_N, mem_S, kf_idx: int,
    idx_f2k, valid_match_k,
    X1, C1, Q1, X2, C2, Q2,
    frame_X, frame_C, frame_N, frame_S,
    T_WCf, T_WCk,
    track_cfg: tracker_mod.TrackingConfig,
    img_size,
    fmode: str,
    fscore: str,
    K=None,
    use_calib: bool = False,
):
    """Fusion + GN tracking + keyframe update for one frame matched by a
    standalone matcher (the LM path): the decode outputs and the match in
    any layout, flattened here. Returns _track_update_body's outputs."""
    hw = img_size[0] * img_size[1]
    return _track_update_body(
        mem_X, mem_C, mem_N, mem_S, kf_idx,
        idx_f2k.reshape(hw), valid_match_k.reshape(hw, 1),
        X1.reshape(hw, 3), C1.reshape(hw, 1), Q1.reshape(hw, 1),
        X2.reshape(hw, 3), C2.reshape(hw, 1), Q2.reshape(hw, 1),
        frame_X, frame_C, frame_N, frame_S,
        T_WCf, T_WCk, track_cfg, img_size, fmode, fscore, K=K, use_calib=use_calib,
    )


@torch.no_grad()
def _surfel_snapshot(X_flat, C, N, T_WC, h: int, w: int, stride: int):
    """One keyframe's surfels for the live viewer: world points, grid
    normals (the cross product of the pixel grid's tangents, rotated to the
    world), footprint radii (the mean neighbour distance times `stride`) and
    the mean confidence, on the `stride` grid in grid order (row-major over
    `viewer_grid_dims`), on the memory's device."""
    X = X_flat.reshape(h, w, 3)
    # forward differences, the last row and column extrapolated
    dXu = torch.diff(X, dim=1, append=X[:, -1:] + (X[:, -1:] - X[:, -2:-1]))
    dXv = torch.diff(X, dim=0, append=X[-1:] + (X[-1:] - X[-2:-1]))
    n_cam = torch.linalg.cross(dXu, dXv, dim=-1)
    n_cam = n_cam / torch.clamp(torch.linalg.vector_norm(n_cam, dim=-1, keepdim=True),
                                min=1e-12)
    r = 0.5 * (torch.linalg.vector_norm(dXu, dim=-1)
               + torch.linalg.vector_norm(dXv, dim=-1)) * float(stride)
    s = T_WC[7]
    R_pure = lie.sim3_matrix(T_WC)[:3, :3] / s  # normals rotate without the scale

    def grid2d(a):  # (h, w, ...) -> (gh * gw, ...)
        g = a[::stride, ::stride]
        return g.reshape((-1,) + tuple(g.shape[2:]))

    Xw = lie.sim3_act(T_WC, grid2d(X))
    Nw = grid2d(n_cam) @ R_pure.T
    rad = grid2d(r) * s
    conf = grid2d(C.reshape(h, w)) / torch.clamp(N.float(), min=1.0)
    return Xw, Nw, rad, conf


def viewer_grid_dims(h: int, w: int, stride: int):
    """(gh, gw) of `_surfel_snapshot`'s strided grid."""
    return len(range(0, h, stride)), len(range(0, w, stride))


@dataclasses.dataclass
class SLAMSystem:
    """Holds model params + SLAM state and drives per-frame processing.
    Tensors live on `device` ("cuda" unless the caller asks for the CPU);
    `params`, `K` and `retrieval_params` must already be there. `K` is the
    (3, 3) intrinsics of the resized frame, required with `use_calib`."""

    params: dict
    model_cfg: ModelConfig
    cfg: dict
    img_size: tuple  # (h, w) of resized frames
    K: Optional[torch.Tensor] = None
    retrieval_params: Optional[dict] = None
    retrieval_db: Optional[retrieval_mod.ASMKDatabase] = None
    kf_capacity: int = 512
    device: str = "cuda"
    dtype: torch.dtype = torch.bfloat16  # model compute type
    # The dynamic pipeline's MonST3R + MASt3R models, or the Easi3R
    # pipeline's DUSt3R-architecture + MASt3R models (None: the plain MASt3R
    # pipeline of `params`).
    dual: Optional[DualParams] = None
    easi3r: Optional[EasiParams] = None
    # The live viewer (viz/live.py LiveViewer); None: headless.
    viewer: Optional[object] = None
    # A device mesh (parallel/mesh.py Mesh) whose home device is `device`;
    # None: built from the config's `parallel.mesh`.
    mesh: Optional[object] = None

    def __post_init__(self):
        cfg = self.cfg
        if self.dual is not None and self.easi3r is not None:
            raise ValueError("SLAMSystem takes the MonST3R (dual) or the Easi3R models, not both")
        h, w = self.img_size
        self.hw = h * w
        self.kf_capacity = int(cfg.get("kf_capacity", self.kf_capacity))
        self.use_calib = bool(cfg.get("use_calib", False))
        if self.use_calib and self.K is None:
            raise ValueError("use_calib needs the frame intrinsics K (a dataset with a "
                             "calibration, or --calib)")
        self.track_cfg = tracking_config_from_dict(cfg)
        self.backend_cfg = backend_config_from_dict(cfg)
        self.edge_bucket_lo = _pow2_floor("edge_bucket_lo", cfg.get("edge_bucket_lo", 1))
        self.match_cfg = matching_config_from_dict(cfg)
        self.match_fn = make_matcher(cfg, self.device)
        self.match_mode = matcher_mode(cfg, self.device)
        self.match_tcfg = None if self.match_mode == "lm" else matching_tiled.TiledConfig()
        enc_cfg = (self.easi3r.easi3r_cfg if self.easi3r is not None
                   else self.dual.monst3r_cfg if self.dual is not None else self.model_cfg)
        self.mem = make_keyframe_memory(
            self.kf_capacity, h, w, enc_cfg.enc_dim, enc_cfg.patch_size, device=self.device,
        )
        self.graph = FactorGraph(self.hw, device=self.device)
        self.mode = Mode.INIT
        self.idx_f2k: Optional[torch.Tensor] = None  # matcher warm start
        self.frame_poses: List[np.ndarray] = []
        self.frame_ids: List[int] = []
        self.last_T_WC = lie.sim3_identity().numpy()
        self.retr_cfg = cfg.get("retrieval", {"k": 3, "min_thresh": 5e-3})
        self.reloc_cfg = cfg.get("reloc", {"min_match_frac": 0.3, "strict": True})
        self.filtering_mode = self.track_cfg.filtering_mode
        self.timestamps: List = []
        self.use_dynamic_mask = bool(cfg.get("use_dynamic_mask", False))
        self.dyn_threshold = float(cfg.get("dynamic_mask_threshold", 0.35))
        self.dyn_refine = bool(cfg.get("refine_dynamic_mask_with_sam2", False))
        # The reference refines with a SAM2 video predictor that carries
        # masks across frames; the native refiner flow-warps the previous
        # refined mask forward (dynamic/refine.py).
        self._mask_propagator = None
        if self.dyn_refine and bool(cfg.get("temporal_mask_propagation", True)):
            from monst3r_slam_torch.dynamic.refine import TemporalMaskPropagator

            self._mask_propagator = TemporalMaskPropagator()
        self._last_dyn_mask: Optional[np.ndarray] = None
        self._last_viz_push = 0.0
        # the viewer's control channel (the reference's WindowMsg)
        self.terminate_requested = False
        self.viz_C_conf = float(cfg.get("C_conf", 1.5))  # the display filter
        self.kf_uimgs: List[Optional[np.ndarray]] = []  # host uint8 keyframe images
        self.kf_dyn_masks: List[Optional[np.ndarray]] = []  # their dynamic masks
        self.cur_uimg: Optional[np.ndarray] = None
        self.single_thread = bool(cfg.get("single_thread", True))
        self.n_kf = 0  # host copy of mem.count
        self._kf_cache = None  # (kf_idx, (feat, pos, T_WC))
        self._last_T_WC_dev = lie.sim3_identity(device=self.device)
        # Host decisions on a frame's tracking result run up to this many
        # frames late (0: at once). Depth 1 makes the same decisions one
        # call later; depth >= 2 lets a new keyframe take effect and RELOC
        # be seen up to d frames late. Async mode defaults to 2.
        self.defer_depth = int(cfg.get("defer_tracking_sync", 0 if self.single_thread else 2))
        self.defer_sync = self.defer_depth > 0
        if self.defer_depth >= 2:
            print(f"async tracking sync deferred {self.defer_depth} frames "
                  "(defer_tracking_sync; depth 1 = bit-exact decisions, one frame late)")
        self._pending = collections.deque()  # unresolved tracking results
        self.last_summary = None
        self.n_reloc_attempts = 0
        self.n_relocs = 0  # successful relocalizations
        self.n_async_solves = 0  # global solves the backend worker ran
        self.n_shed_solves = 0  # worker solves skipped because a newer job was queued
        # Per-stage host ms, keyed by stage name: the host ms of the
        # recorder's spans (utils/timing, `_stage`); the worker appends its
        # own ("retrieval", "backend_solve", ...). Empty while the recorder
        # is off.
        self.prof: dict = {}
        self.backend_stall_s = 0.0  # main-thread time spent on backend work: its spans' sum
        self._on_cuda = torch.device(self.device).type == "cuda"
        self._retr_lock = threading.Lock()  # the retrieval DB is shared with the worker
        self._graph_lock = threading.Lock()
        self._backend_jobs: queue.Queue = queue.Queue()
        self._backend_results: queue.Queue = queue.Queue()
        self._async_errors: List[BaseException] = []  # worker exceptions, raised on main
        self._err_lock = threading.Lock()
        # local_opt.solver: device (f32 Cholesky on the device), host (f64
        # on the host, the reference's precision), or auto: host when the
        # backend runs on the worker, where the host round trip per
        # iteration is off the tracking thread, device in synchronous mode.
        mode = str(cfg.get("local_opt", {}).get("solver", "auto"))
        if mode == "auto":
            self.host_solve = not self.single_thread and solver_available()
        else:
            self.host_solve = mode == "host"
        self._setup_mesh(cfg, mode)
        self._worker: Optional[threading.Thread] = None
        if not self.single_thread:
            self._worker = threading.Thread(target=self._backend_worker, name="slam-backend",
                                            daemon=True)
            self._worker.start()

    def _setup_mesh(self, cfg: dict, solver_mode: str):
        """The device mesh (config `parallel.mesh`: auto | off): with `auto`
        a mesh over every visible card when there is more than one, unless
        the caller passed one. A mesh flips `solver: auto` to the device
        solve, and with the plain decoder (no dual or Easi3R models, and
        `_decode_pair` not overridden) puts a replica of the weights on
        each dp device for the edge decode (`_mesh_params`)."""
        pkey = cfg.get("parallel", {}).get("mesh", "auto")
        pkey = "off" if pkey is False else str(pkey)  # YAML reads a bare `off` as false
        if pkey not in ("auto", "off"):
            raise ValueError(f"parallel.mesh must be auto or off, got {pkey!r}")
        if (self.mesh is None and pkey == "auto" and torch.device(self.device).type == "cuda"
                and torch.cuda.device_count() > 1):
            self.mesh = make_mesh()
        self._mesh_params = None
        if self.mesh is None:
            return
        if self.mesh.home != canonical_device(self.device):
            raise ValueError(f"the mesh's home device {self.mesh.home} is not the system's "
                             f"device {self.device}")
        if solver_mode == "auto":
            self.host_solve = False
        plain_decode = (type(self)._decode_pair is SLAMSystem._decode_pair
                        and self.dual is None and self.easi3r is None)
        if plain_decode:
            self._mesh_params = place_replicated(self.params, self.mesh)
        print(f"parallel: {self.mesh.size}-device mesh {self.mesh.shape} (edge decode over dp, "
              "sharded global GN; parallel.mesh: off to disable)")

    # ------------------------------------------------------------------
    # Model wrappers
    # ------------------------------------------------------------------

    def encode(self, img_nhwc: torch.Tensor):
        if self.easi3r is not None:  # the Easi3R pipeline caches Easi3R features
            return model_api.encode(self.easi3r.easi3r, self.easi3r.easi3r_cfg, img_nhwc,
                                    self.dtype)
        if self.dual is not None:  # the dynamic pipeline caches MonST3R features
            return model_api.encode(self.dual.monst3r, self.dual.monst3r_cfg, img_nhwc, self.dtype)
        return model_api.encode(self.params, self.model_cfg, img_nhwc, self.dtype)

    def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
        if self.easi3r is not None:
            return easi3r_asymmetric_inference(self.easi3r, feat_i, pos_i, feat_j, pos_j,
                                               self.img_size, self.dtype)
        if self.dual is not None:
            return monst3r_asymmetric_inference(self.dual, feat_i, pos_i, feat_j, pos_j,
                                                self.img_size, self.dtype)
        return model_api.decode(self.params, self.model_cfg, feat_i, pos_i, feat_j, pos_j,
                                self.img_size, self.dtype)

    def _stage(self, name: str, key: Optional[str] = None, rid=None, device: bool = False):
        """A span `name` of the port's recorder (utils/timing) whose host ms
        `prof[key]` also keeps (`key` defaults to `name`); `device` records
        its device time too, on a card."""
        return timing.span(name, rid=rid, device=device and self._on_cuda,
                           log=self.prof.setdefault(key or name, []))

    # ------------------------------------------------------------------
    # Frame lifecycle
    # ------------------------------------------------------------------

    def make_frame(self, frame_id: int, img_np) -> Frame:
        img = torch.as_tensor(img_np, dtype=torch.float32, device=self.device)
        img = img[None] if img.dim() == 3 else img
        feat, pos = self.encode(img)
        dev = self.device
        return Frame(
            frame_id=frame_id,
            T_WC=self._last_T_WC_dev,
            X_canon=torch.zeros((self.hw, 3), device=dev),
            C=torch.zeros((self.hw, 1), device=dev),
            N=torch.zeros((), dtype=torch.int32, device=dev),
            feat=feat,  # batched (1, n, d): fed straight to the decoder
            pos=pos,
            score=torch.zeros((), device=dev),
            img=img,
        )

    def _mono_init(self, frame: Frame) -> Frame:
        out = self._decode_pair(frame.feat, frame.pos, frame.feat, frame.pos)
        X_f, C_f, N_f, S_f = fuse_pointmap(
            frame.X_canon, frame.C, frame.N,
            out.X1[0].reshape(self.hw, 3), out.C1[0].reshape(self.hw, 1),
            self.filtering_mode, frame.score, self.track_cfg.filtering_score,
        )
        return dataclasses.replace(frame, X_canon=X_f, C=C_f, N=N_f, score=S_f)

    def _kf_view(self, kf_idx: int):
        """Cached (feat, pos, T_WC) of the tracking keyframe; cleared on
        keyframe append and backend pose write-back. T_WC is a copy: the
        memory row is overwritten in place by the backend."""
        c = self._kf_cache
        if c is not None and c[0] == kf_idx:
            return c[1]
        view = (
            self.mem.feat[kf_idx : kf_idx + 1],
            self.mem.pos[kf_idx : kf_idx + 1],
            self.mem.T_WC[kf_idx].clone(),
        )
        self._kf_cache = (kf_idx, view)
        return view

    # ------------------------------------------------------------------
    # Retrieval
    # ------------------------------------------------------------------

    def _retrieve(self, frame: Frame, add_after_query: bool) -> List[int]:
        """Keyframes retrieved for `frame` (none without a database); with
        `add_after_query` the frame is then added to the database."""
        if self.retrieval_db is None:
            return []
        with self._stage("retrieval", rid=frame.frame_id):
            feats = retrieval_mod.prep_features(
                self.retrieval_params, frame.feat.reshape(1, *frame.feat.shape[-2:]))
            with timing.span("wait"):
                feats = feats[0].cpu().numpy()
            with self._retr_lock:  # the database is host state shared with the worker
                return self.retrieval_db.update(
                    feats, add_after_query=add_after_query, k=int(self.retr_cfg.get("k", 3)),
                    min_thresh=float(self.retr_cfg.get("min_thresh", 5e-3)),
                )

    # ------------------------------------------------------------------
    # Factor graph edges
    # ------------------------------------------------------------------

    def add_factors(self, kf_i_list: List[int], kf_j_list: List[int], min_match_frac,
                    is_reloc=False, track_cache=None) -> bool:
        """Decode + match every new edge in one batched pass (2E pair decodes,
        one fewer when the tracking step's decode of the consecutive edge's
        j->i direction is reused via `track_cache`), one host read for the
        match-fraction gates."""
        E = len(kf_i_list)
        if E == 0:
            return False
        use_cache = (
            track_cache is not None
            and not is_reloc
            and kf_i_list[-1] == kf_j_list[-1] - 1
            and track_cache.get("kf_idx") == kf_i_list[-1]
        )
        B = 2 * E - 1 if use_cache else 2 * E
        src_a, src_b = self._edge_pair_slots(kf_i_list, kf_j_list, use_cache)
        B_pad = len(src_a)
        aa = torch.tensor(src_a, device=self.device)
        bb = torch.tensor(src_b, device=self.device)
        if self._mesh_params is not None:  # the pair batch split over the mesh's dp axis
            out2 = sharded_edge_decode(self.mesh, self._mesh_params, self.model_cfg,
                                       self.mem.feat[aa], self.mem.pos[aa], self.mem.feat[bb],
                                       self.mem.pos[bb], self.img_size, self.dtype)
        else:
            out2 = self._decode_pair(self.mem.feat[aa], self.mem.pos[aa],
                                     self.mem.feat[bb], self.mem.pos[bb])
        idx_all, valid_all = self.match_fn(out2.X1, out2.X2, out2.D1, out2.D2)
        hw = self.hw
        Q1b = out2.Q1.reshape(B_pad, hw, 1)
        Q2b = out2.Q2.reshape(B_pad, hw, 1)
        idx_i2j, valid_j = idx_all[:E], valid_all[:E]
        Qii, Qji = Q1b[:E], Q2b[:E]
        idx_j2i, valid_i = idx_all[E:B], valid_all[E:B]
        Qjj, Qij = Q1b[E:B], Q2b[E:B]
        if use_cache:
            c_out = track_cache["out"]
            idx_j2i = torch.cat([idx_j2i, track_cache["idx"].reshape(1, hw)])
            valid_i = torch.cat([valid_i, track_cache["valid"].reshape(1, hw, 1)])
            Qjj = torch.cat([Qjj, c_out.Q1.reshape(1, hw, 1)])
            Qij = torch.cat([Qij, c_out.Q2.reshape(1, hw, 1)])
        Qj = torch.sqrt(torch.gather(Qii, 1, idx_i2j[..., None]) * Qji)
        Qi = torch.sqrt(torch.gather(Qjj, 1, idx_j2i[..., None]) * Qij)

        Q_conf = self.backend_cfg.Q_conf
        frac_j = (valid_j & (Qj > Q_conf)).float().mean(dim=(1, 2))
        frac_i = (valid_i & (Qi > Q_conf)).float().mean(dim=(1, 2))
        with timing.span("wait"):
            fracs = torch.minimum(frac_j, frac_i).cpu().numpy()  # one host read

        added = False
        for e, (i, j) in enumerate(zip(kf_i_list, kf_j_list)):
            invalid = fracs[e] < min_match_frac and i != j - 1
            if invalid and is_reloc:
                return False
            if invalid:
                continue
            self.graph.add_edge_pair(
                i, j,
                idx_i2j[e], valid_j[e, :, 0], Qj[e, :, 0],
                idx_j2i[e], valid_i[e, :, 0], Qi[e, :, 0],
            )
            added = True
        return added

    def _edge_pair_slots(self, kf_i_list: List[int], kf_j_list: List[int], use_cache: bool):
        """The keyframe slots of the edge decode's pair rows: every i -> j,
        then every j -> i but the last one's when the tracking step's decode
        is reused, padded with the first row to a power-of-two bucket of at
        least 2 * edge_bucket_lo (one row alone stays one)."""
        n_ji = len(kf_i_list) - 1 if use_cache else len(kf_i_list)
        src_a = list(kf_i_list) + list(kf_j_list[:n_ji])
        src_b = list(kf_j_list) + list(kf_i_list[:n_ji])
        B = len(src_a)
        B_pad = 1 if B == 1 else 2 * self.edge_bucket_lo
        while B_pad < B:
            B_pad *= 2
        return src_a + [src_a[0]] * (B_pad - B), src_b + [src_b[0]] * (B_pad - B)

    def solve_backend(self):
        """Global solve on the live keyframe memory (main thread)."""
        with self._stage("backend_solve"):
            self.graph.solve(self.mem, self.backend_cfg, use_calib=self.use_calib, K=self.K,
                             img_size=self.img_size, host_solve=self.host_solve, mesh=self.mesh)
        self.prof.setdefault("backend_solve_iters", []).append(self.graph.last_iters)
        self._kf_cache = None  # the solve rewrote keyframe poses

    # ------------------------------------------------------------------
    # SLAM-state files
    # ------------------------------------------------------------------

    def save_state(self, path):
        """Write the SLAM state to `path` (.npz) with the JAX package's keys,
        dtypes and shapes, so that either package reads the other's files:
        the keyframe memory, the graph's edges, the per-frame trajectory,
        the mode and the last pose, and the host-side keyframe images and
        dynamic masks with their `_valid` flags. The deferred tracking
        decisions are resolved first."""
        self._resolve_pending()
        n = self.mem.count
        h, w = self.img_size
        uimg = np.zeros((n, h, w, 3), np.uint8)
        uimg_valid = np.zeros((n,), bool)
        dyn = np.zeros((n, h, w), bool)
        dyn_valid = np.zeros((n,), bool)
        for i in range(min(n, len(self.kf_uimgs))):
            if self.kf_uimgs[i] is not None:
                uimg[i] = np.asarray(self.kf_uimgs[i], np.uint8).reshape(h, w, 3)
                uimg_valid[i] = True
            if self.kf_dyn_masks[i] is not None:
                dyn[i] = np.asarray(self.kf_dyn_masks[i], bool).reshape(h, w)
                dyn_valid[i] = True
        mem, g, ne = self.mem, self.graph, self.graph.n_edges

        def host(t, dtype):
            return t.cpu().numpy().astype(dtype)

        np.savez_compressed(
            path,
            kf_uimg=uimg, kf_uimg_valid=uimg_valid, kf_dyn_mask=dyn, kf_dyn_mask_valid=dyn_valid,
            kf_frame_id=host(mem.frame_id[:n], np.int32),
            kf_T_WC=host(mem.T_WC[:n], np.float32),
            kf_X=host(mem.X_canon[:n], np.float32),
            kf_C=host(mem.C[:n], np.float32),
            kf_N=host(mem.N[:n], np.int32),
            kf_score=host(mem.score[:n], np.float32),
            kf_feat=host(mem.feat[:n], np.float32),
            kf_pos=host(mem.pos[:n], np.int32),
            graph_ii=g.ii[:ne].astype(np.int32),
            graph_jj=g.jj[:ne].astype(np.int32),
            graph_idx=host(g.idx[:ne], np.int32),
            graph_valid=host(g.valid_match[:ne], bool),
            graph_Q=host(g.Q[:ne], np.float32),
            frame_poses=(np.stack(self.frame_poses) if self.frame_poses
                         else np.zeros((0, 8))),
            frame_ids=np.asarray(self.frame_ids, np.int64),
            mode=int(self.mode),
            last_T_WC=np.asarray(self.last_T_WC),
        )

    def load_state(self, path):
        """Read a state file of either package into this system (files
        without `kf_score` or the host-side images load as the reference's
        do). Every cache of the old state is dropped: the tracking keyframe's
        view, the device copy of the last pose and the matcher's warm start,
        with the old state's undecided frames and unapplied solves."""
        self._pending.clear()
        if self._worker is not None:
            self._backend_jobs.join()
        self._apply_backend_results()
        data = np.load(path)
        n = data["kf_T_WC"].shape[0]
        if n > self.mem.capacity:
            raise RuntimeError(f"the state holds {n} keyframes, more than the memory's "
                               f"capacity {self.mem.capacity} (`kf_capacity`)")
        mem = self.mem
        for name, key in (("frame_id", "kf_frame_id"), ("T_WC", "kf_T_WC"), ("X_canon", "kf_X"),
                          ("C", "kf_C"), ("N", "kf_N"), ("feat", "kf_feat"), ("pos", "kf_pos"),
                          ("score", "kf_score")):
            if key not in data:  # files written before the score was kept
                continue
            arr = getattr(mem, name)
            arr[:n] = torch.from_numpy(np.asarray(data[key])).to(device=arr.device,
                                                                 dtype=arr.dtype)
        mem.count = n
        self.n_kf = n
        g = self.graph
        ne = data["graph_ii"].shape[0]
        g._grow(ne - g.n_edges)
        g.ii[:ne] = data["graph_ii"]
        g.jj[:ne] = data["graph_jj"]
        for name, key in (("idx", "graph_idx"), ("valid_match", "graph_valid"), ("Q", "graph_Q")):
            arr = getattr(g, name)
            arr[:ne] = torch.from_numpy(np.asarray(data[key])).to(device=arr.device,
                                                                 dtype=arr.dtype)
        g.n_edges = ne
        self.frame_poses = [np.array(p, np.float32) for p in data["frame_poses"]]
        self.frame_ids = [int(i) for i in data["frame_ids"]]
        self.mode = Mode(int(data["mode"]))
        self.last_T_WC = np.array(data["last_T_WC"], np.float32)
        self._last_T_WC_dev = torch.as_tensor(self.last_T_WC, device=self.device)
        self._kf_cache = None
        self.idx_f2k = None
        self.kf_uimgs = [None] * n
        self.kf_dyn_masks = [None] * n
        if "kf_uimg" in data:  # files written before the host state was kept
            for i in range(n):
                if data["kf_uimg_valid"][i]:
                    self.kf_uimgs[i] = data["kf_uimg"][i]
                if data["kf_dyn_mask_valid"][i]:
                    self.kf_dyn_masks[i] = data["kf_dyn_mask"][i]

    # ------------------------------------------------------------------
    # Backend: synchronous, or on the worker thread
    # ------------------------------------------------------------------

    def backend_step(self, kf_idx: int, frame: Frame, track_cache=None):
        """Graph edges for a new keyframe (consecutive + retrieval), then a
        global solve (run_backend, main.py:84-106): at once in
        `single_thread` mode, else queued for the backend worker with a copy
        of the solve inputs taken here on the main thread (the tracking step
        rewrites keyframe rows in place; the worker must never read them)."""
        with timing.span("backend_stall") as stall:
            if self.single_thread:
                self._backend_job_body(kf_idx, frame, None, track_cache)
            else:
                n_kf = self.n_kf
                P = min(_next_pow2(n_kf, self.backend_cfg.pose_pad_lo), self.mem.capacity)
                snap = (
                    self.mem.T_WC[:P].clone(),
                    self.mem.X_canon[:P].clone(),
                    self.mem.C[:P] / torch.clamp(self.mem.N[:P, None, None].float(), min=1.0),
                    n_kf,
                )
                self._backend_jobs.put((kf_idx, frame, snap, track_cache))
        self.backend_stall_s += stall.ms / 1e3

    def _wait_for_worker(self):
        """Wait out the worker's queued jobs: main-thread backend time."""
        with timing.span("backend_stall") as stall:
            self._backend_jobs.join()
        self.backend_stall_s += stall.ms / 1e3

    def _backend_job_body(self, kf_idx: int, frame: Frame, snap, track_cache=None):
        retrieved = self._retrieve(frame, add_after_query=True)
        ii = [idx for idx in retrieved if idx < kf_idx - 1] + ([kf_idx - 1] if kf_idx > 0 else [])
        Twc_new = None
        with self._graph_lock:
            if ii:
                self.add_factors(
                    ii, [kf_idx] * len(ii),
                    self.cfg.get("local_opt", {}).get("min_match_frac", 0.1),
                    track_cache=track_cache,
                )
            if snap is None:  # synchronous: solve on the live memory
                self.solve_backend()
                return
            # A newer job already queued supersedes this job's solve before
            # anyone reads it: skip it (the edges and retrieval above are
            # cumulative and stay). The newest job always solves.
            if not self._backend_jobs.empty():
                self.n_shed_solves += 1
                return
            Twc, Xs, Cs, n_kf = snap
            with timing.span("backend_solve") as solve:
                Twc_new = self.graph.solve_poses(
                    Twc, Xs, Cs, n_kf, self.backend_cfg, use_calib=self.use_calib, K=self.K,
                    img_size=self.img_size, host_solve=self.host_solve, mesh=self.mesh,
                )
            if Twc_new is not None:  # a solve ran
                self.prof.setdefault("backend_solve", []).append(solve.ms)
                self.prof.setdefault("backend_solve_iters", []).append(self.graph.last_iters)
                self.n_async_solves += 1
        if Twc_new is not None:
            # only the n_kf poses of the snapshot: the padding rows must not
            # clobber keyframes appended after it was taken
            self._backend_results.put((Twc_new, n_kf))

    def _backend_worker(self):
        while True:
            job = self._backend_jobs.get()
            if job is None:
                self._backend_jobs.task_done()
                return
            try:
                with self._stage("backend_job", rid=job[1].frame_id):
                    self._backend_job_body(*job)
            except Exception as e:  # keep the worker alive; raised on the main thread
                traceback.print_exc()
                with self._err_lock:
                    self._async_errors.append(e)
            finally:
                self._backend_jobs.task_done()

    def _apply_backend_results(self) -> bool:
        """Fold finished async solves into the live keyframe poses, and raise
        a backend-worker exception on the main thread (one per call)."""
        with self._err_lock:
            exc = self._async_errors.pop(0) if self._async_errors else None
        if exc is not None:
            raise RuntimeError("async backend worker failed") from exc
        applied = False
        while True:
            try:
                Twc_new, n_kf = self._backend_results.get_nowait()
            except queue.Empty:
                break
            kf_update_poses(self.mem, Twc_new[:n_kf], torch.arange(n_kf, device=self.device))
            self._kf_cache = None  # the cached keyframe pose is stale now
            applied = True
        return applied

    def finalize(self):
        """Resolve the last deferred tracking decisions, wait for the backend
        worker and apply its results: a deterministic final state for export."""
        with timing.span("finalize"):
            self._resolve_pending()
            if self._worker is not None:
                self._wait_for_worker()
            self._apply_backend_results()

    def _append_keyframe(self, frame: Frame) -> int:
        if self.n_kf >= self.kf_capacity:
            raise RuntimeError(
                f"keyframe memory full ({self.n_kf}/{self.kf_capacity}): raise the "
                "`kf_capacity` config key (each slot holds a pointmap, confidences "
                "and encoder features)"
            )
        idx = kf_append(self.mem, frame)
        self.n_kf = idx + 1
        self._kf_cache = None
        return idx

    # ------------------------------------------------------------------
    # Relocalization (main.py:29-78)
    # ------------------------------------------------------------------

    def relocalize(self, frame: Frame) -> bool:
        """Relocalize `frame` against its best retrieved keyframe: append it
        as a tentative keyframe at that keyframe's pose, add the edge (strict
        by default: a weak match rejects it), solve; on failure the tentative
        keyframe is rolled back."""
        self.n_reloc_attempts += 1
        if self._worker is not None:
            # a quiescent graph: wait out in-flight backend jobs
            self._wait_for_worker()
            self._apply_backend_results()
        retrieved = self._retrieve(frame, add_after_query=False)
        if not retrieved:
            return False
        frame = dataclasses.replace(frame, T_WC=self.mem.T_WC[retrieved[0]].clone())
        kf_idx = self._append_keyframe(frame)
        self._set_kf_uimg(kf_idx, self.cur_uimg)
        with self._graph_lock:
            ok = self.add_factors([retrieved[0]], [kf_idx], self.reloc_cfg.get("min_match_frac", 0.3),
                                  is_reloc=self.reloc_cfg.get("strict", True))
        if ok:
            self._retrieve(frame, add_after_query=True)
            with self._graph_lock:
                self.solve_backend()
            self._last_T_WC_dev = self.mem.T_WC[kf_idx].clone()
            with timing.span("wait"):
                self.last_T_WC = self._last_T_WC_dev.cpu().numpy()
            self.n_relocs += 1
            return True
        self.mem.count -= 1  # roll back the tentative keyframe
        self.n_kf -= 1
        self._kf_cache = None
        return False

    # ------------------------------------------------------------------
    # Main per-frame step
    # ------------------------------------------------------------------

    def process_frame(self, frame_id: int, timestamp, img_np, uimg=None,
                      force_kf: Optional[bool] = None):
        """One input frame: `img_np` the normalized (h, w, 3) or (1, h, w, 3)
        image (numpy or a tensor), `uimg` its uint8 RGB for the keyframe
        exports. `force_kf` overrides the tracker's keyframe decision
        host-side (True: always, False: never, None: the tracker's
        match-fraction gate). Does nothing once the viewer asked to
        terminate."""
        self._consume_viewer_control()
        if self.terminate_requested:
            return
        with timing.span("frame", rid=frame_id):
            self._process_frame(frame_id, timestamp, img_np, uimg, force_kf)

    def _process_frame(self, frame_id: int, timestamp, img_np, uimg, force_kf):
        with self._stage("apply_backend"):
            self._apply_backend_results()  # async pose write-back between frames
        self.timestamps.append(timestamp)
        self.cur_uimg = uimg
        with self._stage("encode", key="encode_dispatch", device=True):
            frame = self.make_frame(frame_id, img_np)
        with self._stage("resolve_prev"):
            self._resolve_to_depth(self.defer_depth)
            if self.mode == Mode.RELOC:
                # later in-flight frames were dispatched as TRACKING: resolve them
                # now, so a relocalization below is not overridden by them
                self._resolve_pending()
        frame = dataclasses.replace(frame, T_WC=self._last_T_WC_dev)

        if self.mode == Mode.INIT:
            frame = self._mono_init(frame)
            new_idx = self._append_keyframe(frame)
            self._set_kf_uimg(new_idx, uimg)
            self._retrieve(frame, add_after_query=True)
            self.mode = Mode.TRACKING
            self._record_pose(frame_id, frame.T_WC)
            return

        if self.mode == Mode.RELOC:
            frame = self._mono_init(frame)
            if self.relocalize(frame):
                self.mode = Mode.TRACKING
            self._record_pose(frame_id, self.last_T_WC)
            return

        kf_idx = self.n_kf - 1
        kf_feat, kf_pos, kf_T_WC = self._kf_view(kf_idx)
        kf_uimg = self.kf_uimgs[kf_idx] if kf_idx < len(self.kf_uimgs) else None
        # The flow-vs-ego-motion mask belongs to the dynamic pipeline: the
        # plain MASt3R tracker never computes one, whatever use_dynamic_mask.
        cur_dyn_mask = None
        if (self.use_dynamic_mask and self.dual is not None and self.K is not None
                and uimg is not None and kf_uimg is not None):
            with timing.span("decode", device=self._on_cuda):
                out, cur_dyn_mask = self._masked_decode(frame, uimg, kf_idx, kf_feat, kf_pos,
                                                        kf_T_WC, kf_uimg)
        else:
            with self._stage("decode", key="decode_dispatch", device=True):
                out = self._decode_pair(frame.feat, frame.pos, kf_feat, kf_pos)

        with self._stage("match_track", key="track_dispatch", device=True):
            self._match_track(frame_id, frame, out, kf_idx, kf_T_WC, uimg, force_kf,
                              cur_dyn_mask)
        if not self.defer_sync:
            with self._stage("resolve_sync"):
                self._resolve_pending()

    def _match_track(self, frame_id: int, frame: Frame, out, kf_idx: int, kf_T_WC, uimg,
                     force_kf, cur_dyn_mask):
        """Match the decoded pair, fuse, track and update the keyframe, then
        queue the frame's host decisions (`_pending`)."""
        if self.match_mode != "lm":
            use_init = self.idx_f2k is not None
            (fX, fC, fN, fS, res, summary, idx_f2k, valid_match_k) = _match_track_and_update(
                self.mem.X_canon, self.mem.C, self.mem.N, self.mem.score, kf_idx,
                out.X1, out.C1, out.Q1, out.D1, out.X2, out.C2, out.Q2, out.D2,
                self.idx_f2k,
                frame.X_canon, frame.C, frame.N, frame.score,
                frame.T_WC, kf_T_WC,
                track_cfg=self.track_cfg, img_size=self.img_size,
                fmode=self.filtering_mode, fscore=self.track_cfg.filtering_score,
                mcfg=self.match_cfg, tcfg=self.match_tcfg,
                use_kernel=self.match_mode == "kernel", use_init=use_init,
                K=self.K, use_calib=self.use_calib,
            )
        else:
            h, w = self.img_size
            idx_f2k, valid_match_k = self.match_fn(
                out.X1.reshape(1, h, w, 3), out.X2.reshape(1, h, w, 3), out.D1, out.D2,
                self.idx_f2k)
            (fX, fC, fN, fS, res, summary) = _track_and_update(
                self.mem.X_canon, self.mem.C, self.mem.N, self.mem.score, kf_idx,
                idx_f2k, valid_match_k,
                out.X1, out.C1, out.Q1, out.X2, out.C2, out.Q2,
                frame.X_canon, frame.C, frame.N, frame.score,
                frame.T_WC, kf_T_WC,
                track_cfg=self.track_cfg, img_size=self.img_size,
                fmode=self.filtering_mode, fscore=self.track_cfg.filtering_score,
                K=self.K, use_calib=self.use_calib,
            )
        self.idx_f2k = idx_f2k
        frame = dataclasses.replace(frame, X_canon=fX, C=fC, N=fN, score=fS)
        dbg = None
        if (self.use_dynamic_mask and uimg is not None
                and self.cfg.get("debug_save_final_valid_opt_mask", True)):
            # the keyframe row is a copy: later frames update it in place
            dbg = (idx_f2k, valid_match_k, out.Q1, out.Q2, fC, fN,
                   self.mem.C[kf_idx].clone(), self.mem.N[kf_idx].clone())
        # The plain pipeline's pair just decoded is the consecutive graph
        # edge's j->i direction if this frame becomes a keyframe: add_factors
        # reuses it. The dual and Easi3R pipelines mask C/D/Q after the
        # decode, so their edges are decoded afresh, and so are the LM
        # matcher's, as in the reference.
        track_pair = None
        if self.dual is None and self.easi3r is None and self.match_mode != "lm":
            track_pair = dict(kf_idx=kf_idx, out=out, idx=idx_f2k, valid=valid_match_k)
        self._pending.append(dict(
            frame_id=frame_id, frame=frame, res=res, summary=summary, uimg=uimg,
            force_kf=force_kf, track_pair=track_pair, dyn_mask=cur_dyn_mask, dbg=dbg,
        ))

    # ------------------------------------------------------------------
    # Chunked tracking (app/chunked.py)
    # ------------------------------------------------------------------

    @property
    def supports_chunking(self) -> bool:
        """Chunked tracking covers the plain MASt3R pipeline with a tiled
        matcher: the dual and Easi3R pipelines run host stages per frame,
        and the LM matcher is not fused into the tracking step.
        `use_dynamic_mask` alone is no obstacle: masks need the dual models."""
        return self.dual is None and self.easi3r is None and self.match_mode != "lm"

    def process_chunk(self, frame_ids, timestamps, imgs_dev, uimgs=None, hook_xs=None,
                      decode_hook=None) -> bool:
        """Track a (C, h, w, 3) uint8 or normalized batch on the system's
        device with one host read per event-free chunk; the decisions of
        `process_frame` with `defer_tracking_sync: 0`. Returns False once
        the viewer asked to terminate (app/chunked.py)."""
        from monst3r_slam_torch.app import chunked

        if not self.supports_chunking:
            raise RuntimeError("chunked tracking requires the plain MASt3R pipeline (no "
                               "dual or Easi3R models) and the tiled or kernel matcher")
        return chunked.process_chunk(self, frame_ids, timestamps, imgs_dev, uimgs=uimgs,
                                     hook_xs=hook_xs, decode_hook=decode_hook)

    def _masked_decode(self, frame: Frame, uimg, kf_idx: int, kf_feat, kf_pos, kf_T_WC, kf_uimg):
        """The dual decode of a tracked frame and its dynamic mask. The
        MonST3R half runs first (its depth feeds the ego-motion flow); the
        MASt3R half is enqueued by the flow-error program between enqueueing
        its own work and reading its map back, so the decode runs on the card
        while the host thresholds and refines the mask. C, D and Q are then
        zeroed on the frame's masked pixels and on the keyframe's stored
        mask. Returns (PairOutput, mask (h, w) bool)."""
        dual = self.dual
        with self._stage("decode_monst3r", device=True):
            out_m = model_api.decode(dual.monst3r, dual.monst3r_cfg, frame.feat, frame.pos,
                                     kf_feat, kf_pos, self.img_size, self.dtype)
        # the flow program's host work until it calls back, and the mask's
        # refinement after the MASt3R half is enqueued: spans whose ends
        # fall inside get_dynamic_mask
        box = {"flow": self._stage("flow_program", device=True).start()}

        def dispatch_mast3r():
            box["flow"].stop()
            with self._stage("decode_mast3r", device=True):
                box["out_a"] = model_api.decode(dual.mast3r, dual.mast3r_cfg, frame.feat,
                                                frame.pos, kf_feat, kf_pos, self.img_size,
                                                self.dtype)
            box["refine"] = self._stage("mask_refine").start()

        try:
            m = dyn.get_dynamic_mask(
                uimg, kf_uimg, frame.T_WC, kf_T_WC, out_m.X1[0, ..., 2], self.K,
                threshold=self.dyn_threshold, refine=self.dyn_refine,
                refiner=(self._mask_propagator.as_refiner()
                         if self._mask_propagator is not None else None),
                # the normalized frame is on the device already, for the encoder
                img_i_flow=frame.img,
                overlap_cb=dispatch_mast3r,
            )
        finally:
            box["flow"].stop()
            if "refine" in box:
                box["refine"].stop()
        if "out_a" not in box:  # get_dynamic_mask runs the callback exactly once
            raise RuntimeError("the flow-error program broke the overlap_cb contract: "
                               "get_dynamic_mask returned without invoking the callback "
                               "(see dynamic/mask.py set_flow_error_program)")
        self.prof.setdefault("mask_share", []).append(float(m.mean()))
        timing.count("dyn.mask_px", int(m.sum()))
        self._last_dyn_mask = m
        out = combine(out_m, box["out_a"])
        if self.cfg.get("debug_save_dynamic_mask", True):
            try:
                from monst3r_slam_torch.viz import debug as dbgviz

                dbgviz.save_mask_overlay(
                    self._debug_dir("debug_dynamic_mask") / f"frame_{frame.frame_id:06d}.png",
                    uimg, m, color=(255, 0, 0), alpha=0.5)
            except Exception as e:  # best-effort, as in the reference
                print(f"dynamic-mask overlay failed for {frame.frame_id}: {e}")
        if m.any():
            C1_before = out.C1
            C1, D1, Q1 = dyn.apply_dynamic_mask_native(out.C1, out.D1, out.Q1, m)
            out = out._replace(C1=C1, D1=D1, Q1=Q1)
            self._save_pointmap_dumps(frame.frame_id, out.X1, C1_before, C1)
        kf_mask = self.kf_dyn_masks[kf_idx] if kf_idx < len(self.kf_dyn_masks) else None
        if kf_mask is not None and kf_mask.any():
            C2, D2, Q2 = dyn.apply_dynamic_mask_native(out.C2, out.D2, out.Q2, kf_mask)
            out = out._replace(C2=C2, D2=D2, Q2=Q2)
        return out, m

    def _resolve_pending(self):
        """Resolve every pending tracking result."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def _resolve_to_depth(self, depth: int):
        """Resolve the oldest pending results until at most max(depth-1, 0)
        remain."""
        keep = max(depth - 1, 0)
        while len(self._pending) > keep:
            self._resolve_one(self._pending.popleft())

    def _resolve_one(self, p: dict):
        """Host-side decisions for one tracked frame: RELOC, pose write-back,
        keyframe event."""
        frame_id, frame, res = p["frame_id"], p["frame"], p["res"]
        with timing.span("resolve", rid=frame_id):
            if p["dbg"] is not None:
                self._save_valid_opt_overlay(frame_id, p["uimg"], *p["dbg"])
            with timing.span("wait"):
                sv = p["summary"].cpu().numpy()  # one device->host read per frame
            self.last_summary = sv
            if sv[8] > 0.5 or sv[9] > 0.5:  # low_match | solver_failed
                self.mode = Mode.RELOC
                self.idx_f2k = None
                if self._mask_propagator is not None:
                    self._mask_propagator.reset()  # stale masks must not seed later frames
                self._record_pose(frame_id, self.last_T_WC)
                return

            frame = dataclasses.replace(frame, T_WC=res.T_WCf)
            self.last_T_WC = sv[:8]
            self._last_T_WC_dev = res.T_WCf

            new_kf = sv[10] > 0.5 if p["force_kf"] is None else p["force_kf"]
            if new_kf:
                with self._stage("kf_event"):
                    self.idx_f2k = None
                    new_idx = self._append_keyframe(frame)
                    self._set_kf_uimg(new_idx, p["uimg"], dyn_mask=p["dyn_mask"])
                    tc = p["track_pair"]
                    if tc is not None and tc["kf_idx"] != new_idx - 1:
                        tc = None  # an interleaved keyframe broke consecutiveness
                    self.backend_step(new_idx, frame, track_cache=tc)
                    if self.single_thread:
                        # the synchronous solve just updated this pose; read it back
                        self._last_T_WC_dev = self.mem.T_WC[new_idx].clone()
                        with timing.span("wait"):
                            self.last_T_WC = self._last_T_WC_dev.cpu().numpy()
                    # async: the solve has not run yet, and the tracked pose is
                    # already on the host (sv[:8])

            self._record_pose(frame_id, self.last_T_WC)

    def _save_valid_opt_overlay(self, frame_id: int, uimg, idx_f2k, valid_match_k, Q1, Q2, fC,
                                fN, kC, kN):
        """The debug overlay of the pixels that passed every gate of the
        tracking step (valid match, C and Q confidences), recomputed on the
        host from its outputs."""
        try:
            from monst3r_slam_torch.viz import debug as dbgviz

            idx = idx_f2k.reshape(-1).cpu().numpy()
            Qk = np.sqrt(Q1.reshape(-1).float().cpu().numpy()[idx]
                         * Q2.reshape(-1).float().cpu().numpy())
            Cf = (fC.reshape(-1).cpu().numpy()
                  / np.maximum(fN.float().reshape(-1).cpu().numpy(), 1.0))[idx]
            Ck = kC.reshape(-1).cpu().numpy() / np.maximum(kN.float().reshape(-1).cpu().numpy(), 1.0)
            tc = self.track_cfg
            valid_opt = (valid_match_k.reshape(-1).cpu().numpy() & (Cf > tc.C_conf)
                         & (Ck > tc.C_conf) & (Qk > tc.Q_conf)).reshape(self.img_size)
            dbgviz.save_mask_overlay(
                self._debug_dir("debug_final_valid_opt_mask") / f"frame_{frame_id:06d}_final_opt.png",
                uimg, valid_opt, color=(0, 255, 0), alpha=0.5)
        except Exception as e:  # best-effort, as in the reference
            print(f"valid_opt overlay failed for {frame_id}: {e}")

    def _save_pointmap_dumps(self, frame_id: int, X1, C1_before, C1_after):
        """The pointmap panels and the 3D scatter before and after the
        dynamic mask (config keys `debug_save_pointmap_visualization`,
        `debug_save_3d_pointclouds`; off by default); best-effort, as in the
        reference."""
        panels = self.cfg.get("debug_save_pointmap_visualization", False)
        scatter = self.cfg.get("debug_save_3d_pointclouds", False)
        if not (panels or scatter):
            return
        try:
            from monst3r_slam_torch.viz import debug as dbgviz

            h, w = self.img_size
            Xhw = X1.float().cpu().numpy().reshape(h, w, 3)
            Cb = C1_before.float().cpu().numpy().reshape(h, w)
            Ca = C1_after.float().cpu().numpy().reshape(h, w)
            if panels:
                dbgviz.save_pointmap_visualization(
                    Xhw, Cb, Xhw, Ca, frame_id, self._debug_dir("debug_pointmap_visualization"))
            if scatter:
                dbgviz.save_3d_pointcloud_comparison(
                    Xhw, Cb, Xhw, Ca, frame_id, self._debug_dir("debug_3d_pointclouds"))
        except Exception as e:  # best-effort, as in the reference
            print(f"pointmap debug dump failed for {frame_id}: {e}")

    def _debug_dir(self, name: str):
        """logs/<dataset>/<sequence>/<name>, the reference's layout."""
        ds = self.cfg.get("dataset", {})
        seq = ds.get("sequence", ds.get("video", "unknown_video"))
        return pathlib.Path("logs") / ds.get("name", "unknown_dataset") / str(seq) / name

    def _set_kf_uimg(self, idx: int, uimg, dyn_mask=None):
        while len(self.kf_uimgs) <= idx:
            self.kf_uimgs.append(None)
            self.kf_dyn_masks.append(None)
        self.kf_uimgs[idx] = uimg
        self.kf_dyn_masks[idx] = dyn_mask

    def _record_pose(self, frame_id: int, T_WC):
        self.frame_ids.append(frame_id)
        if isinstance(T_WC, torch.Tensor):
            with timing.span("wait"):
                T_WC = T_WC.cpu().numpy()
        self.frame_poses.append(np.array(T_WC, np.float32))
        self._maybe_push_viewer()

    # ------------------------------------------------------------------
    # Live viewer
    # ------------------------------------------------------------------

    def _consume_viewer_control(self):
        """Apply the viewer's pending control messages between frames: the
        display threshold, terminate, relocalization, and pause (hold here
        until resumed, stepped or terminated)."""
        if (self.viewer is None or not hasattr(self.viewer, "poll_control")
                or self.terminate_requested):  # a paused viewer must not block shutdown
            return
        while True:
            msg = self.viewer.poll_control()
            if msg.get("C_conf") is not None:
                self.viz_C_conf = float(msg["C_conf"])
            if msg.get("terminate"):
                self.terminate_requested = True
                return
            if msg.get("reloc") and self.mode == Mode.TRACKING:
                self.mode = Mode.RELOC
                self.idx_f2k = None
                if self._mask_propagator is not None:
                    self._mask_propagator.reset()
            if not msg.get("pause") or msg.get("step"):
                return
            time.sleep(0.05)  # paused: hold between frames until resume or step

    def _maybe_push_viewer(self, min_interval_s: float = 1.0):
        """At most once per `min_interval_s`: the keyframe memory as a surfel
        snapshot of about 200k points (strided per keyframe, in grid order,
        points under the display threshold NaN so that the mesh mode keeps
        its holes), the trajectory, the keyframe frustums, and the current
        frame with its dynamic mask. Reads each keyframe's four outputs back
        from the device, which waits for the work queued before them."""
        if self.viewer is None:
            return
        now = time.time()
        if now - self._last_viz_push < min_interval_s:
            return
        n = self.mem.count
        if n == 0:
            return
        self._last_viz_push = now
        with self._stage("viewer_push"):
            self._push_viewer(n)

    def _push_viewer(self, n: int):
        """The snapshot of the first `n` keyframes, to the viewer."""
        h, w = self.img_size
        stride = max(1, int(np.ceil(np.sqrt(n * self.hw / 200_000))))
        gh, gw = viewer_grid_dims(h, w, stride)
        T = self.mem.T_WC[:n].cpu().numpy()
        cols = self.keyframe_colors().reshape(n, h, w, 3)[:, ::stride, ::stride].reshape(n, -1, 3)
        if self.cur_uimg is not None and hasattr(self.viewer, "update_frame"):
            self.viewer.update_frame(self.cur_uimg, self._last_dyn_mask)
        pts, nrm, rad = [], [], []
        for i in range(n):
            Xw, Nw, R, conf = (t.cpu().numpy() for t in _surfel_snapshot(
                self.mem.X_canon[i], self.mem.C[i], self.mem.N[i], self.mem.T_WC[i],
                h=h, w=w, stride=stride))
            Xw[conf <= self.viz_C_conf] = np.nan  # mesh holes; the splat mode skips NaNs
            pts.append(Xw)
            nrm.append(Nw)
            rad.append(R)
        traj = (np.stack(self.frame_poses)[:, :3] if self.frame_poses
                else np.zeros((0, 3), np.float32))
        self.viewer.update(
            np.concatenate(pts), cols.reshape(-1, 3), traj=traj, kf_centers=T[:, :3],
            kf_segments=type(self.viewer).frustum_segments(T),
            normals=np.concatenate(nrm), radii=np.concatenate(rad), grid=(gh, gw),
        )

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def keyframe_trajectory(self):
        n = self.mem.count
        return self.mem.T_WC[:n].cpu().numpy(), self.mem.frame_id[:n].cpu().numpy()

    def keyframe_colors(self) -> np.ndarray:
        """(n_kf, hw, 3) float RGB in [0, 1] from the kept keyframe images;
        gray for a keyframe without one."""
        n = self.mem.count
        cols = np.full((n, self.hw, 3), 0.5, np.float32)
        for i in range(min(n, len(self.kf_uimgs))):
            u = self.kf_uimgs[i]
            if u is not None:
                cols[i] = np.asarray(u, np.float32).reshape(self.hw, 3) / 255.0
        return cols

    def full_trajectory(self):
        poses = np.stack(self.frame_poses) if self.frame_poses else np.zeros((0, 8))
        return self.frame_ids, poses
