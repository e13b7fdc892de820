"""Traffic kind `slam_oracle`: the SLAM main path over oracle episodes.

Each episode is a fresh `SLAMSystem` of the program (config file as
shipped, weights made once in set-up) fed `episode_frames` frames of the
oracle scene (`scene.py`) along the known path from a start drawn from the
seed. Every frame goes through `process_frame`: the real encode and decode
run (kernel A inside), then the decode's X, D, C, Q are replaced by the
scene's exact pointmaps and descriptors and C = Q = 2 (the recipe of the
reference's `bench.py`), so the matcher (kernel B), the tracker, keyframing,
retrieval and the backend worker follow a known trajectory at the model's
full cost. Nothing is forced. Each episode ends with `finalize`; the window
replays the set-up's episodes in turn until `--seconds` have passed, and
an episode the window's end cuts counts for the frames only.

What the window produced is checked after it closes, at frames of its
first episode drawn from the seed: the decodes that the timed path ran
(captured before the oracle replaced them) against the plain reference
model in f32 on the same images, the kernel B calls it made against the
plain reference matcher, and the tracker's pose solves against the plain
reference solve in f64, each on the inputs that the program handed that
stage. Each completed episode's trajectory error is printed beside them.
"""

from __future__ import annotations

import inspect
import itertools
import threading
import time

import numpy as np
import torch

from benchmark.harness import common, scene, weights
from benchmark.harness.trace import Tracer

PAIR_KEYS = ("X1", "C1", "D1", "Q1", "X2", "C2", "D2", "Q2")


class Window:
    """What the window records besides the program's own state."""

    def __init__(self):
        self.slam = None
        self.capture_fids: set = set()
        self.decodes: dict = {}  # frame id -> (episode, keyframe's frame id, {key: tensor})
        self.matches: dict = {}  # frame id -> (args, tcfg, conv_thresh, (u, v, conv))
        self.tracks: dict = {}  # frame id -> (track_pose's arguments, its T_CkCf)
        self.traced_matches: list = []
        self.tracing = False
        self.encodes = 0
        self.decode_rows = 0
        self.gn_iters: list = []
        self.counting = False


def oracle_class(SLAMSystem, PairOutput, rff: dict, focal: float, rec: Window):
    class OracleSLAM(SLAMSystem):
        def __post_init__(self):
            super().__post_init__()
            self.gt, self._cur_fid, self.kf_fids = {}, None, []
            self._edge_tls = threading.local()

        def make_frame(self, frame_id, img_np):
            self._cur_fid = int(frame_id)
            if rec.counting:
                rec.encodes += 1
            return super().make_frame(frame_id, img_np)

        def _append_keyframe(self, frame):
            idx = super()._append_keyframe(frame)
            self.kf_fids[idx:idx + 1] = [int(frame.frame_id)]
            return idx

        def _edge_pair_slots(self, kf_i_list, kf_j_list, use_cache):
            slots = super()._edge_pair_slots(kf_i_list, kf_j_list, use_cache)
            self._edge_tls.slots = slots
            return slots

        def _resolve_one(self, p):
            if rec.counting:
                rec.gn_iters.append(int(p["res"].iters))
            return super()._resolve_one(p)

        def _decode_pair(self, feat_i, pos_i, feat_j, pos_j):
            out = super()._decode_pair(feat_i, pos_i, feat_j, pos_j)
            if rec.counting:
                rec.decode_rows += feat_i.shape[0]
            slots = getattr(self._edge_tls, "slots", None)
            self._edge_tls.slots = None
            if slots is not None:
                fi, fj = ([self.kf_fids[s] for s in side] for side in slots)
            elif feat_j is feat_i:  # the first frame against itself
                fi, fj = [self._cur_fid], [self._cur_fid]
            else:
                fi, fj = [self._cur_fid], [self.kf_fids[self.n_kf - 1]]
                if self._cur_fid in rec.capture_fids and self._cur_fid not in rec.decodes:
                    rec.decodes[self._cur_fid] = (self.episode, fj[0],
                                                  {k: getattr(out, k).detach().clone()
                                                   for k in PAIR_KEYS})
            Ti, Tj = (torch.from_numpy(np.stack([self.gt[f] for f in ids])).to(self.device)
                      for ids in (fi, fj))
            h, w = self.img_size
            X1, D1, X2, D2 = scene.render_pair(Ti, Tj, rff, h, w, focal)
            two = torch.full_like(out.C1, 2.0)
            return PairOutput(X1.reshape(out.X1.shape), two, D1.reshape(out.D1.shape), two,
                              X2.reshape(out.X2.shape), two, D2.reshape(out.D2.shape), two)

    return OracleSLAM


def wrap_tile_match(matching_tiled, rec: Window, control=None):
    """The tiled matcher's kernel B entry, recording the calls the checks
    and the traced window read; returns the function to restore. With
    `control` = (rays, descriptors) the reference matcher in those
    precisions answers in kernel B's place."""
    original = kernel = matching_tiled.tile_match
    if control is not None:
        from benchmark.reference import matcher

        def kernel(rays_img, desc_img, q_rays, q_desc, corners, tcfg, conv_thresh=1e-6):
            u, v, c = matcher.tile_match(rays_img, desc_img, q_rays, q_desc, corners, tcfg.crop,
                                         tcfg.window, conv_thresh, *control)
            return u.to(torch.int32), v.to(torch.int32), c

    def recorded(rays_img, desc_img, q_rays, q_desc, corners, *args, **kwargs):
        got = kernel(rays_img, desc_img, q_rays, q_desc, corners, *args, **kwargs)
        tcfg = kwargs["tcfg"] if "tcfg" in kwargs else args[0]
        conv_thresh = kwargs.get("conv_thresh", args[1] if len(args) > 1 else 1e-6)
        if rec.tracing:
            rec.traced_matches.append(dict(
                shape=(q_rays.shape[0], q_rays.shape[1], tcfg.crop, desc_img.shape[-1],
                       rays_img.shape[0], rays_img.shape[1], tcfg.window),
                rays=rays_img.detach().clone(), q_rays=q_rays.detach().clone(),
                corners=corners.detach().clone()))
        fid = rec.slam._cur_fid if rec.slam is not None else None
        if (threading.current_thread() is threading.main_thread() and fid in rec.capture_fids
                and fid not in rec.matches):
            rec.matches[fid] = (tuple(t.detach().clone() for t in
                                      (rays_img, desc_img, q_rays, q_desc, corners)),
                                (tcfg.crop, tcfg.window), conv_thresh,
                                tuple(t.detach().clone() for t in got))
        return got

    matching_tiled.tile_match = recorded
    return original


class Feed:
    """Frames of the episodes in `order`, cycled: each episode a fresh
    system, `finalize`d after its last frame; `capture` the frame ids whose
    decodes and matches the first episode records for the checks."""

    def __init__(self, new_system, gts, frames, order, rec: Window, capture: set):
        self.new_system, self.gts, self.frames, self.rec = new_system, gts, frames, rec
        self.order, self.capture = itertools.cycle(order), capture
        self.slam, self.e, self.i, self.n_ep = None, None, 0, 0
        self.done, self.backend_ms, self.lost = [], [], 0

    def frame(self) -> float:
        """Process the next frame; its `process_frame` time in ms."""
        if self.slam is None:
            self.e, self.i = next(self.order), 0
            self.slam = self.rec.slam = self.new_system()
            self.slam.episode = self.e
            self.rec.capture_fids = self.capture if self.n_ep == 0 else set()
            self.n_ep += 1
        slam, i, e = self.slam, self.i, self.e
        slam.gt[i] = self.gts[e][i]
        t = time.perf_counter()
        slam.process_frame(i, i / 30.0, self.frames[e][1][i], uimg=self.frames[e][0][i])
        ms = (time.perf_counter() - t) * 1e3
        self.lost += slam.mode.name != "TRACKING"
        self.i += 1
        if self.i == len(self.gts[e]):
            slam.finalize()
            self.done.append((slam.full_trajectory()[1], self.gts[e], e))
            self.close()
        return ms

    def close(self) -> None:
        if self.slam is not None:
            self.backend_ms += self.slam.prof.get("backend_job", [])
            stop_worker(self.slam)
            self.slam = self.rec.slam = None


def wrap_track_pose(tracker_mod, rec: Window):
    """The tracker's entry, recording the sampled frames' inputs and result
    for the checks; returns the function to restore."""
    track_pose = tracker_mod.track_pose
    sig = inspect.signature(track_pose)

    def recorded(*args, **kwargs):
        res = track_pose(*args, **kwargs)
        fid = rec.slam._cur_fid if rec.slam is not None else None
        if (threading.current_thread() is threading.main_thread() and fid in rec.capture_fids
                and fid not in rec.tracks):
            bound = sig.bind(*args, **kwargs).arguments
            rec.tracks[fid] = ({k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                                for k, v in bound.items()}, res.T_CkCf.detach().clone())
        return res

    tracker_mod.track_pose = recorded
    return track_pose


def stop_worker(slam) -> None:
    if slam is not None and slam._worker is not None:
        slam._backend_jobs.put(None)
        slam._worker.join()
        slam._worker = None


def run(cell) -> dict:
    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.models.mast3r import PairOutput
    from monst3r_slam_torch.native.build import solver_available
    from monst3r_slam_torch.ops import build, matching_tiled
    from monst3r_slam_torch.slam import retrieval
    from monst3r_slam_torch.slam import tracker as tracker_mod

    cell.phase("import")
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    if dev == "cuda":
        build.build()  # kernels A and B, once per checkout (build/kernels)
    solver_available()  # the f64 host solve, once per checkout (build/native)
    cell.phase("build")

    params = weights.make_params(cfg, cell.seed, dev, served=True)
    common.sync(dev)
    cell.phase("weights")

    rng = np.random.default_rng(cell.seed)
    h, w = cfg["img_size"]
    focal = tr["focal_scale"] * w
    n_frames = tr["episode_frames"]
    gts = [scene.trajectory(int(s), n_frames, tr["step"]) for s in tr["episode_starts"]]
    frames = [scene.render_images(torch.from_numpy(g).to(dev), h, w, focal) for g in gts]
    rff = scene.make_rff(cfg["desc_dim"], tr["rff_scale"],
                         torch.Generator(device=dev).manual_seed(tr["rff_seed"]))
    order = [int(e) for e in rng.permutation(len(gts))]
    lo, hi = tr["check_frame_range"]
    check_fids = {int(f) for f in rng.choice(np.arange(lo, hi), tr["check_frames"], replace=False)}
    slam_cfg = load_config(tr["slam_config"], set_global=False)
    for key, val in tr.get("slam_overrides", {}).items():
        slam_cfg[key] = {**slam_cfg.get(key, {}), **val} if isinstance(val, dict) else val
    mcfg = common.model_config(cfg)
    rparams = retrieval.init_retrieval_params(
        torch.Generator().manual_seed(int(rng.integers(2**62))), mcfg.enc_dim, device=dev)
    rec = Window()
    Oracle = oracle_class(SLAMSystem, PairOutput, rff, focal, rec)

    def new_system():
        return Oracle(params=params, model_cfg=mcfg, cfg=slam_cfg, img_size=(h, w), device=dev,
                      retrieval_params=rparams,
                      retrieval_db=retrieval.ASMKDatabase.from_config(slam_cfg))

    common.sync(dev)
    cell.phase("traffic")

    warm = Feed(new_system, gts, frames, order[:1], rec, set())
    for _ in range(tr["warmup_frames"]):
        warm.frame()
    warm.close()
    common.sync(dev)
    cell.phase("warmup")
    setup_s = cell.setup_done()

    tracer = Tracer(cell.trace)
    restore = wrap_tile_match(matching_tiled, rec, cell.control.get("matcher"))
    restore_track = wrap_track_pose(tracker_mod, rec)
    feed = Feed(new_system, gts, frames, order, rec, check_fids)
    wall_ms = []
    try:
        rec.counting = True
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        while time.perf_counter() < deadline:
            wall_ms.append(feed.frame())
        common.sync(dev)
        window_s = time.perf_counter() - t0
        rec.counting = False
        done, lost = list(feed.done), feed.lost
        backend_ms = feed.backend_ms + (feed.slam.prof.get("backend_job", []) if feed.slam else [])
        peak = common.memory_peak(dev)
        if tracer.enabled:  # the frames that follow the window, profiled
            tracer.start()
            feed.frame()
            tracer.mark()
            rec.tracing = True
            for _ in range(tr["trace_frames"]):
                feed.frame()
            rec.tracing = False
            tracer.stop()
    finally:
        matching_tiled.tile_match = restore
        tracker_mod.track_pose = restore_track
        feed.close()
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()

    checks = check(cell, rec, done, gts, h, w, focal)
    frames_done = len(wall_ms)
    rec.slam = None
    print(f"slam window: {frames_done} frames in {window_s:.3f} s, {len(done)} episodes "
          f"completed, {lost} frames lost, episode ATE % {checks.pop('episodes')}, "
          f"captured decodes {sorted(rec.decodes)} matches {sorted(rec.matches)}", flush=True)
    return dict(setup_s=setup_s, window_s=window_s, frames=frames_done, frame_wall_ms=wall_ms,
                episodes=done, backend_job_ms=backend_ms, gn_iters=rec.gn_iters,
                encodes=rec.encodes, decode_rows=rec.decode_rows, img_size=(h, w), config=cfg,
                traced_matches=rec.traced_matches, trace=tracer.summary,
                traced_frames=tr["trace_frames"], attempted=frames_done,
                failed=lost, checks=checks, memory_peak_bytes=peak,
                device_kind=common.device_kind(dev))


def check(cell, rec: Window, done, gts, h: int, w: int, focal: float) -> dict:
    """The compared numbers (module docstring); every input the reference
    reads is made again from the seed or taken from the window's record."""
    from benchmark.reference import ate, matcher, model, tracker

    cfg, dev = cell.config, cell.device
    out = {}
    ref_params = weights.make_params(cfg, cell.seed, dev, served=True)
    errs = []
    with torch.no_grad(), model.exact_f32():
        for fid, (e, kf_fid, got) in sorted(rec.decodes.items()):
            poses = torch.from_numpy(gts[e][[fid, kf_fid]]).to(dev)
            _, imgs = scene.render_images(poses, h, w, focal)
            o1, o2 = model.pair(ref_params, cfg, imgs[0:1], imgs[1:2])
            ref = dict(X1=o1["pts3d"], C1=o1["conf"], D1=o1["desc"], Q1=o1["desc_conf"],
                       X2=o2["pts3d"], C2=o2["conf"], D2=o2["desc"], Q2=o2["desc_conf"])
            if "decode" in cell.control:  # the reference in the program's place
                c1, c2 = model.pair(ref_params, cfg, imgs[0:1], imgs[1:2],
                                    model.Precision(cell.control["decode"]))
                got = dict(X1=c1["pts3d"], C1=c1["conf"], D1=c1["desc"], Q1=c1["desc_conf"],
                           X2=c2["pts3d"], C2=c2["conf"], D2=c2["desc"], Q2=c2["desc_conf"])
            errs.append(model.rel_errors(got, ref))
            del o1, o2, ref
    out["decode_rel_rms"] = common.finite(max((e[0] for r in errs for e in r.values()),
                                              default=float("inf")))
    out["decode_rel_max"] = common.finite(max((e[1] for r in errs for e in r.values()),
                                              default=float("inf")))
    del ref_params
    gaps = []
    with torch.no_grad():
        for fid, (args, (crop, window), conv_thresh, got) in sorted(rec.matches.items()):
            gaps.append(matcher.match_gap(*args, crop, window, conv_thresh, got))
    out["match_gap"] = common.finite(max(gaps, default=float("inf")))
    tgaps = []
    for fid, (args, got) in sorted(rec.tracks.items()):
        if args["use_calib"]:
            raise ValueError("the reference tracker solves the uncalibrated residual only")
        M_ref, _ = tracker.track(args)
        if "tracker" in cell.control:  # the reference in the program's place
            M_ctl, _ = tracker.track(args, getattr(torch, cell.control["tracker"]))
            tgaps.append(float((M_ctl - M_ref)[:3].abs().max()))
        else:
            tgaps.append(tracker.pose_gap(got, M_ref))
    out["track_gap"] = common.finite(max(tgaps, default=float("inf")))
    out["episodes"] = [(e, round(ate.episode_pct(p[:, :3], g[:, :3]), 6)) for p, g, e in done]
    return out
