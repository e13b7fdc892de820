"""Traffic kind `slam_dynamic_oracle`: MonST3R-SLAM's dynamic pipeline over
oracle episodes of a scene with one moving object.

Each episode is a fresh dual `SLAMSystem` of the program (MonST3R + MASt3R
weights made once in set-up, the config file as shipped, the frames'
intrinsics as K, `use_calib` off) fed `episode_frames` frames of the
dynamic oracle scene (`scene_dynamic.py`) along the known path. The flow
and the refiner are installed as `main_monster_torch.py` installs them:
RAFT's flow estimator and its fused flow-error program, and SAM2's image
refiner at the configuration's widths under the pipeline's temporal
propagator, with weights from the harness (`weights_dynamic.py`).
Everything real runs, and the oracle replaces outputs only:

* each decode's X, C, D and Q (both decoders, the object included) by the
  scene's exact pointmaps and descriptors, C = Q = 2;
* each RAFT flow by the scene's exact flow between the same two frames, on
  the device;
* SAM2's selected mask of each prompted component by the frame's exact
  object mask (at SAM2's mask resolution), with an IoU of 1.

The ego-motion flow, the error map, its threshold, the propagator, the
zeroing of C/D/Q and the keyframes' masks stay the program's, so the
trajectory error says whether the dynamic mechanism keeps the object out of
tracking. Nothing else is forced. The window replays the set-up's episodes
as `slam_oracle.py` does.

What the window produced is checked after it closes, at frames of its first
episode drawn from the seed, each against the plain f32 reference on the
inputs the program handed that stage: both decodes (captured before the
oracle replaced them) against `reference/model.py` on the same images;
RAFT's flow of the fused program against `reference/raft.py`; the coarse
mask against `reference/dynamic_mask.py` on the same flow, poses, depth
and K; SAM2's logits, IoUs and selected masks against `reference/sam2.py`
(the first call at or after each checked frame); the mask that zeroed C, D
and Q against the exact object mask; kernel B and the pose solve as in
`slam_oracle.py`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.harness import common, scene, scene_dynamic, slam_oracle, weights, weights_dynamic
from benchmark.harness.trace_spans import SpanTracer

MODELS = ("monst3r", "mast3r")


class Window(slam_oracle.Window):
    """What the window records besides the program's own state."""

    def __init__(self):
        super().__init__()
        self.ctx = threading.local()  # the pair a decode or flow is of
        self.flows: dict = {}  # frame id -> (img1, img2 in [0, 255], RAFT's flow)
        self.masks: dict = {}  # frame id -> the flow program's inputs and its error map
        self.used: dict = {}  # frame id -> the mask that zeroed C, D and Q
        self.sam2: list = []  # (frame id, image, points, labels, logits, iou, selection)
        self.sam2_pending: list = []
        self.sam2_img = None
        self.sam2_out = None
        self.rows = {m: 0 for m in MODELS}  # decoded pairs of each model
        self.raft_calls = 0
        self.sam2_calls = 0


class World:
    """The exact outputs of the scene for a system's frame ids."""

    def __init__(self, starts, obj, rff, rff_obj, h, w, focal):
        self.starts, self.obj, self.rff, self.rff_obj = starts, obj, rff, rff_obj
        self.h, self.w, self.f = h, w, focal

    def poses(self, slam, fids):
        dev = slam.device
        T = torch.from_numpy(np.stack([slam.gt[f] for f in fids])).to(dev)
        idx = torch.tensor([self.starts[slam.episode] + f for f in fids], dtype=torch.float32,
                           device=dev)
        return T, idx

    def pair(self, slam, fi, fj):
        Ti, ii = self.poses(slam, fi)
        Tj, ij = self.poses(slam, fj)
        return scene_dynamic.render_pair(Ti, Tj, ii, ij, self.obj, self.rff, self.rff_obj,
                                         self.h, self.w, self.f)

    def flow(self, slam, fi, fj):
        Ti, ii = self.poses(slam, [fi])
        Tj, ij = self.poses(slam, [fj])
        return scene_dynamic.flow(Ti[0], Tj[0], ii[0], ij[0], self.obj, self.h, self.w, self.f)

    def mask(self, slam, fid):
        T, idx = self.poses(slam, [fid])
        return scene_dynamic.object_mask(T[0], idx[0], self.obj, self.h, self.w, self.f)


def oracle_class(SLAMSystem, rec: Window):
    class DynamicOracle(SLAMSystem):
        def __post_init__(self):
            super().__post_init__()
            self.gt, self._cur_fid, self.kf_fids = {}, None, []
            self._edge_tls = threading.local()
            self._last_masked = None

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
            slots = getattr(self._edge_tls, "slots", None)
            self._edge_tls.slots = None
            if slots is not None:
                fi, fj = ([self.kf_fids[s] for s in side] for side in slots)
            else:  # a frame against itself: INIT and relocalization
                fi = fj = [self._cur_fid] * feat_i.shape[0]
            rec.ctx.pair = dict(slam=self, fi=fi, fj=fj, masked=False)
            try:
                return super()._decode_pair(feat_i, pos_i, feat_j, pos_j)
            finally:
                rec.ctx.pair = None

        def _masked_decode(self, frame, uimg, kf_idx, kf_feat, kf_pos, kf_T_WC, kf_uimg):
            fid, kf_fid = self._cur_fid, self.kf_fids[kf_idx]
            rec.ctx.pair = dict(slam=self, fi=[fid], fj=[kf_fid], masked=True)
            rec.ctx.flow = dict(slam=self, program=(fid, kf_fid), propagate=(self._last_masked,
                                                                               fid))
            try:
                out, m = super()._masked_decode(frame, uimg, kf_idx, kf_feat, kf_pos, kf_T_WC,
                                                kf_uimg)
            finally:
                rec.ctx.pair = rec.ctx.flow = None
            self._last_masked = fid
            if fid in rec.capture_fids and fid not in rec.used:
                rec.used[fid] = ((out.C1[0] == 0) & (out.Q1[0] == 0)
                                 & (out.D1[0] == 0).all(-1)).detach().clone()
            return out, m

    return DynamicOracle


def wrap_decode(mast3r_mod, PairOutput, world: World, rec: Window):
    """The model's decode, its outputs replaced by the exact ones for the
    pair of the current context (and recorded for the checks at the
    sampled frames); returns the function to restore."""
    decode = mast3r_mod.decode

    def oracle(params, cfg, feat1, pos1, feat2, pos2, shape, *args, **kwargs):
        out = decode(params, cfg, feat1, pos1, feat2, pos2, shape, *args, **kwargs)
        ctx = getattr(rec.ctx, "pair", None)
        if ctx is None:
            return out
        model = "monst3r" if cfg.desc_dim is None else "mast3r"
        if rec.counting:
            rec.rows[model] += feat1.shape[0]
        slam, fi, fj = ctx["slam"], ctx["fi"], ctx["fj"]
        if ctx["masked"] and fi[0] in rec.capture_fids:
            got = rec.decodes.setdefault(fi[0], (slam.episode, fj[0], {}))[2]
            if model not in got:
                got[model] = {k: getattr(out, k).detach().clone()
                              for k in slam_oracle.PAIR_KEYS if getattr(out, k) is not None}
        if "exact" not in ctx:
            ctx["exact"] = world.pair(slam, fi, fj)
        X1, D1, X2, D2 = ctx["exact"]
        two = torch.full_like(out.C1, 2.0)
        has_d = out.D1 is not None
        return PairOutput(X1.reshape(out.X1.shape), two,
                          D1.reshape(out.D1.shape) if has_d else None, two if has_d else None,
                          X2.reshape(out.X2.shape), two,
                          D2.reshape(out.D2.shape) if has_d else None, two if has_d else None)

    mast3r_mod.decode = oracle
    return decode


def wrap_raft(raft_mod, world: World, rec: Window):
    """RAFT's flow, replaced by the exact flow between the frames of the
    call (the fused program's: the frame to its keyframe; the propagator's:
    the previous masked frame to the frame); returns the function to
    restore."""
    raft_flow = raft_mod.raft_flow

    def oracle(params, img1, img2, *args, **kwargs):
        out = raft_flow(params, img1, img2, *args, **kwargs)
        ctx = getattr(rec.ctx, "flow", None)
        which = getattr(rec.ctx, "which", None)
        if ctx is None or which is None or ctx[which][0] is None:
            return out
        if rec.counting:
            rec.raft_calls += 1
        slam = ctx["slam"]
        fi, fj = ctx[which]
        exact = world.flow(slam, fi, fj)
        if which == "program" and fi in rec.capture_fids and fi not in rec.flows:
            rec.flows[fi] = (img1.detach().clone(), img2.detach().clone(), out.detach().clone(),
                             exact)
        return exact

    raft_mod.raft_flow = oracle
    return raft_flow


def flow_wrappers(program, estimator, rec: Window):
    """The installed flow-error program and flow estimator, each naming the
    frame pair its RAFT call is of, the program also recording its inputs
    and its error map at the sampled frames."""
    def recorded_program(img_i, img_j, T_WCi, T_WCj, depth_i, K, overlap_cb=None):
        rec.ctx.which = "program"
        try:
            err = program(img_i, img_j, T_WCi, T_WCj, depth_i, K, overlap_cb=overlap_cb)
        finally:
            rec.ctx.which = None
        ctx = getattr(rec.ctx, "flow", None)
        fid = ctx["program"][0] if ctx is not None else None
        if fid in rec.capture_fids and fid not in rec.masks:
            rec.masks[fid] = dict(T_WCi=torch.as_tensor(T_WCi).detach().clone().reshape(8),
                                  T_WCj=torch.as_tensor(T_WCj).detach().clone().reshape(8),
                                  depth=torch.as_tensor(depth_i).detach().clone(),
                                  K=torch.as_tensor(K).detach().clone(), err=np.array(err))
        return err

    def recorded_estimator(img_i, img_j):
        rec.ctx.which = "propagate"
        try:
            return estimator(img_i, img_j)
        finally:
            rec.ctx.which = None

    return recorded_program, recorded_estimator


def wrap_sam2(sam2_mod, world: World, rec: Window):
    """SAM2's encode (its input kept for the checks), its decode (its
    logits and IoUs kept) and its selection, whose mask for each prompted
    row is replaced by the frame's exact object mask at the selection's
    resolution with an IoU of 1; returns a function that restores all
    three."""
    encode, decode, select = sam2_mod.sam2_encode, sam2_mod._decode, sam2_mod.sam2_decode_select

    def rec_encode(params, cfg, img):
        rec.sam2_img = img
        return encode(params, cfg, img)

    def rec_decode(*args, **kwargs):
        rec.sam2_out = decode(*args, **kwargs)
        return rec.sam2_out

    def oracle(params, cfg, img_emb, hr0, hr1, points01, labels):
        sel, iou = select(params, cfg, img_emb, hr0, hr1, points01, labels)
        ctx = getattr(rec.ctx, "flow", None)
        if ctx is None:
            return sel, iou
        if rec.counting:
            rec.sam2_calls += 1
        slam, fid = ctx["slam"], ctx["program"][0]
        pend = rec.sam2_pending
        if rec.capture_fids and pend and pend[0] <= fid:  # the window's first episode
            pend.pop(0)
            masks, ious, _ = rec.sam2_out
            rec.sam2.append((fid, rec.sam2_img.detach().clone(), points01.detach().clone(),
                             labels.detach().clone(), masks.detach().clone(),
                             ious.detach().clone(), sel.detach().clone()))
        h4, w4 = sel.shape[1:]
        exact = world.mask(slam, fid)
        # the frame pixel each cell of the selection's grid samples
        ys = ((torch.arange(h4, device=exact.device) + 0.5) * world.h / h4).long()
        xs = ((torch.arange(w4, device=exact.device) + 0.5) * world.w / w4).long()
        grid = exact[ys][:, xs]
        prompted = (labels == 1).any(1)
        sel = torch.where(prompted[:, None, None], grid[None], sel)
        return sel, torch.where(prompted, torch.ones_like(iou), iou)

    sam2_mod.sam2_encode, sam2_mod._decode, sam2_mod.sam2_decode_select = (rec_encode, rec_decode,
                                                                          oracle)

    def restore():
        sam2_mod.sam2_encode, sam2_mod._decode, sam2_mod.sam2_decode_select = (encode, decode,
                                                                              select)
    return restore


def run(cell) -> dict:
    from monst3r_slam_torch.app.config import load_config
    from monst3r_slam_torch.app.pipeline import SLAMSystem
    from monst3r_slam_torch.dynamic import mask as dyn_mask
    from monst3r_slam_torch.dynamic import raft as raft_mod
    from monst3r_slam_torch.dynamic import sam2 as sam2_mod
    from monst3r_slam_torch.dynamic.inference import DualParams
    from monst3r_slam_torch.models import mast3r as mast3r_mod
    from monst3r_slam_torch.native.build import solver_available
    from monst3r_slam_torch.ops import build, matching_tiled
    from monst3r_slam_torch.slam import retrieval
    from monst3r_slam_torch.slam import tracker as tracker_mod

    cell.phase("import")
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    if dev == "cuda":
        build.build()
    solver_available()
    cell.phase("build")

    mcfg_d = dict(cfg, **cfg["mast3r"])
    monst3r = weights.make_params(cfg, cell.seed, dev, served=True)
    mast3r = weights.make_params(mcfg_d, cell.seed + 1, dev, served=True)
    rc, sc = cfg["raft"], cfg["sam2"]
    rparams = weights_dynamic.raft_params(rc, cell.seed + 2, dev)
    sparams = weights_dynamic.sam2_params(sc, cell.seed + 3, dev)
    common.sync(dev)
    cell.phase("weights")

    rng = np.random.default_rng(cell.seed)
    h, w = cfg["img_size"]
    focal = tr["focal_scale"] * w
    n_frames, starts = tr["episode_frames"], [int(s) for s in tr["episode_starts"]]
    obj = tr["object"]
    gts = [scene.trajectory(s, n_frames, tr["step"]) for s in starts]
    frames = [scene_dynamic.render_images(
        torch.from_numpy(g).to(dev), torch.arange(s, s + n_frames, device=dev).float(), obj, h, w,
        focal) for g, s in zip(gts, starts)]
    desc_dim = cfg["mast3r"]["desc_dim"]
    rff = scene.make_rff(desc_dim, tr["rff_scale"],
                         torch.Generator(device=dev).manual_seed(tr["rff_seed"]))
    rff_obj = scene.make_rff(desc_dim, tr["rff_scale"],
                             torch.Generator(device=dev).manual_seed(tr["object_rff_seed"]))
    world = World(starts, obj, rff, rff_obj, h, w, focal)
    order = [int(e) for e in rng.permutation(len(gts))]
    lo, hi = tr["check_frame_range"]
    check_fids = {int(f) for f in rng.choice(np.arange(lo, hi), tr["check_frames"], replace=False)}
    slam_cfg = load_config(tr["slam_config"], set_global=False)
    for key, val in tr.get("slam_overrides", {}).items():
        slam_cfg[key] = {**slam_cfg.get(key, {}), **val} if isinstance(val, dict) else val
    slam_cfg.setdefault("use_dynamic_mask", True)  # as main_monster_torch.py
    mk = cfg["mask"]
    if (float(slam_cfg.get("dynamic_mask_threshold", 0.35)) != mk["threshold"]
            or bool(slam_cfg.get("temporal_mask_propagation", True)) != mk["temporal_propagation"]
            or not slam_cfg.get("refine_dynamic_mask_with_sam2", False)):
        raise ValueError("the SLAM config's dynamic mask is not the configuration's")
    mon_cfg, mas_cfg = common.model_config(cfg), common.model_config(mcfg_d)
    dual = DualParams(monst3r, mon_cfg, mast3r, mas_cfg)
    K = scene_dynamic.intrinsics(h, w, focal, dev)
    retr = retrieval.init_retrieval_params(
        torch.Generator().manual_seed(int(rng.integers(2**62))), mon_cfg.enc_dim, device=dev)
    rec = Window()
    Oracle = oracle_class(SLAMSystem, rec)

    def new_system():
        return Oracle(params=mast3r, model_cfg=mas_cfg, cfg=dict(slam_cfg), img_size=(h, w), K=K,
                      device=dev, dual=dual, retrieval_params=retr,
                      retrieval_db=retrieval.ASMKDatabase.from_config(slam_cfg))

    # the install of main_monster_torch.py (install_flow, install_sam2), the
    # flow recorded and named for the oracle
    rcfg = raft_mod.RAFTConfig(hidden_dim=rc["hidden_dim"], context_dim=rc["context_dim"],
                               corr_levels=rc["corr_levels"], corr_radius=rc["corr_radius"],
                               iters=rc["iters"])
    scfg = sam2_mod.SAM2Config(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in sc.items() if k in sam2_mod.SAM2Config._fields})
    program, estimator = flow_wrappers(raft_mod.make_fused_flow_error_program(rparams, rcfg),
                                       raft_mod.make_raft_flow_estimator(rparams, rcfg), rec)
    dyn_mask.set_flow_estimator(estimator)
    dyn_mask.set_flow_error_program(program)
    dyn_mask.set_mask_refiner(sam2_mod.Sam2Refiner(sparams, scfg, max_objects=sc["max_objects"],
                                                   iou_floor=sc["iou_floor"]))
    restore_decode = wrap_decode(mast3r_mod, mast3r_mod.PairOutput, world, rec)
    restore_raft = wrap_raft(raft_mod, world, rec)
    restore_sam2 = wrap_sam2(sam2_mod, world, rec)
    restore_mask = dyn_mask.apply_dynamic_mask_native
    if cell.control.get("fault") == "unmasked":  # planted: the mask never reaches C, D, Q
        dyn_mask.apply_dynamic_mask_native = lambda C, D, Q, m: (C, D, Q)
    common.sync(dev)
    cell.phase("traffic")

    tracer = SpanTracer(cell.trace)
    restore_match = restore_track = feed = None
    try:
        warm = slam_oracle.Feed(new_system, gts, frames, order[:1], rec, set())
        for _ in range(tr["warmup_frames"]):
            warm.frame()
        warm.close()
        common.sync(dev)
        cell.phase("warmup")
        setup_s = cell.setup_done()

        restore_match = slam_oracle.wrap_tile_match(matching_tiled, rec,
                                                    cell.control.get("matcher"))
        restore_track = slam_oracle.wrap_track_pose(tracker_mod, rec)
        rec.sam2_pending = sorted(check_fids)
        feed = slam_oracle.Feed(new_system, gts, frames, order, rec, check_fids)
        wall_ms = []
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
        counted = dict(encodes=rec.encodes, rows=dict(rec.rows), raft_calls=rec.raft_calls,
                       sam2_calls=rec.sam2_calls)
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
        if restore_match is not None:
            matching_tiled.tile_match = restore_match
        if restore_track is not None:
            tracker_mod.track_pose = restore_track
        if feed is not None:
            feed.close()
        mast3r_mod.decode = restore_decode
        raft_mod.raft_flow = restore_raft
        restore_sam2()
        dyn_mask.apply_dynamic_mask_native = restore_mask
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
        dyn_mask.set_mask_refiner(None)
    del monst3r, mast3r, dual
    if dev == "cuda":
        torch.cuda.empty_cache()

    checks = check(cell, rec, done, gts, frames, world, check_fids)
    frames_done = len(wall_ms)
    rec.slam = None
    print(f"dynamic slam window: {frames_done} frames in {window_s:.3f} s, {len(done)} episodes "
          f"completed, {lost} frames lost, episode ATE % {checks.pop('episodes')}, checked frames "
          f"{sorted(check_fids)}: decodes {sorted(rec.decodes)} flows {sorted(rec.flows)} masks "
          f"{sorted(rec.used)} sam2 {[s[0] for s in rec.sam2]} matches {sorted(rec.matches)}",
          flush=True)
    return dict(setup_s=setup_s, window_s=window_s, frames=frames_done, frame_wall_ms=wall_ms,
                episodes=done, backend_job_ms=backend_ms, gn_iters=rec.gn_iters,
                counted=counted, img_size=(h, w), config=cfg, traced_matches=rec.traced_matches,
                trace=tracer.summary, launched=tracer.launched, traced_frames=tr["trace_frames"],
                attempted=frames_done, failed=lost, checks=checks, memory_peak_bytes=peak,
                device_kind=common.device_kind(dev))


def check(cell, rec: Window, done, gts, frames, world: World, check_fids) -> dict:
    """The compared numbers (module docstring); every input the reference
    reads is made again from the seed or taken from the window's record."""
    from benchmark.reference import ate, dynamic_mask, matcher, model, tracker
    from benchmark.reference import raft as ref_raft
    from benchmark.reference import sam2 as ref_sam2

    cfg, dev, ctl = cell.config, cell.device, cell.control
    mcfg_d = dict(cfg, **cfg["mast3r"])
    cfgs = {"monst3r": cfg, "mast3r": mcfg_d}
    out = {}
    inf = float("inf")
    errs = []
    with torch.no_grad(), model.exact_f32():
        pm = weights.make_params(cfg, cell.seed, dev, served=True)
        pa = weights.make_params(mcfg_d, cell.seed + 1, dev, served=True)
        params = {"monst3r": pm, "mast3r": pa}
        h, w = cfg["img_size"]
        n_h, n_w = h // cfg["patch_size"], w // cfg["patch_size"]

        def dual(img_i, img_j, P=model.F32):
            f1, p1 = model.encode(pm, cfg, img_i, P)
            f2, p2 = model.encode(pm, cfg, img_j, P)
            res = {}
            for name in MODELS:
                hk1, hk2 = model.decode(params[name], cfgs[name], f1, p1, f2, p2, P)
                o1 = model.head(params[name]["head1"], cfgs[name], hk1, n_h, n_w, P)
                o2 = model.head(params[name]["head2"], cfgs[name], hk2, n_h, n_w, P)
                res[name] = {k: v for k, v in dict(
                    X1=o1["pts3d"], C1=o1["conf"], D1=o1.get("desc"), Q1=o1.get("desc_conf"),
                    X2=o2["pts3d"], C2=o2["conf"], D2=o2.get("desc"),
                    Q2=o2.get("desc_conf")).items() if v is not None}
            return res

        for fid, (e, kf_fid, got) in sorted(rec.decodes.items()):
            imgs = frames[e][1]
            ref = dual(imgs[fid:fid + 1], imgs[kf_fid:kf_fid + 1])
            if "decode" in ctl:  # the reference in the program's place
                got = dual(imgs[fid:fid + 1], imgs[kf_fid:kf_fid + 1],
                           model.Precision(ctl["decode"]))
            for name in MODELS:
                if name in got:
                    errs.append(model.rel_errors(got[name], ref[name]))
                else:
                    errs.append({"missing": (inf, inf)})
        del pm, pa, params
    out["decode_rel_rms"] = common.finite(max((e[0] for r in errs for e in r.values()),
                                              default=inf))
    out["decode_rel_max"] = common.finite(max((e[1] for r in errs for e in r.values()),
                                              default=inf))

    rc, sc = cfg["raft"], cfg["sam2"]
    low = {"bf16": ref_raft.bf16}
    with torch.no_grad(), model.exact_f32():
        rparams = weights_dynamic.raft_params(rc, cell.seed + 2, dev)
        fl = []
        for fid, (img1, img2, got, _) in sorted(rec.flows.items()):
            ref = ref_raft.flow(rparams, rc, img1, img2)
            if "raft" in ctl:
                got = ref_raft.flow(rparams, rc, img1, img2, low[ctl["raft"]])
            fl.append(ref_raft.rel_rms(got, ref))
        out["flow_rel_rms"] = common.finite(max(fl, default=inf))
        del rparams

        thr = cfg["mask"]["threshold"]
        flips = []
        for fid, m in sorted(rec.masks.items()):
            flow = rec.flows[fid][3] if fid in rec.flows else None
            if flow is None:
                flips.append(inf)
                continue
            args = (flow, m["T_WCi"], m["T_WCj"], m["depth"], m["K"])
            ref = dynamic_mask.coarse(*args)
            got = torch.from_numpy(m["err"]).to(ref.device)
            if "mask" in ctl:
                got = dynamic_mask.coarse(*args, P=low[ctl["mask"]])
            flips.append(dynamic_mask.flip_share(got, ref, thr))
        out["mask_flip"] = common.finite(max(flips, default=inf))

        sparams = weights_dynamic.sam2_params(sc, cell.seed + 3, dev)
        rel, sflip = [], []
        for fid, img, pts, lbs, logits, iou, sel in rec.sam2:
            r_logits, r_iou = ref_sam2.decode(sparams, sc, *ref_sam2.encode(sparams, sc, img),
                                              pts, lbs)
            if "sam2" in ctl:
                P = low[ctl["sam2"]]
                logits, iou = ref_sam2.decode(sparams, sc, *ref_sam2.encode(sparams, sc, img, P),
                                              pts, lbs, P)
                sel = ref_sam2.select(logits, iou)[0]
            r_sel = ref_sam2.select(r_logits, r_iou)[0]
            rel.append(max(float((logits - r_logits).abs().max() / r_logits.abs().max()),
                           float((iou - r_iou).abs().max() / r_iou.abs().max())))
            sflip.append(float((sel != r_sel).float().mean()))
        out["sam2_rel_max"] = common.finite(max(rel, default=inf))
        out["sam2_flip"] = common.finite(max(sflip, default=inf))
        del sparams

    merr = []
    for fid in sorted(check_fids):
        if fid not in rec.used:
            merr.append(inf)
            continue
        e = rec.decodes[fid][0] if fid in rec.decodes else None
        if e is None:
            merr.append(inf)
            continue
        T = torch.from_numpy(gts[e][fid]).to(dev)
        idx = torch.tensor(float(world.starts[e] + fid), device=dev)
        exact = scene_dynamic.object_mask(T, idx, world.obj, world.h, world.w, world.f)
        merr.append(float((rec.used[fid].to(exact.device) != exact).float().mean()))
    out["mask_err"] = common.finite(max(merr, default=inf))

    gaps = []
    with torch.no_grad():
        for fid, (args, (crop, window), conv_thresh, got) in sorted(rec.matches.items()):
            gaps.append(matcher.match_gap(*args, crop, window, conv_thresh, got))
    out["match_gap"] = common.finite(max(gaps, default=inf))
    tgaps = []
    for fid, (args, got) in sorted(rec.tracks.items()):
        if args["use_calib"]:
            raise ValueError("the reference tracker solves the uncalibrated residual only")
        M_ref, _ = tracker.track(args)
        if "tracker" in ctl:
            M_ctl, _ = tracker.track(args, getattr(torch, ctl["tracker"]))
            tgaps.append(float((M_ctl - M_ref)[:3].abs().max()))
        else:
            tgaps.append(tracker.pose_gap(got, M_ref))
    out["track_gap"] = common.finite(max(tgaps, default=inf))
    out["episodes"] = [(e, round(ate.episode_pct(p[:, :3], g[:, :3]), 6)) for p, g, e in done]
    return out
