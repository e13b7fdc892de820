"""Chunked (burst) tracking: C frames per dispatch, one host read per
event-free chunk.

Port of the JAX package's `app/chunked.py`. The per-frame pipeline reads
one decision vector back per frame; chunked tracking reads the (C, 12)
decision matrix back once per chunk:

  * one upload per chunk: a (C, h, w, 3) uint8 batch, normalized on the
    device bit for bit as `data/preprocess.py` normalizes on the host (or a
    batch already normalized);
  * one dispatch per chunk: for each frame, encode -> decode against the
    current keyframe -> the tiled matcher (kernel B on the card) -> fusion
    -> Gauss-Newton -> keyframe update (`pipeline._track_update_body`), all
    enqueued with no host read between frames. The reference's `lax.scan`
    is a Python loop here, and its `fori_loop`-style GN without a host read
    is the tracker's masked loop of `max_iters` steps (`fixed_iters`);
  * one read per chunk: the decision matrix.

A `done` flag on the device freezes every state update (`torch.where`, never
a host `if`) from the first frame whose decision the host must act on (a new
keyframe, lost tracking, a failed solve); that frame's own update stands, as
in the per-frame path. The host reads the decisions, acts on the event
(keyframe append and backend step, or relocalization through the per-frame
path) and dispatches again from the next frame (`k0`). Each frame is
therefore tracked against the keyframe, and the keyframe state, it sees in
the per-frame path with `defer_tracking_sync: 0`: chunking changes when the
host learns a decision, never what is decided. Encoder features do not
depend on the keyframe, so a re-dispatch reuses the frames' features.

Two places where the port follows its own per-frame path and not JAX's
chunked one, so that the two paths decide and pose alike: after a keyframe
event in synchronous mode the solved pose of the new keyframe is read back
(JAX's chunked path keeps the tracked one), and the tracking decode of the
event frame is handed to the backend as the consecutive edge's j->i
direction, as the per-frame path hands it.

INIT and RELOC frames fall back to the per-frame path. Async-backend pose
write-backs apply at chunk boundaries (the per-frame path applies them
between frames).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from monst3r_slam_torch.models import mast3r as model_api
from monst3r_slam_torch.ops import matching_tiled
from monst3r_slam_torch.slam.frame import Frame, Mode

# Decision-matrix columns: pipeline._track_update_body's summary, plus the
# chunk's `active` column (0 for a frame before k0 or frozen by an event).
COL_T = slice(0, 8)
COL_LOW_MATCH = 8
COL_SOLVER_FAILED = 9
COL_NEW_KF = 10
COL_ACTIVE = 11


def _normalized(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> (x / 255 - 0.5) / 0.5 in f32, bit for bit data/preprocess.py's
    host formula. The divisors are device tensors: CUDA divides by a host
    scalar as a product with its reciprocal, which can differ in the last bit."""
    if img.dtype != torch.uint8:
        return img
    x = img.to(torch.float32)
    return (x / x.new_full((), 255.0) - 0.5) / x.new_full((), 0.5)


@torch.no_grad()
def chunk_track(
    params,
    mem_X, mem_C, mem_N, mem_S,  # keyframe memory; the tracking row is updated in place
    kf_idx: int,
    kf_feat,  # (1, n, enc_dim) keyframe encoder features
    kf_pos,  # (1, n, 2)
    kf_T_WC,  # (8,)
    imgs,  # (C, h, w, 3) uint8 or normalized f32
    T0,  # (8,) pose of the last resolved frame
    idx0,  # (1, hw) or (hw,) matcher warm start, or None
    k0: int,  # frames before k0 are done
    K,  # (3, 3) or None
    hook_xs=None,  # per-frame values for decode_hook (leading dim C)
    *,
    model_cfg,
    track_cfg,
    img_size,
    use_calib: bool,
    fmode: str,
    fscore: str,
    mcfg,
    tcfg,
    use_kernel: bool,
    dtype=torch.bfloat16,
    feats: Optional[list] = None,
    decode_hook=None,
):
    """Enqueue frames k0..C-1 through the whole tracking chain with no host
    read. `feats` (a list of C, None where not encoded yet) caches the
    frames' encoder features across re-dispatches of one chunk.
    `decode_hook(out: PairOutput, hook_x) -> PairOutput` lets a test
    replace each frame's decode outputs.

    Returns dict(T_last (8,), idx_last (1, hw) or None, summaries (C, 12),
    ys_T (C, 8), ys_feat (C, n, enc_dim), ys_fX (C, hw, 3), ys_fC (C, hw, 1),
    ys_fN (C,), ys_fS (C,), pairs: each frame's (decode, idx, valid) or None)."""
    from monst3r_slam_torch.app.pipeline import _track_update_body

    h, w = img_size
    hw = h * w
    n_frames = imgs.shape[0]
    dev = mem_X.device
    feats = [None] * n_frames if feats is None else feats
    zeros = dict(fX=torch.zeros((hw, 3), device=dev), fC=torch.zeros((hw, 1), device=dev),
                 fN=torch.zeros((), dtype=torch.int32, device=dev),
                 fS=torch.zeros((), device=dev))
    n_patches = hw // model_cfg.patch_size**2
    rows = {k: [] for k in ("summary", "T", "feat", "fX", "fC", "fN", "fS")}
    pairs: list = [None] * n_frames
    for i in range(k0):  # done before this dispatch: zero rows
        rows["summary"].append(torch.zeros((12,), device=dev))
        rows["T"].append(torch.zeros((8,), device=dev))
        rows["feat"].append(torch.zeros((n_patches, model_cfg.enc_dim), device=dev))
        for k in ("fX", "fC", "fN", "fS"):
            rows[k].append(zeros[k])

    T = T0
    idx = None if idx0 is None else idx0.reshape(1, hw)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(k0, n_frames):
        if feats[i] is None:
            feats[i] = model_api.encode(params, model_cfg, _normalized(imgs[i : i + 1]), dtype)
        feat, pos = feats[i]
        out = model_api.decode(params, model_cfg, feat, pos, kf_feat, kf_pos, img_size, dtype)
        if decode_hook is not None:
            out = decode_hook(out, hook_xs[i])
        use_init = idx is not None  # known on the host: only the first frame can be cold
        idx_new, valid = matching_tiled.match_tiled(
            out.X1.reshape(1, h, w, 3), out.X2.reshape(1, h, w, 3),
            out.D1.reshape(1, h, w, -1), out.D2.reshape(1, h, w, -1),
            idx, cfg=mcfg, tcfg=tcfg, use_init=use_init, use_kernel=use_kernel,
        )
        fX, fC, fN, fS, res, summary = _track_update_body(
            mem_X, mem_C, mem_N, mem_S, kf_idx, idx_new[0], valid[0],
            out.X1.reshape(hw, 3), out.C1.reshape(hw, 1), out.Q1.reshape(hw, 1),
            out.X2.reshape(hw, 3), out.C2.reshape(hw, 1), out.Q2.reshape(hw, 1),
            zeros["fX"], zeros["fC"], zeros["fN"], zeros["fS"],
            T, kf_T_WC, track_cfg, img_size, fmode, fscore, K=K, use_calib=use_calib,
            frozen=done,
        )
        active = ~done
        T = torch.where(done, T, res.T_WCf)
        idx = idx_new if idx is None else torch.where(done, idx, idx_new)
        done = done | res.new_kf | res.low_match | res.solver_failed
        rows["summary"].append(torch.cat([summary, active.float()[None]]))
        rows["T"].append(res.T_WCf)
        rows["feat"].append(feat[0])
        for k, v in (("fX", fX), ("fC", fC), ("fN", fN), ("fS", fS)):
            rows[k].append(v)
        pairs[i] = (out, idx_new, valid)
    ys = {k: torch.stack(v) for k, v in rows.items()}
    return dict(T_last=T, idx_last=idx, summaries=ys["summary"], ys_T=ys["T"],
                ys_feat=ys["feat"], ys_fX=ys["fX"], ys_fC=ys["fC"], ys_fN=ys["fN"],
                ys_fS=ys["fS"], pairs=pairs)


def _gather_chunk_frame(ys_T, ys_feat, ys_fX, ys_fC, ys_fN, ys_fS, i: int):
    """Frame i's (T, feat (1, n, d), fX, fC, fN, fS) out of the chunk outputs."""
    return ys_T[i], ys_feat[i][None], ys_fX[i], ys_fC[i], ys_fN[i], ys_fS[i]


def _norm_slice(imgs: torch.Tensor, i: int) -> torch.Tensor:
    """Frame i of a chunk as a (1, h, w, 3) normalized f32 image (the
    per-frame fallback's input: INIT and RELOC frames)."""
    return _normalized(imgs[i : i + 1])


def process_chunk(
    slam,
    frame_ids: List[int],
    timestamps: List,
    imgs_dev: torch.Tensor,  # (C, h, w, 3) uint8 or normalized f32, on the system's device
    uimgs: Optional[List[Optional[np.ndarray]]] = None,
    hook_xs=None,
    decode_hook=None,
) -> bool:
    """Track C frames through `chunk_track`, resolving decisions at event
    boundaries; the decisions of `SLAMSystem.process_frame` with
    `defer_tracking_sync: 0` and `force_kf=None`. Returns False when the
    viewer asked to terminate. Plain MASt3R pipeline with the tiled matcher
    only (`SLAMSystem.supports_chunking`)."""
    C = int(imgs_dev.shape[0])
    prof = slam.prof
    slam._consume_viewer_control()
    if slam.terminate_requested:
        return False
    slam._resolve_pending()  # the per-frame fallback may have left deferred work
    feats: list = [None] * C
    k0 = 0
    while k0 < C:
        if slam.mode != Mode.TRACKING:  # INIT / RELOC: the per-frame path, resolved at once
            slam.process_frame(frame_ids[k0], timestamps[k0], _norm_slice(imgs_dev, k0),
                               uimg=uimgs[k0] if uimgs is not None else None)
            slam._resolve_pending()
            k0 += 1
            continue

        t0 = time.perf_counter()
        slam._apply_backend_results()
        kf_idx = slam.n_kf - 1
        kf_feat, kf_pos, kf_T_WC = slam._kf_view(kf_idx)
        outs = chunk_track(
            slam.params, slam.mem.X_canon, slam.mem.C, slam.mem.N, slam.mem.score,
            kf_idx, kf_feat, kf_pos, kf_T_WC, imgs_dev, slam._last_T_WC_dev, slam.idx_f2k, k0,
            slam.K, hook_xs,
            model_cfg=slam.model_cfg, track_cfg=slam.track_cfg, img_size=slam.img_size,
            use_calib=slam.use_calib, fmode=slam.filtering_mode,
            fscore=slam.track_cfg.filtering_score, mcfg=slam.match_cfg, tcfg=slam.match_tcfg,
            use_kernel=slam.match_mode == "kernel", dtype=slam.dtype, feats=feats,
            decode_hook=decode_hook,
        )
        t1 = time.perf_counter()
        prof.setdefault("chunk_dispatch", []).append((t1 - t0) * 1e3)
        sv = outs["summaries"].cpu().numpy()  # the one host read of this dispatch
        prof.setdefault("chunk_sync", []).append((time.perf_counter() - t1) * 1e3)

        event = None
        for i in range(k0, C):
            if sv[i, COL_ACTIVE] < 0.5:
                break  # frozen by an earlier event
            fid = frame_ids[i]
            slam.timestamps.append(timestamps[i])
            slam.last_summary = sv[i, :COL_ACTIVE]
            if sv[i, COL_LOW_MATCH] > 0.5 or sv[i, COL_SOLVER_FAILED] > 0.5:
                slam.mode = Mode.RELOC
                slam.idx_f2k = None
                if slam._mask_propagator is not None:
                    slam._mask_propagator.reset()
                slam._record_pose(fid, slam.last_T_WC)
                # earlier frames of the chunk moved the pose: the device copy
                # follows the host's (same f32 values)
                slam._last_T_WC_dev = torch.as_tensor(slam.last_T_WC, device=slam.device)
                k0, event = i + 1, "reloc"
                break
            slam.last_T_WC = sv[i, COL_T]
            if sv[i, COL_NEW_KF] > 0.5:
                tk = time.perf_counter()
                T_i, feat_i, fX_i, fC_i, fN_i, fS_i = _gather_chunk_frame(
                    outs["ys_T"], outs["ys_feat"], outs["ys_fX"], outs["ys_fC"], outs["ys_fN"],
                    outs["ys_fS"], i)
                frame = Frame(frame_id=fid, T_WC=T_i, X_canon=fX_i, C=fC_i, N=fN_i,
                              feat=feat_i, pos=kf_pos, score=fS_i)
                slam.idx_f2k = None
                slam._last_T_WC_dev = T_i
                new_idx = slam._append_keyframe(frame)
                slam._set_kf_uimg(new_idx, uimgs[i] if uimgs is not None else None)
                out, idx_i, valid_i = outs["pairs"][i]
                slam.backend_step(new_idx, frame, track_cache=dict(
                    kf_idx=kf_idx, out=out, idx=idx_i, valid=valid_i))
                if slam.single_thread:  # the synchronous solve moved this pose: read it back
                    slam._last_T_WC_dev = slam.mem.T_WC[new_idx].clone()
                    slam.last_T_WC = slam._last_T_WC_dev.cpu().numpy()
                prof.setdefault("kf_event", []).append((time.perf_counter() - tk) * 1e3)
                slam._record_pose(fid, slam.last_T_WC)
                k0, event = i + 1, "kf"
                break
            slam._record_pose(fid, slam.last_T_WC)
        if event is None:
            k0 = C
            slam.idx_f2k = outs["idx_last"]
            slam._last_T_WC_dev = outs["T_last"]
    slam._maybe_push_viewer()
    return not slam.terminate_requested


class ChunkPrefetcher:
    """Batch dataset frames into uint8 chunks and upload them ahead of the
    consumer (the chunked counterpart of data.prefetch.FramePrefetcher).

    Yields (frame_ids, timestamps, imgs_dev (C, h, w, 3) uint8, uimgs); the
    last chunk is short when the range is not a multiple of `chunk`. The
    upload runs on the worker thread, so chunk t+1's copy to the device
    overlaps chunk t's work."""

    _SENTINEL = object()

    def __init__(self, dataset, preprocess, chunk: int, lo: int = 0, hi: Optional[int] = None,
                 depth: int = 2, device="cuda"):
        self.dataset = dataset
        self.preprocess = preprocess
        self.chunk = int(chunk)
        self.lo = lo
        self.hi = len(dataset) if hi is None else hi
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, name="chunk-prefetch", daemon=True)

    def _work(self):
        try:
            for c0 in range(self.lo, self.hi, self.chunk):
                ids, tss, uimgs = [], [], []
                for i in range(c0, min(c0 + self.chunk, self.hi)):
                    if self._stop.is_set():
                        return
                    try:
                        timestamp, img = self.dataset[i]
                        out = self.preprocess(img)
                    except BaseException as e:
                        self._put((i, None, e, None))
                        return
                    ids.append(i)
                    tss.append(timestamp)
                    # the uint8 image the normalization derives from: a
                    # quarter of the f32 bytes, normalized on the device
                    uimgs.append(out["unnormalized_img"])
                if not ids:
                    continue
                if self._stop.is_set():
                    return
                imgs_dev = torch.from_numpy(np.stack(uimgs)).to(self.device)
                self._put((ids, tss, imgs_dev, uimgs))
        finally:
            self._put(self._SENTINEL)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue
        if item is self._SENTINEL:
            while True:
                try:
                    self._q.put_nowait(item)
                    return
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def __iter__(self):
        self._thread.start()
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if len(item) == 4 and isinstance(item[2], BaseException):
                raise RuntimeError(f"chunk prefetch failed at frame {item[0]}") from item[2]
            yield item

    def stop(self):
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
