"""The port's recorder of spans and counters (`monst3r_slam_torch/utils/
timing.py`) and the spans and counters the program records, on the CPU:

* a span and torch.profiler's events share one clock;
* parents, request ids and self time of nested spans, on two threads, and
  the buffer under many threads at once;
* switched off, it records nothing;
* a TINY `SLAMSystem` with the backend worker (frames of 64x80): each
  tracked `frame` holds `encode`, `decode` and `match_track`, the counters
  equal what the run did, and `prof` is filled from the spans;
* the TINY training step: `forward`, `backward` and `optimizer` under
  `train_step`;
* the TINY dual pipeline with RAFT's program and SAM2's refiner: each
  masked frame's two decodes and flow program asked for device time, the
  `sam2` span of each SAM2 decode, the `sam2.*` and `dyn.mask_px` counters;
* `profile_trace` writes the region's program spans into its `trace.json`.
"""

import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from monst3r_slam_torch.app.config import load_config
from monst3r_slam_torch.app.pipeline import SLAMSystem
from monst3r_slam_torch.dynamic import mask as dyn_mask
from monst3r_slam_torch.dynamic import raft as raft_mod
from monst3r_slam_torch.dynamic import sam2 as sam2_mod
from monst3r_slam_torch.dynamic.inference import DualParams
from monst3r_slam_torch.models.config import TINY
from monst3r_slam_torch.models.init import init_params
from monst3r_slam_torch.slam import retrieval
from monst3r_slam_torch.slam import tracker as tracker_mod
from monst3r_slam_torch.train import step as tstep
from monst3r_slam_torch.utils import timing


@pytest.fixture(autouse=True)
def fresh_store():
    """An empty buffer, recording on, and torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.reset()
    try:
        yield
    finally:
        timing.enabled = True
        timing.reset()
        torch.set_num_threads(threads)


def test_spans_share_the_profilers_clock():
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("mm") as s:
            a @ a
    mm = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert len(mm) == 1
    assert s.t0 <= mm[0].start_ns() <= mm[0].end_ns() <= s.t1
    assert abs(timing.now_ns() - time.time_ns()) < 5_000_000


def test_nested_spans_parents_ids_and_self_time():
    def worker():
        with timing.span("job", rid=9):
            timing.count("rows", 3)
            with timing.span("solve"):
                time.sleep(0.001)

    with timing.span("frame", rid=7) as frame:
        with timing.span("encode") as encode:
            time.sleep(0.002)
        timing.count("encodes")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with timing.span("resolve", rid=6) as resolve:
            with timing.span("wait") as wait:
                pass
    rows = {s.name: s for s in timing.spans()}
    assert set(rows) == {"frame", "encode", "resolve", "wait", "job", "solve"}
    assert frame.parent is None and rows["job"].parent is None
    assert encode.parent == frame.sid and resolve.parent == frame.sid
    assert wait.parent == resolve.sid and rows["solve"].parent == rows["job"].sid
    assert (encode.rid, resolve.rid, wait.rid) == (7, 6, 6)  # the parent's unless given
    assert rows["solve"].rid == 9
    assert rows["job"].tid == rows["solve"].tid != frame.tid == threading.get_native_id()
    for s in rows.values():
        assert s.t0 <= s.t1 and s.device_ms is None
    own = timing.self_ns(list(rows.values()))
    assert own[frame.sid] == (frame.t1 - frame.t0) - (encode.t1 - encode.t0) - (
        resolve.t1 - resolve.t0)
    assert own[resolve.sid] == (resolve.t1 - resolve.t0) - (wait.t1 - wait.t0)
    assert own[encode.sid] == encode.t1 - encode.t0 >= 2_000_000
    c = {x.name: x for x in timing.counts()}
    assert (c["encodes"].n, c["encodes"].parent, c["encodes"].rid) == (1, frame.sid, 7)
    assert (c["rows"].n, c["rows"].parent, c["rows"].rid) == (3, rows["job"].sid, 9)
    text = timing.summary()
    for name in ("frame", "encode", "solve", "encodes", "rows"):
        assert name in text
    # start/stop: a span whose ends are not one block, logging its host ms
    log = []
    s = timing.span("flow", log=log).start()
    inner = timing.span("inner").start()
    s.stop()  # out of order: the stack drops it wherever it is
    inner.stop()
    s.stop()  # a second stop does nothing
    assert len(log) == 1 and log[0] == s.ms > 0 and inner.parent == s.sid
    with timing.span("after") as after:
        pass
    assert after.parent is None


def test_many_threads_lose_no_record():
    n_threads, n_spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(k):
            for i in range(n_spans):
                with timing.span("outer", rid=(k, i)):
                    with timing.span("inner"):
                        timing.count("n")

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rows = timing.spans()
    assert len(rows) == 2 * n_threads * n_spans
    assert sum(c.n for c in timing.counts("n")) == n_threads * n_spans
    by_sid = {s.sid: s for s in rows}
    assert len(by_sid) == len(rows)
    for s in rows:
        if s.name == "inner":
            p = by_sid[s.parent]
            assert p.name == "outer" and p.tid == s.tid and p.rid == s.rid
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
        else:
            assert s.parent is None


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(timing, "enabled", False)
    log = []
    a = timing.span("x", rid=1, log=log)
    b = timing.span("y", device=True)
    assert a is b
    with a as s:
        timing.count("c", 5)
    assert s.ms == 0.0 and s.device_ms is None and log == []
    assert timing.spans() == [] and timing.counts() == []
    state = _train_state()
    tstep.train_step(state, TINY, _batch())
    assert timing.spans() == [] and timing.counts() == []


H, W = 64, 80


def test_slam_frames_record_their_stages(monkeypatch):
    params = init_params(torch.Generator().manual_seed(0), TINY)
    params["dec_blocks2"], params["head2"] = params["dec_blocks"], params["head1"]
    cfg = chip_smoke.slice_config()  # base.yaml, descriptor gates open for random weights
    cfg["single_thread"] = False  # the backend on its worker, decisions 2 frames late
    cfg["local_opt"]["solver"] = "device"
    cfg["retrieval"].update(bootstrap_frames=1, n_words=8, min_thresh=0.0)
    rp = retrieval.init_retrieval_params(torch.Generator().manual_seed(1), TINY.enc_dim)
    slam = SLAMSystem(params=params, model_cfg=TINY, cfg=cfg, img_size=(H, W), kf_capacity=8,
                      device="cpu", dtype=torch.float32, retrieval_params=rp,
                      retrieval_db=retrieval.ASMKDatabase.from_config(cfg))
    iters = []
    track_pose = tracker_mod.track_pose

    def recorded(*args, **kwargs):
        res = track_pose(*args, **kwargs)
        iters.append(int(res.iters))
        return res

    monkeypatch.setattr(tracker_mod, "track_pose", recorded)
    img = chip_smoke.synthetic_frame(0, H, W)
    n = 6
    for i in range(n):
        slam.process_frame(i, i / 30.0, img, force_kf=i == 3)
    slam.finalize()
    assert slam.n_kf == 2 and slam.n_async_solves >= 1

    rows = timing.spans()
    main = threading.get_native_id()
    frames = [s for s in rows if s.name == "frame"]
    assert [f.rid for f in frames] == list(range(n)) and {f.tid for f in frames} == {main}
    tracked = [f for f in frames if any(s.name == "match_track" and s.parent == f.sid
                                        for s in rows)]
    assert [f.rid for f in tracked] == list(range(1, n))
    for f in tracked:
        kids = [s for s in rows if s.parent == f.sid]
        names = [s.name for s in kids]
        for stage in ("apply_backend", "encode", "decode", "match_track"):
            assert names.count(stage) == 1, names
        assert all(s.rid == f.rid for s in kids)
        order = [s.name for s in sorted(kids, key=lambda s: s.t0)]
        assert order.index("encode") < order.index("decode") < order.index("match_track")
    resolved = [s for s in rows if s.name == "resolve"]
    assert sorted(s.rid for s in resolved) == list(range(1, n))
    waits = [s for s in rows if s.name == "wait" and s.tid == main]
    # one summary read a resolved frame, one per GN stop test (none at max_iters)
    max_iters = slam.track_cfg.max_iters
    assert sum(1 for s in waits if s.parent in {r.sid for r in resolved}) == len(resolved)
    assert len([s for s in waits if s.rid in range(1, n)]) >= len(resolved) + sum(
        min(k, max_iters - 1) for k in iters)
    kf = [s for s in rows if s.name == "kf_event"]
    assert [s.rid for s in kf] == [3] and kf[0].parent in {r.sid for r in resolved}
    stalls = [s for s in rows if s.name == "backend_stall"]
    assert {s.tid for s in stalls} == {main}
    assert slam.backend_stall_s == pytest.approx(sum(s.ms for s in stalls) / 1e3)
    jobs = [s for s in rows if s.name == "backend_job"]
    assert [s.rid for s in jobs] == [3] and jobs[0].tid != main
    assert [s.name for s in rows if s.parent == jobs[0].sid].count("retrieval") == 1
    assert len([s for s in rows if s.name == "finalize"]) == 1

    counts = {}
    for c in timing.counts():
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert len(iters) == n - 1 and counts["track.gn_iters"] == sum(iters)
    assert counts["model.encodes"] == n
    # the INIT self-decode, one tracking decode a tracked frame, and the new
    # edge's i -> j row (its j -> i is frame 3's tracking decode, reused)
    assert counts["model.decode_rows"] == 1 + (n - 1) + 1

    for key, name in (("apply_backend", "apply_backend"), ("encode_dispatch", "encode"),
                      ("resolve_prev", "resolve_prev"), ("decode_dispatch", "decode"),
                      ("track_dispatch", "match_track"), ("kf_event", "kf_event"),
                      ("retrieval", "retrieval"), ("backend_job", "backend_job"),
                      ("backend_solve", "backend_solve")):
        spans = [s.ms for s in rows if s.name == name]
        assert sorted(slam.prof[key]) == sorted(spans) and spans, key
    assert slam.prof["backend_solve_iters"]


def _train_state():
    return tstep.init_train_state(init_params(torch.Generator().manual_seed(0), TINY),
                                  tstep.make_optimizer())


def _batch(b: int = 1, h: int = 32, w: int = 32) -> dict:
    g = torch.Generator().manual_seed(1)
    img1 = 0.5 * torch.randn((b, h, w, 3), generator=g)
    gt = torch.cat([torch.randn((b, h, w, 2), generator=g), 2.0 + torch.rand((b, h, w, 1),
                                                                           generator=g)], -1)
    one = torch.ones((b, h, w))
    return dict(img1=img1, img2=img1 + 0.05 * torch.randn((b, h, w, 3), generator=g),
                gt_X1=gt, gt_X2=gt.flip(1), valid1=one, valid2=one.clone())


def test_train_step_records_its_phases():
    state = _train_state()
    batch = _batch()
    for _ in range(2):
        state, loss = tstep.train_step(state, TINY, batch)
    assert torch.isfinite(loss)
    rows = timing.spans()
    steps = [s for s in rows if s.name == "train_step"]
    assert [s.rid for s in steps] == [0, 1]
    for step in steps:
        kids = sorted((s for s in rows if s.parent == step.sid), key=lambda s: s.t0)
        assert [s.name for s in kids] == ["forward", "backward", "optimizer"]
        assert all(s.rid == step.rid and s.device_ms is None for s in kids)  # the CPU
        assert step.t0 <= kids[0].t0 and kids[-1].t1 <= step.t1


def test_profile_trace_writes_the_program_spans(tmp_path):
    a = torch.randn(64, 64)
    with timing.profile_trace(tmp_path / "trace"):
        with timing.span("region", rid=3):
            with timing.span("inner"):
                a @ a
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    ev = doc["traceEvents"]
    ours = {e["name"]: e for e in ev if e.get("cat") == "program_span"}
    assert set(ours) == {"region", "inner"}
    region, inner = ours["region"], ours["inner"]
    assert region["args"]["rid"] == 3 and inner["args"]["parent"] == region["args"]["sid"]
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    assert len(mm) == 1
    # the op lies inside the spans on the trace's own time base
    for s in (region, inner):
        assert s["ts"] <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= s["ts"] + s["dur"] + 1
    assert region["tid"] != mm[0]["tid"] and region["pid"] == mm[0]["pid"]
    names = [e for e in ev if e.get("ph") == "M" and e.get("tid") == region["tid"]]
    assert names and "program spans" in names[0]["args"]["name"]


def test_masked_frames_record_device_spans_and_counters(monkeypatch):
    """The dual pipeline at TINY with the flow-error program (RAFT at 2
    iterations) and SAM2's refiner (SAM2_TEST) installed: each masked
    frame's `decode` holds one `decode_monst3r`, one `flow_program` and one
    `decode_mast3r`, each asked for device time (with `_on_cuda` set, the
    spans themselves kept on the host here), and one host `mask_refine`;
    each SAM2 decode lies in one `sam2` span under a `mask_refine`; the
    `sam2.*` counters add up to the refiner's own counts, and `dyn.mask_px`
    counts each masked frame's mask."""
    asked: dict = {}
    real_span = timing.span

    def spy(name, rid=None, device=False, log=None):
        asked.setdefault(name, []).append(device)
        return real_span(name, rid, False, log)

    monkeypatch.setattr(timing, "span", spy)
    rp = raft_mod.init_raft_params(torch.Generator().manual_seed(3))
    monkeypatch.setattr(dyn_mask, "_flow_error_program", (None, False))
    monkeypatch.setattr(dyn_mask, "_mask_refiner", None)
    dyn_mask.set_flow_error_program(raft_mod.make_fused_flow_error_program(
        rp, raft_mod.RAFTConfig(iters=2)))
    refiner = sam2_mod.Sam2Refiner(sam2_mod.init_sam2_params(torch.Generator().manual_seed(4),
                                                             sam2_mod.SAM2_TEST),
                                   sam2_mod.SAM2_TEST)
    dyn_mask.set_mask_refiner(refiner)
    selects = []
    select = sam2_mod.sam2_decode_select
    monkeypatch.setattr(sam2_mod, "sam2_decode_select",
                        lambda *a, **k: selects.append(1) or select(*a, **k))

    nodesc = dataclasses.replace(TINY, desc_dim=None, two_confs=False)
    mast3r = init_params(torch.Generator().manual_seed(0), TINY)
    monst3r = init_params(torch.Generator().manual_seed(1), nodesc)
    cfg = load_config("config/base.yaml", set_global=False)
    cfg.update(single_thread=True, parallel={"mesh": "off"}, use_dynamic_mask=True)
    cfg["tracking"].update(Q_conf=-1e9, C_conf=-1e9, min_match_frac=0.0)
    cfg["local_opt"].update(Q_conf=-1e9, min_match_frac=0.0, solver="device")
    K = torch.tensor([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1.0]])
    rpar = retrieval.init_retrieval_params(torch.Generator().manual_seed(2), TINY.enc_dim)
    slam = SLAMSystem(params=mast3r, model_cfg=TINY, cfg=cfg, img_size=(H, W), K=K,
                      kf_capacity=8, device="cpu", dtype=torch.float32, retrieval_params=rpar,
                      retrieval_db=retrieval.ASMKDatabase.from_config(cfg),
                      dual=DualParams(monst3r, nodesc, mast3r, TINY))
    slam._on_cuda = True  # ask for device spans; `spy` keeps them on the host
    for i in range(4):
        img = chip_smoke.synthetic_frame(0, H, W)
        img = np.roll(img, 2 * i, axis=1)
        uimg = np.uint8(np.clip((img + 1) / 2, 0, 1) * 255)
        slam.process_frame(i, i / 30.0, img, uimg=uimg)
    slam.finalize()

    rows = timing.spans()
    by_sid = {s.sid: s for s in rows}
    masked = [s for s in rows if s.name == "decode"
              and any(c.name == "decode_monst3r" and c.parent == s.sid for c in rows)]
    assert masked
    for d in masked:
        names = [c.name for c in rows if c.parent == d.sid]
        for stage in ("decode_monst3r", "flow_program", "decode_mast3r", "mask_refine"):
            assert names.count(stage) == 1, names
    for stage in ("decode_monst3r", "flow_program", "decode_mast3r"):
        assert asked[stage] == [True] * len(masked), stage
    assert asked["mask_refine"] == [False] * len(masked)
    sam2_spans = [s for s in rows if s.name == "sam2"]
    assert len(sam2_spans) == len(selects) >= 1
    assert all(by_sid[s.parent].name == "mask_refine" for s in sam2_spans)

    totals: dict = {}
    for c in timing.counts():
        totals[c.name] = totals.get(c.name, 0) + c.n
    assert totals["sam2.calls"] == refiner.calls >= len(sam2_spans)
    assert totals.get("sam2.replaced", 0) == refiner.replaced
    assert totals.get("sam2.rejected", 0) == refiner.rejected
    assert refiner.replaced + refiner.rejected >= 1
    px = [c.n for c in timing.counts("dyn.mask_px")]
    assert px == [round(s * H * W) for s in slam.prof["mask_share"]] and len(px) == len(masked)
