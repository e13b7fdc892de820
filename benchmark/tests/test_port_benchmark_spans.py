"""The readers of the program's own spans (`harness/spans.py` and the
per-layer metrics built on it) on a synthetic recorder, and on the
program's recorder after a traced run of each cell at TINY on the CPU."""

import importlib.util
import threading
import types

import pytest

from benchmark.harness import cli, spans
from benchmark.tests.test_port_benchmark_cells import SLAM, TRAIN, few_threads, run  # noqa: F401

MS = 1_000_000  # ns
MAIN = threading.main_thread().native_id
WORKER = MAIN + 1
SLAM_METRICS = ("enqueue_ms.slam", "host_wait_ms.slam", "host_reads.slam", "kf_event_ms.slam",
                "backend_stall_ms.slam")
TRAIN_METRICS = ("fwd_device_ms.train", "bwd_device_ms.train", "opt_device_ms.train")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}",
                                                  cli.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Store:
    """A recorder holding hand-made records: `span` appends one."""

    def __init__(self):
        self.rows, self.events, self.sid = [], [], 0

    def span(self, name, t0, t1, parent=None, tid=MAIN, rid=None, device_ms=None):
        self.sid += 1
        s = types.SimpleNamespace(name=name, t0=t0 * MS, t1=t1 * MS, sid=self.sid, tid=tid,
                                  rid=rid, device_ms=device_ms,
                                  parent=parent.sid if parent is not None else None)
        self.rows.append(s)
        return s

    def count(self, name, n, t, tid=MAIN):
        self.events.append(types.SimpleNamespace(name=name, n=n, t=t * MS, tid=tid))

    def spans(self):
        return list(self.rows)

    def counts(self):
        return list(self.events)


def slam_store():
    """One warm-up frame, three window frames (INIT-free, tracked: 1 and 2
    with a keyframe event and a worker job in frame 2, an episode's
    `finalize` after frame 2), and 1 + 2 traced frames."""
    st = Store()
    t = 0
    for fid in range(7):
        f = st.span("frame", t, t + 100, rid=fid)
        st.span("encode", t, t + 10, f)
        st.span("decode", t + 10, t + 30, f)
        mt = st.span("match_track", t + 30, t + 70, f)
        for k in range(3):  # the GN stop tests: 1 ms each
            st.span("wait", t + 40 + 5 * k, t + 41 + 5 * k, mt)
        r = st.span("resolve", t + 70, t + 90, f, rid=fid - 1)
        st.span("wait", t + 70, t + 72, r)  # the decision vector: 2 ms
        st.count("track.gn_iters", 3, t + 60)
        if fid == 2:
            kf = st.span("kf_event", t + 72, t + 80, r)
            st.span("backend_stall", t + 73, t + 76, kf)
            st.span("backend_job", t + 76, t + 150, tid=WORKER, rid=fid)
            st.span("wait", t + 77, t + 78, tid=WORKER)  # the worker's: not the main thread's
            fin = st.span("finalize", t + 101, t + 110)
            st.span("backend_stall", t + 102, t + 108, fin)
        t += 200
    return st


def train_store():
    """Two checked steps, four window steps, 1 + 1 traced steps."""
    st = Store()
    for k in range(8):
        t = 1000 * k
        step = st.span("train_step", t, t + 900, rid=k)
        st.span("forward", t, t + 300, step, device_ms=300.0 + k)
        st.span("backward", t + 300, t + 800, step, device_ms=500.0 + k)
        st.span("optimizer", t + 800, t + 900, step, device_ms=20.0 + k)
    return st


def test_the_window_is_the_run_count_before_the_traced_spans():
    st = slam_store()
    w = spans.slam(dict(frames=3, traced_frames=2), st)
    assert [s.rid for s in w.top] == [1, 2, 3] and w.main == MAIN
    assert {s.name for s in w.spans} >= {"backend_job", "finalize", "kf_event"}
    assert min(s.t0 for s in w.spans) == w.top[0].t0 and max(s.t1 for s in w.spans) <= 700 * MS
    assert sum(c.n for c in w.counts) == 9
    assert spans.tracked_frames(w) == 3
    assert spans.slam(dict(frames=6, traced_frames=2), st) is None  # 9 would be needed
    assert spans.slam(dict(frames=0, traced_frames=2), st) is None
    t = spans.train(dict(steps=4, traced_steps=1), train_store())
    assert [s.rid for s in t.top] == [2, 3, 4, 5]


def test_the_slam_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(spans, "store", slam_store)
    run_ = dict(frames=3, traced_frames=2)
    got = {name: reader(name)(run_) for name in SLAM_METRICS}
    # encode 10 + decode 20 + match_track 40 less its 3 ms of waits
    assert got["enqueue_ms.slam"] == pytest.approx(67.0)
    # main thread: 3 GN waits and 1 decision read a frame, 5 ms
    assert got["host_wait_ms.slam"] == pytest.approx(5.0)
    assert got["host_reads.slam"] == pytest.approx(4.0)
    assert got["kf_event_ms.slam"] == pytest.approx(8.0)
    # 3 ms of hand-off in frame 2 and 6 ms of `finalize`, over 3 frames
    assert got["backend_stall_ms.slam"] == pytest.approx(3.0)


def test_the_training_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(spans, "store", train_store)
    run_ = dict(steps=4, traced_steps=1)
    got = [reader(name)(run_) for name in TRAIN_METRICS]
    assert got == [pytest.approx(303.5), pytest.approx(503.5), pytest.approx(23.5)]


def test_no_recorder_no_number(monkeypatch):
    """A program without the recorder (a checkout from before it), or one
    whose `timing` module lacks its readers: every reader returns None."""
    monkeypatch.setattr(spans, "store", lambda: None)
    for name in SLAM_METRICS + TRAIN_METRICS:
        assert reader(name)(dict(frames=3, traced_frames=2, steps=4, traced_steps=1)) is None
    monkeypatch.undo()
    import monst3r_slam_torch.utils.timing as timing

    monkeypatch.delattr(timing, "spans")
    assert spans.store() is None


def test_a_traced_run_reports_the_span_metrics():
    """The program's recorder after a traced run of each cell at TINY on the
    CPU: the SLAM readers read a number (the keyframe event's where the
    window holds one: TINY's 12-frame episodes make none); the training
    window's spans carry no device time on the CPU."""
    from monst3r_slam_torch.utils import timing

    timing.reset()
    out = run(SLAM, trace=True)
    for name in SLAM_METRICS:
        if name != "kf_event_ms.slam":
            assert out["metrics"][name]["value"] is not None, name
    assert out["metrics"]["host_reads.slam"]["value"] >= 2
    if "kf_event_ms.slam" in out["metrics"]:
        assert timing.spans("kf_event")
    timing.reset()
    out = run(TRAIN, trace=True)
    assert not set(TRAIN_METRICS) & set(out["metrics"])
    assert spans.store() is timing
