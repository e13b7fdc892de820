"""enqueue_ms.slam: host ms a tracked frame of the window spends enqueueing
its device work: the self time of the main thread's `encode`, `decode` and
`match_track` spans (the port's recorder, `harness/spans.py`), the `wait`
spans below them left out, over the tracked frames (one `match_track`
each). None where the program records no spans."""

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    if w is None or not spans.tracked_frames(w):
        return None
    waits = spans.wait_ns_under(w, spans.STAGES)
    ns = sum((s.t1 - s.t0) - waits.get(s.sid, 0)
             for name in spans.STAGES for s in spans.main_thread(w, name))
    return ns / 1e6 / spans.tracked_frames(w)
