"""host_reads.slam: host reads that block on the device per tracked frame
of the window: the main thread's `wait` spans (the port's recorder,
`harness/spans.py`) over the tracked frames (one `match_track` each). None
where the program records no spans."""

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    if w is None or not spans.tracked_frames(w):
        return None
    return len(spans.main_thread(w, "wait")) / spans.tracked_frames(w)
