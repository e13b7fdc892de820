"""host_wait_ms.slam: host ms a frame of the window waits on the device:
the main thread's `wait` spans (each host read that blocks on the card:
the frame's decision vector, each Gauss-Newton stop test, pose read-backs,
retrieval's features; the port's recorder, `harness/spans.py`), summed,
over the window's frames. None where the program records no spans."""

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    if w is None:
        return None
    return sum(s.t1 - s.t0 for s in spans.main_thread(w, "wait")) / 1e6 / len(w.top)
