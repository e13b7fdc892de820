"""backend_stall_ms.slam: main-thread host ms spent on backend work per
frame of the window: its `backend_stall` spans (the job's snapshot and
hand-off, a synchronous job, the waits for the worker in relocalization and
in each episode's `finalize`; the port's recorder, `harness/spans.py`),
summed, over the window's frames. None where the program records no
spans."""

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    if w is None:
        return None
    return sum(s.t1 - s.t0 for s in spans.main_thread(w, "backend_stall")) / 1e6 / len(w.top)
