"""frame_ms.dyn: the window's seconds over the frames it processed, in ms
(host clock; episode set-up and `finalize` included)."""


def read(run):
    return 1e3 * run["window_s"] / run["frames"] if run["frames"] else None
