"""frame_ms_p95.slam: the 95th percentile of every `process_frame` call of
the window, host clock, in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run["frame_wall_ms"], 95)) if run["frame_wall_ms"] else None
