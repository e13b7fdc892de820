"""backend_job_ms.slam: the median backend worker job of the window
(`SLAMSystem.prof["backend_job"]`: retrieval, edge decodes and matches, the
global solve), in ms."""

import numpy as np


def read(run):
    return float(np.median(run["backend_job_ms"])) if run["backend_job_ms"] else None
