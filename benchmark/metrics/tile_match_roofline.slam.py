"""tile_match_roofline.slam: kernel B's share of its bound in the traced
frames: the least time of each kernel B call made there (the ray dot over
each query's crop at the f32 peak plus the descriptor dot over its window
at the bf16 peak, or its inputs and outputs moved once, whichever is
longer) over the device time of the kernels named `tile_match*`. None when
the trace holds none."""

from benchmark.harness import counts
from benchmark.reference import matcher


def read(run):
    tr = run["trace"]
    if tr is None or not run["traced_matches"]:
        return None
    t = sum(s for name, (s, _) in tr["kernels"].items() if "tile_match" in name)
    if t <= 0:
        return None
    bound = 0.0
    for c in run["traced_matches"]:
        T, tsz, crop, fd, h, w, window = c["shape"]
        pos = matcher.window_positions(c["rays"], c["q_rays"], c["corners"], crop, window)
        bound += counts.tile_match_bound_s(T, tsz, crop, fd, h, w, pos)
    return 100.0 * bound / t
