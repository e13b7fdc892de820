"""gn_iters.slam: tracking Gauss-Newton iterations per tracked frame (the
`iters` of each tracking result, read as the host resolves the frame)."""


def read(run):
    return sum(run["gn_iters"]) / len(run["gn_iters"]) if run["gn_iters"] else None
