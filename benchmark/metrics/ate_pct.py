"""ate_pct: absolute trajectory error of the window's completed episodes,
each Sim(3)-aligned to its ground truth alone, every frame's error over its
episode's extent, in percent; each distinct episode of the mix weighs the
same however often the window replays it (`reference/ate.mix_pct`). None
without a completed episode."""

from benchmark.reference import ate


def read(run):
    eps = run["episodes"]
    if not eps:
        return None
    return ate.mix_pct([(e, p[:, :3], g[:, :3]) for p, g, e in eps])
