"""mfu.train: the window's counted model FLOPs (3x the forward of each
pair, `harness/counts.py`, layer by layer from the shapes) over its seconds,
as a percentage of one H100's dense bf16 peak."""

from benchmark.harness import counts


def read(run):
    h, w = run["img_size"]
    flops = run["steps"] * counts.train_step_flops(run["config"], run["batch"], h, w)
    return 100.0 * flops / run["window_s"] / counts.PEAK_BF16
