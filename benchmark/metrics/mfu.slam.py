"""mfu.slam: the window's counted model FLOPs (one encode a frame, one
decoder and both heads a decoded pair, tracking and edge decodes alike,
`harness/counts.py`) over the window's seconds, as a percentage of one
H100's dense bf16 peak. Retrieval's feature head is left out."""

from benchmark.harness import counts


def read(run):
    cfg = run["config"]
    h, w = run["img_size"]
    flops = (run["encodes"] * counts.encoder_flops(cfg, h, w)
             + run["decode_rows"] * counts.decode_flops(cfg, h, w))
    return 100.0 * flops / run["window_s"] / counts.PEAK_BF16
