"""mfu.dyn: the window's counted FLOPs over its seconds, as a percentage of
one H100's dense bf16 peak (989 TFLOP/s): one MonST3R encode a frame, each
decoded pair of each decoder with both its heads (tracking, INIT and edge
decodes alike), each RAFT call at its iterations and each SAM2 refiner
call (the Hiera-B+ encode and the decode of its prompt rows), counted
layer by layer from the shapes (`harness/counts.py`,
`harness/counts_dynamic.py`). Retrieval's feature head and the elementwise
work are left out."""

from benchmark.harness import counts, counts_dynamic


def read(run):
    c = run.get("counted")
    if not c:
        return None
    cfg = run["config"]
    h, w = run["img_size"]
    mcfg = dict(cfg, **cfg["mast3r"])
    flops = (c["encodes"] * counts.encoder_flops(cfg, h, w)
             + c["rows"]["monst3r"] * counts.decode_flops(cfg, h, w)
             + c["rows"]["mast3r"] * counts.decode_flops(mcfg, h, w)
             + c["raft_calls"] * counts_dynamic.raft_flops(cfg["raft"], h, w)
             + c["sam2_calls"] * counts_dynamic.sam2_flops(cfg["sam2"]))
    return 100.0 * flops / run["window_s"] / counts.PEAK_BF16
