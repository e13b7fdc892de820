"""attn_bwd_roofline.train: the attention backward kernels' share of their
roofline in the traced steps: the least time of the backward of each
attention call (its five products, S = QK^T, dP = dO V^T, dV, dK and dQ,
2.5x the forward's two at the bf16 peak; the calls counted from the
configuration's shapes) over the device time of the kernels named
`attn_bwd*`. None when the trace holds none."""

from benchmark.harness import counts


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_steps"):
        return None
    t = sum(s for name, (s, _) in tr["kernels"].items() if "attn_bwd" in name)
    if t <= 0:
        return None
    h, w = run["img_size"]
    bound = run["traced_steps"] * sum(2.5 * counts.attention_bound_s(c) for c in
                                      counts.attention_calls(run["config"], run["batch"], h, w))
    return 100.0 * bound / t
