"""attn_roofline.train: kernel A's share of its roofline in the traced
steps: the least time of its calls (each attention forward's QK^T and PV at
the bf16 peak, or its Q, K, V and O moved once at the HBM rate, whichever is
longer; the calls counted from the configuration's shapes) over the device
time of the kernels named `attn_fwd*`. None when the trace holds none."""

from benchmark.harness import counts


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_steps"):
        return None
    t = sum(s for name, (s, _) in tr["kernels"].items() if "attn_fwd" in name)
    if t <= 0:
        return None
    h, w = run["img_size"]
    bound = run["traced_steps"] * sum(counts.attention_bound_s(c) for c in
                                      counts.attention_calls(run["config"], run["batch"], h, w))
    return 100.0 * bound / t
