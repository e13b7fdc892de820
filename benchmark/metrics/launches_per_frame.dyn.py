"""launches_per_frame.dyn: kernels launched on the device per frame,
counted from the traced frames' device events (copies and memsets left
out)."""


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_frames"):
        return None
    return tr["launches"] / run["traced_frames"]
