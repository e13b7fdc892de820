"""launches_per_step.train: kernels launched on the device per training
step, counted from the traced steps' device events (copies and memsets
left out)."""


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_steps"):
        return None
    return tr["launches"] / run["traced_steps"]
