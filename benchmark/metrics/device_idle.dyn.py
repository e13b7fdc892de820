"""device_idle.dyn: the share of the measured window in which no operation
ran on the device, in percent: the device's busy time per frame in the
frames traced right after the window (torch.profiler's device events, the
union of their intervals) times the window's frames, against the window's
seconds."""


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_frames") or not run["frames"]:
        return None
    busy = tr["busy_s"] / run["traced_frames"] * run["frames"]
    return 100.0 * (1.0 - busy / run["window_s"])
