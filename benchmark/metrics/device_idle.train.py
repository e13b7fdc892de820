"""device_idle.train: the share of the measured window in which no
operation ran on the device, in percent: the device's busy time per step
in the steps traced right after the window (torch.profiler's device
events, the union of their intervals) times the window's steps, against
the window's seconds. The traced steps themselves run slower under the
profiler, so their own idle share (`device.busy_s` over `device.window_s`)
reads higher than the window's."""


def read(run):
    tr = run["trace"]
    if tr is None or not run.get("traced_steps") or not run["steps"]:
        return None
    busy = tr["busy_s"] / run["traced_steps"] * run["steps"]
    return 100.0 * (1.0 - busy / run["window_s"])
