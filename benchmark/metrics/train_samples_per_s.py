"""train_samples_per_s: training pairs of every step of the window over
the window's seconds (host clock, the device synchronized at its end)."""


def read(run):
    return run["steps"] * run["batch"] / run["window_s"]
