"""setup_s: process start to the first timed operation (import, kernel
build check, weights, traffic, warm-up), on the host clock."""


def read(run):
    return run["setup_s"]
