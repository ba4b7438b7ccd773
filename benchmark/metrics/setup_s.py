"""Seconds from the process's start to the window's opening: imports,
weights, warm-up (and on a checkout's first run the kernels' build), and
for serving the arrivals' ramp."""


def read(run):
    return run["setup_s"]
