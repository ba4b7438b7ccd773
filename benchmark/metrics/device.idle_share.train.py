"""Share of the profiled training steps (whole steps, synchronized at both
ends) in which nothing ran on the device, in %."""


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
