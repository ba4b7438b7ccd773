"""The batcher's host milliseconds per decode step over the window (its
``decode_seconds`` over its ``decode_steps``, each chunk timed up to its
readback), less a profiled span."""

from benchmark.stats import counter_delta


def read(run):
    if run["kind"] != "serve":
        return None
    steps = counter_delta(run, "decode_steps")
    if steps <= 0:
        return None
    return 1e3 * counter_delta(run, "decode_seconds") / steps
