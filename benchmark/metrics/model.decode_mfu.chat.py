"""The decode step's modelled least time over its measured time, in %.

Least time: the larger of the model's operations over the bf16 peak and
its bytes over the memory bandwidth, from the running sequences each poll
saw advance (the top-2 experts' operations; every non-embedding weight
read once a step, an expert only if a running token routes to it; the
cached rows read and written). Measured: the batcher's decode seconds of
the same polls. The count is the same whatever the expert layer
computes."""

from benchmark.roofline import counts
from benchmark.stats import window_polls


def read(run):
    if run["kind"] != "serve":
        return None
    polls = window_polls(run)
    spent = sum(p["decode_seconds"] for p in polls)
    if not polls or spent <= 0:
        return None
    peak = counts.peaks(run["device_name"])
    least = 0.0
    for p in polls:
        cost = counts.decode_cost(run["dims"], p["steps"], p["token_steps"],
                                  p["visible"])
        least += counts.least_time(cost["flops"], cost["bytes"], peak)
    return 100.0 * least / spent
