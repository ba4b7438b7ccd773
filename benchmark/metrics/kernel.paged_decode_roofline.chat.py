"""A-K4's share of its roofline in the profiled span, in %: the bytes it
needs (each running sequence's visible K and V rows read once, its query
read, its output written, every layer) over the HBM bandwidth, against
the device time of the ``paged_decode`` kernels (split and merge)."""

from benchmark.roofline import counts
from benchmark.stats import profiled_polls


def read(run):
    trace = run.get("trace")
    if run["kind"] != "serve" or trace is None:
        return None
    seconds, launches = trace.op_seconds("paged_decode")
    polls = profiled_polls(run)
    if not launches or not polls or seconds <= 0:
        return None
    d = run["dims"]
    token_steps = sum(p["token_steps"] for p in polls)
    visible = sum(p["visible"] for p in polls)
    nbytes = counts.paged_decode_bytes(d, token_steps, visible)
    flops = 4.0 * visible * d.n_heads * d.head_dim * d.n_layers
    least = counts.least_time(flops, nbytes, counts.peaks(run["device_name"]))
    return 100.0 * least / seconds
