"""Milliseconds from a request's admission to its first token inside the
batcher (prefill and the readback of its token): the hub's
``serve_ttft_seconds`` less ``serve_queue_wait_seconds``, summed over the
window, per admitted request."""

from benchmark.stats import counter_delta


def read(run):
    if run["kind"] != "serve":
        return None
    n = counter_delta(run, "ttft_count")
    if n <= 0:
        return None
    return 1e3 * (counter_delta(run, "ttft_sum")
                  - counter_delta(run, "queue_wait_sum")) / n
