"""90th percentile, over every request due in the window, of the time
from when it was due to its first streamed token; a request with no token
by the run's end counts as infinite."""

from benchmark.stats import percentile


def read(run):
    if run["kind"] != "serve" or not run["requests"]:
        return None
    waits = [(r["times"][0] - r["due"]) * 1e3 if r["times"] else float("inf")
             for r in run["requests"]]
    return percentile(waits, 90)
