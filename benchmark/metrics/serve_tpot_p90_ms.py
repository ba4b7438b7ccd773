"""90th percentile, over the requests due in the window with at least two
tokens, of (last token's time - first token's) / (tokens - 1)."""

from benchmark.stats import percentile


def read(run):
    if run["kind"] != "serve":
        return None
    per = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
           for r in run["requests"] if len(r["times"]) >= 2]
    return percentile(per, 90) if per else None
