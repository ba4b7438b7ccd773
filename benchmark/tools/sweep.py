"""The knee of a serving cell: the highest offered rate that the runtime
sustains, by one sweep on the chip.

    python3 benchmark/tools/sweep.py --workload <name> --rates 3,3.5,4
        [--seconds 51] [--seed 1] [--out sweep.jsonl]

Weights are made once; each rate gets a fresh runtime (its buckets
warmed) and the cell's mix at that rate, ramp included. A rate is
sustained when, over the window, the batcher's queue stays empty (every
request due finds a slot) and the tokens streamed per second keep up
with what the window's requests ask for. Per rate it prints the queue's
mean depth and the busiest slot count over each quarter of the window,
the tokens streamed per second beside the tokens per second the
requests due in the window ask for, and the 90th percentiles of time to
first token and time per output token.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

from benchmark import harness, traffic  # noqa: E402
from benchmark.stats import percentile  # noqa: E402


def summary(rate: float, seconds: float, reqs, client) -> dict:
    """The sweep's readings of one rate's run."""
    quarters, busiest = [], []
    for q in range(4):
        lo, hi = seconds * q / 4, seconds * (q + 1) / 4
        depths = [(dq, busy) for t, dq, busy in client.depths if lo <= t < hi]
        quarters.append(sum(d for d, _ in depths) / max(1, len(depths)))
        busiest.append(max((b for _, b in depths), default=0.0))
    due = [r for r in reqs if 0 <= r["due"] < seconds]
    ttft = [(r["times"][0] - r["due"]) * 1e3 if r.get("times")
            else float("inf") for r in due]
    tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
            for r in due if len(r.get("times", [])) >= 2]
    toks = sum(1 for r in reqs for t in r.get("times", [])
               if 0 <= t < seconds)
    return {"rate_per_s": rate, "due": len(due),
            "queue_by_quarter": quarters, "slots_busy_max": busiest,
            "tokens_per_s": toks / seconds,
            "asked_tokens_per_s": sum(r["max_new"] for r in due) / seconds,
            "ttft_p90_ms": harness.finite(percentile(ttft, 90)),
            "tpot_p90_ms": percentile(tpot, 90) if tpot else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bench = harness.load_benchmark()
    harness.set_environment(harness.resolve(bench, args.workload).mix)
    import torch

    from benchmark.kinds import serve
    from benchmark.weights import make_params

    base = harness.resolve(bench, args.workload, seed=args.seed,
                           seconds=args.seconds)
    base.device = torch.device("cuda", 0)
    params = make_params(base.dims, base.seed, base.device)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = dataclasses.replace(base, mix=dict(base.mix, rate_per_s=rate),
                                   t_process=time.perf_counter())
        rt = serve.start_runtime(cell, params)
        reqs = traffic.serve_requests(cell.mix, cell.seed, cell.dims.vocab,
                                      cell.seconds + cell.mix["tail_s"])
        try:
            _, client = serve.drive(cell, rt, reqs)
        finally:
            rt.stop()
        line = summary(rate, cell.seconds, reqs, client)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del rt, client
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
