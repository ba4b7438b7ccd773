"""How many whole layers of a training cell's model fit one card: the
training step's peak memory at each depth tried.

    python3 benchmark/tools/fit_depth.py --workload <name> --layers 28,24

Each depth builds the cell's train state and runs three steps of the
cell's batch; a depth that runs out of memory is reported as such.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

from benchmark import harness, traffic  # noqa: E402
from benchmark.models import dims  # noqa: E402


def attempt(cell, torch) -> dict:
    """Three steps at the cell's depth; everything it built is gone when it
    returns, out of memory or not."""
    from benchmark.kinds import train
    from benchmark.weights import make_params

    torch.cuda.reset_peak_memory_stats()
    line = {"layers": cell.dims.n_layers}
    try:
        params = make_params(cell.dims, cell.seed, cell.device)
        deck = traffic.train_deck(cell.mix, cell.seed, cell.dims.vocab,
                                  cell.device)
        step, state = train.make_step(cell, params)
        del params
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            state, _ = step(state, deck[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        line.update(ok=True, step_s=times)
    except torch.OutOfMemoryError as exc:
        line.update(ok=False, error=str(exc).splitlines()[0])
    line.update(peak_bytes=torch.cuda.max_memory_allocated(),
                reserved_bytes=torch.cuda.max_memory_reserved(),
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                alloc_retries=torch.cuda.memory_stats().get(
                    "num_alloc_retries", 0))
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--layers", required=True)
    args = ap.parse_args()
    bench = harness.load_benchmark()
    base = harness.resolve(bench, args.workload, seed=3)
    harness.set_environment(base.mix)
    import torch

    base.device = torch.device("cuda", 0)
    for n in [int(x) for x in args.layers.split(",")]:
        config = dict(base.config, num_hidden_layers=n)
        cell = dataclasses.replace(base, config=config, dims=dims(config))
        line = attempt(cell, torch)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
