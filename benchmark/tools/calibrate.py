"""Readings the output limits are set from, in one process on the chip.

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2] [--faults half_batch] [--seconds 51]
        [--out calibrate.jsonl]

For each seed it prints one JSON line per reading: the program's own
compared numbers (``program``), and on the control seeds the float8
reference put in the program's place (``control``) and each named fault
planted under the timed path (``fault:<name>``); ``correct`` is the
harness's verdict (:func:`benchmark.harness.judge`) on a reading's
numbers beside the cell's limits. A training reading needs
no window: the program is driven through its compared steps only, and
each seed's float32 reference is computed once for all of its readings.
A serving reading is a whole run of the cell (its window at the cell's
load), the control read over the same sample.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

from benchmark import harness  # noqa: E402
from benchmark.tools import faults  # noqa: E402


def _emit(out, seed: int, what: str, numbers: dict, **extra) -> None:
    line = json.dumps({"seed": seed, "what": what, "numbers": numbers,
                       **extra})
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def worst_leaf(prog: dict, ref: dict, key: str) -> list:
    """The three leaves with the widest relative gap of ``key``."""
    import statistics
    med = statistics.median(ref[key].values())
    gaps = {n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
            for n in ref[key]}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


def train_seed(cell, control: bool, fault_names, out) -> None:
    from benchmark import traffic, weights
    from benchmark.kinds import train

    d, dev = cell.dims, cell.device
    readings = {}
    for what in ["program"] + [f"fault:{f}" for f in fault_names]:
        ctx = (faults.TRAIN[what.split(":")[1]]() if what != "program"
               else contextlib.nullcontext())
        with ctx:
            params = weights.make_params(d, cell.seed, dev)
            deck = traffic.train_deck(cell.mix, cell.seed, d.vocab, dev)
            step, state = train.make_step(cell, params)
            del params
            state, readings[what] = train.program_readings(cell, step,
                                                           state, deck)
            del state, step
        _free()
    t0 = time.perf_counter()
    ref = train.reference_readings(cell, deck)
    ref_s = time.perf_counter() - t0
    if control:
        readings["control"] = train.reference_readings(cell, deck, "fp8")
    for what, got in readings.items():
        numbers = train.compare(got, ref)
        verdict = harness.judge(train.checks(numbers, cell.limits))
        _emit(out, cell.seed, what, numbers, correct=verdict,
              loss=got["loss"],
              ref_loss=ref["loss"], reference_s=ref_s,
              worst_grad=worst_leaf(got, ref, "grad"),
              worst_change=worst_leaf(got, ref, "change"))
    _free()


def serve_seed(cell, control: bool, out) -> None:
    from benchmark.kinds import serve

    cell.control = control
    run = serve.run(cell)
    numbers = {k: v[0] for k, v in run["checks"].items()}
    _emit(out, cell.seed, "checks", numbers, failed=run["failed"],
          attempted=run["attempted"], correct=harness.judge(run["checks"]))
    for what, stats in (cell.control_reading or {}).items():
        extra = ({"correct": harness.judge(cell.control_checks)}
                 if what == "control" else {})
        _emit(out, cell.seed, what, stats, **extra)
    _free()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bench = harness.load_benchmark()
    harness.set_environment(harness.resolve(bench, args.workload).mix)
    import torch

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fault_names = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            cell = harness.resolve(bench, args.workload, seed=seed,
                                   seconds=args.seconds)
            cell.device = torch.device("cuda", 0)
            cell.t_process = time.perf_counter()
            harness.log(f"calibrate {args.workload} seed {seed}")
            if cell.mix["kind"] == "train":
                train_seed(cell, seed in controls,
                           fault_names if seed in controls else [], out)
            else:
                serve_seed(cell, seed in controls, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
