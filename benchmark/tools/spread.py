"""Spreads of a cell's runs, and the bounds they suggest.

    python3 benchmark/tools/spread.py SET_A_DIR SET_B_DIR

Each directory holds one file per run whose last line is the run's
result line. Per metric and set it prints the median, the spread (the
distance between the first and third quartile of Python's
``statistics.quantiles(values, n=4)``, over the median) and the spread
with the run farthest from the median left out; then five times the wider
of the two sets' spreads, the bound that spread suggests (never under 1%,
at most 25%), and how the second set's median stands to the first's.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def load(directory):
    runs = []
    for path in sorted(Path(directory).iterdir()):
        lines = path.read_text().strip().splitlines()
        if lines:
            try:
                runs.append(json.loads(lines[-1]))
            except json.JSONDecodeError:
                continue
    return runs


def main(dirs):
    sets = [load(d) for d in dirs]
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        per = []
        for runs in sets:
            vals = [r["metrics"][name]["value"] for r in runs
                    if name in r["metrics"]]
            per.append(vals)
            print(f"{name:32s} n={len(vals)} median "
                  f"{statistics.median(vals):.6g} spread {spread(vals):.4f}"
                  f" trimmed {spread(trimmed(vals)):.4f} "
                  f"values {[round(v, 4) for v in vals]}")
        wide = max(spread(v) for v in per)
        bound = min(0.25, max(0.01, 5 * wide))
        shift = statistics.median(per[-1]) / statistics.median(per[0]) - 1
        print(f"{'':32s} widest spread {wide:.4f} -> bound {bound:.4f}; "
              f"second set's median {shift:+.4f} of the first's")
    for runs in sets:
        print("correct:", [r["correct"] for r in runs])


if __name__ == "__main__":
    main(sys.argv[1:])
