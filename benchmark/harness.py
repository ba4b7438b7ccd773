"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell is made of is found by name. The workload's entry in
``BENCHMARK.json`` names a configuration (its file is the entry's
``file``) and a traffic mix (``benchmark/traffic/<mix>.json``, whose
``kind`` picks the runner ``benchmark/kinds/<kind>.py``); its output
limits are ``benchmark/limits/<workload>.json``. Each metric is read by
``benchmark/metrics/<metric>.py``, whose ``read(run)`` returns a number or
None where it finds nothing to read. With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The line is one JSON object, the last line of standard output; the
numbers the output check compared, each with its limit, come last in it
(``checks``) and are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from .models import Dims, dims

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules the measured process may not hold once the window
# has closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_operator_libs_tpu")
RELATIONS = {"at_most": lambda v, lim: v <= lim,
             "at_least": lambda v, lim: v >= lim}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    dims: Dims
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    t_process: float = 0.0
    control: bool = False
    control_reading: Optional[Dict[str, float]] = None
    # the control's numbers beside the cell's limits, as ``run["checks"]``
    control_checks: Optional[Dict[str, tuple]] = None


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def resolve(bench: Dict[str, Any], workload: str, root: Path = ROOT,
            seed: int = 0, seconds: float = 0.0, trace: bool = False
            ) -> Cell:
    """The cell named ``workload`` with every file it names loaded."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    mix = _load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "benchmark" / "limits" / f"{workload}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                dims=dims(config), mix=mix, limits=limits, seed=int(seed),
                seconds=float(seconds), trace=bool(trace))


def metrics_for(bench: Dict[str, Any], workload: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The metric entries a run of ``workload`` reports: end-to-end ones
    untraced, per-layer ones traced; an entry with ``workloads`` only in
    the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str, root: Path = ROOT):
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + "".join(c if c.isalnum() else "_"
                                      for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[Dict[str, Any]], run: Dict[str, Any],
                 root: Path = ROOT) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in entries:
        value = load_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": finite(float(value)),
                              "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def set_environment(mix: Optional[Dict[str, Any]] = None,
                    root: Path = ROOT) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout, and
    PyTorch's allocator as the cell's mix sets it (its ``cuda_alloc_conf``,
    the value of ``PYTORCH_CUDA_ALLOC_CONF``; the default allocator where
    it sets none). Call before CUDA starts."""
    cache = root / "build" / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    conf = (mix or {}).get("cuda_alloc_conf")
    if conf:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    else:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)


def judge(checks: Dict[str, tuple]) -> bool:
    return all(RELATIONS[rel](value, limit)
               for value, limit, rel in checks.values())


def result_line(cell: Cell, run: Dict[str, Any],
                metrics: Dict[str, Dict[str, Any]], device_name: str,
                ) -> Dict[str, Any]:
    checks = run["checks"]
    correct = judge(checks) and run["failed"] == 0
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(run["attempted"]),
                            "failed": int(run["failed"]),
                            "metrics": metrics, "device": device}
    trace = run.get("trace")
    if cell.trace and trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_ops(10),
                             "idle_gaps": trace.idle_gaps(10)}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim, _) in checks.items()}
    return line


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, t_process: float = 0.0) -> int:
    t_process = t_process or time.perf_counter()
    args = parse(argv)
    bench = load_benchmark()
    cell = resolve(bench, args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace))
    cell.t_process = t_process
    set_environment(cell.mix)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    cell.device = torch.device("cuda", 0)
    torch.cuda.set_device(cell.device)
    device_name = torch.cuda.get_device_name(cell.device)
    log(f"{cell.name} seed {cell.seed} on {device_name}")
    kind = importlib.import_module(f"benchmark.kinds.{cell.mix['kind']}")
    run = kind.run(cell)

    held = forbidden_modules()
    if held:
        print(f"the measured process holds {', '.join(held)}",
              file=sys.stderr)
        return 3
    run["device_name"] = device_name
    metrics = read_metrics(metrics_for(bench, cell.name, cell.trace), run)
    line = result_line(cell, run, metrics, device_name)
    for name, (v, lim, rel) in run["checks"].items():
        print(f"check {name} {v!r} limit {lim!r} ({rel.replace('_', ' ')})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False))
    return 0


def finite(x: float, cap: float = 1e12) -> float:
    """JSON has no infinity: an infinite reading is printed as ``cap``."""
    return x if math.isfinite(x) else cap
