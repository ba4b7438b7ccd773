"""Workload goodput ledger: the training job's own downtime bookkeeping.

A copy of the JAX package's ``obs/goodput.py`` with the same record
format, so either package's :func:`summarize` reads the other's ledger.
Every second of a job's wall time is either **goodput** (productive
train steps) or **badput**, segmented by cause:

``compile``       first step of a fresh job (in the port: the kernels'
                  ``nvcc`` build on the card, then the step)
``rewarmup``      first step of a RESUMED job
``ckpt_save``     periodic checkpoint dispatch (asynchronous: the
                  device->host snapshot only)
``drain_save``    the synchronous drain-triggered save before exit
``ckpt_restore``  restoring the latest checkpoint on resume
``degraded``      elastic mode's shrunken-mesh window, priced by the
                  capacity lost (written by the reference's elastic
                  trainer; the port reads it)
``idle_gap``      derived, never written: wall time between one run's
                  drain and the next run's first goodput step

The ledger is a JSONL step log persisted next to the checkpoint
directory (:meth:`GoodputLedger.for_checkpoint_dir`), appended: a resumed
job continues the same file, so the cross-restart unavailability window
is computed from the log (:func:`unavailability_windows`). Record kinds,
one JSON object per line::

    {"kind": "run_start", "t": <wall>, "step": 100, "resumed": true}
    {"kind": "step", "t": <wall-at-sync>, "step": 110, "n": 10,
     "wall_s": 4.1, "tokens": 40960, "tokens_per_s": 9990.2, "mfu": 0.41}
    {"kind": "phase", "t": <wall-at-start>, "phase": "drain_save",
     "duration_s": 3.2}
    {"kind": "run_end", "t": <wall>, "step": 114, "preempted": true}

``step`` records are written at telemetry SYNC points (every N steps and
at checkpoint boundaries: the trainer never blocks the device stream per
step), covering the ``n`` steps since the previous sync.

Clock-injected; optionally feeds a :class:`~.metrics.MetricsHub` so the
job's exposition carries the families the ledger persists
(``step_duration_seconds``, ``badput_seconds{phase}``, ``tokens_per_s``,
``mfu``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils.clock import Clock, RealClock
from .trace import DEFAULT_MAX_LOG_BYTES, rotate_jsonl

logger = logging.getLogger(__name__)

LEDGER_BASENAME = "goodput.jsonl"

class GoodputLedger:
    """Append-only workload telemetry recorder.

    ``flops_per_token`` and ``peak_flops`` (both optional) turn token
    throughput into MFU; with either at 0 the ``mfu`` field is ``null``.
    Not thread-safe by design: one training loop owns one ledger.
    """

    def __init__(self, path: str, clock: Optional[Clock] = None,
                 metrics=None, flops_per_token: float = 0.0,
                 peak_flops: float = 0.0,
                 max_bytes: int = DEFAULT_MAX_LOG_BYTES):
        self.path = path
        self.clock = clock or RealClock()
        self._metrics = metrics
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(peak_flops)
        self._max_bytes = int(max_bytes)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # a non-empty pre-existing file (or a rotated generation) means
        # this process CONTINUES a prior run's ledger — the resumed-job
        # signal that names the first-step phase "rewarmup" instead of
        # "compile"
        self.resumed = any(
            os.path.exists(p) and os.path.getsize(p) > 0
            for p in (path, path + ".1"))
        self._fh = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------- writes

    def _write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        if (self._max_bytes > 0 and self._fh.tell() > 0
                and self._fh.tell() + len(line) + 1 > self._max_bytes):
            self._fh = rotate_jsonl(self._fh, self.path)
        self._fh.write(line + "\n")
        self._fh.flush()

    def run_started(self, step: int) -> None:
        self._write({"kind": "run_start", "t": self.clock.wall(),
                     "step": int(step), "resumed": self.resumed})

    def run_ended(self, step: int, preempted: bool) -> None:
        self._write({"kind": "run_end", "t": self.clock.wall(),
                     "step": int(step), "preempted": bool(preempted)})

    def steps(self, step: int, n: int, wall_s: float, tokens: int) -> None:
        """One synced window of ``n`` goodput steps ending at ``step``."""
        tokens_per_s = tokens / wall_s if wall_s > 0 else 0.0
        mfu = None
        if self.flops_per_token and self.peak_flops:
            mfu = round(tokens_per_s * self.flops_per_token
                        / self.peak_flops, 4)
        self._write({"kind": "step", "t": self.clock.wall(),
                     "step": int(step), "n": int(n),
                     "wall_s": float(wall_s), "tokens": int(tokens),
                     "tokens_per_s": tokens_per_s, "mfu": mfu})
        if self._metrics is not None and n > 0:
            self._metrics.observe("step_duration_seconds", wall_s / n)
            self._metrics.set_gauge("tokens_per_s", tokens_per_s)
            if mfu is not None:
                self._metrics.set_gauge("mfu", mfu)

    def record_phase(self, phase: str, start_wall: float,
                     duration_s: float, **extra: float) -> None:
        """Record an already-measured badput phase (for a caller that
        timed it itself)."""
        self._write({"kind": "phase", "t": float(start_wall),
                     "phase": phase, "duration_s": float(duration_s),
                     **extra})
        if self._metrics is not None:
            self._metrics.observe("badput_seconds", duration_s,
                                  labels={"phase": phase})

    @contextlib.contextmanager
    def phase(self, name: str, **extra: float) -> Iterator[None]:
        """Time a badput phase with the injected clock."""
        t0_mono, t0_wall = self.clock.now(), self.clock.wall()
        try:
            yield
        finally:
            self.record_phase(name, t0_wall,
                              max(0.0, self.clock.now() - t0_mono), **extra)

    def first_step(self, step: int, wall_s: float, tokens: int) -> None:
        """The first step of a run is compile/rewarmup badput, not
        goodput — segment it by whether this ledger continues a file."""
        self.record_phase("rewarmup" if self.resumed else "compile",
                          self.clock.wall() - wall_s, wall_s,
                          tokens=tokens)

    def close(self) -> None:
        self._fh.close()

    # ---------------------------------------------------------- factories

    @classmethod
    def for_checkpoint_dir(cls, checkpoint_dir: str,
                           **kwargs) -> "GoodputLedger":
        """The production layout: the ledger lives NEXT TO the
        checkpoints, so the resumed job (same ``--ckpt``) continues it."""
        return cls(os.path.join(checkpoint_dir, LEDGER_BASENAME), **kwargs)


# -------------------------------------------------------------- read side


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger JSONL file — the rotated ``.1`` generation first
    (older records) when one exists, so windows spanning a rotation stay
    contiguous; malformed lines are skipped with a warning (a crash
    mid-write truncates at most the last line)."""
    records: List[Dict[str, Any]] = []
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        # preserve the historical FileNotFoundError for a missing ledger
        paths = [path]
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    logger.warning("%s:%d: unparseable ledger line; "
                                   "skipped", p, lineno)
    return records


def split_runs(records: List[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Group records into runs (``run_start`` opens a new one; records
    before the first ``run_start`` form a headless run)."""
    runs: List[List[Dict[str, Any]]] = []
    for rec in records:
        if rec.get("kind") == "run_start" or not runs:
            runs.append([])
        runs[-1].append(rec)
    return runs


def unavailability_windows(
        records: List[Dict[str, Any]]) -> List[Tuple[float, float]]:
    """Cross-restart unavailability windows, computed from the LOG: each
    preempted run opens a window at its drain save (falling back to its
    ``run_end``), closed by the next run's first goodput step (the start
    of its first ``step`` window; falling back to its last badput phase
    end, then its ``run_start``)."""
    runs = split_runs(records)
    windows: List[Tuple[float, float]] = []
    for i, run in enumerate(runs[:-1]):
        end_rec = next((r for r in run if r.get("kind") == "run_end"), None)
        preempted = bool(end_rec and end_rec.get("preempted"))
        drain = next((r for r in run if r.get("kind") == "phase"
                      and r.get("phase") == "drain_save"), None)
        if not (preempted or drain):
            continue
        start = drain["t"] if drain else end_rec["t"]
        nxt = runs[i + 1]
        step = next((r for r in nxt if r.get("kind") == "step"), None)
        if step is not None:
            end = step["t"] - step.get("wall_s", 0.0)
        else:
            phases = [r for r in nxt if r.get("kind") == "phase"]
            if phases:
                end = max(r["t"] + r.get("duration_s", 0.0) for r in phases)
            else:
                end = nxt[0].get("t", start)
        if end > start:
            windows.append((start, end))
    return windows


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a ledger into the goodput/badput decomposition.

    ``phases`` carries per-phase ``{"count", "seconds"}`` plus the sum of
    any numeric extras the writer attached (e.g. the drain save's
    ``fetch_s``/``write_s`` split the downtime formula needs)."""
    goodput_s = 0.0
    steps = 0
    tokens = 0
    mfu_tokens = 0
    mfu_weighted = 0.0
    phases: Dict[str, Dict[str, float]] = {}
    times: List[float] = []
    for rec in records:
        kind = rec.get("kind")
        if "t" in rec:
            times.append(rec["t"])
            if kind == "phase":
                times.append(rec["t"] + rec.get("duration_s", 0.0))
        if kind == "step":
            goodput_s += rec.get("wall_s", 0.0)
            steps += rec.get("n", 0)
            tokens += rec.get("tokens", 0)
            if rec.get("mfu") is not None:
                mfu_weighted += rec["mfu"] * rec.get("tokens", 0)
                mfu_tokens += rec.get("tokens", 0)
        elif kind == "phase":
            agg = phases.setdefault(rec.get("phase", "unknown"),
                                    {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += rec.get("duration_s", 0.0)
            for key, value in rec.items():
                if key in ("kind", "phase", "t", "duration_s"):
                    continue
                if isinstance(value, (int, float)):
                    agg[key] = agg.get(key, 0.0) + value
    runs = split_runs(records)
    idle_gap_s = sum(end - start
                     for start, end in unavailability_windows(records))

    # "degraded" is concurrent with goodput (the job RAN, on fewer
    # chips): its steps already booked their wall time above, so the
    # badput charge is the PRICED capacity loss (seconds_lost), not the
    # raw duration — charging both would double-count the window
    def _charge(name: str, agg: Dict[str, float]) -> float:
        if name == "degraded":
            return agg.get("seconds_lost", agg["seconds"])
        return agg["seconds"]

    badput_s = sum(_charge(name, agg)
                   for name, agg in phases.items()) + idle_gap_s
    total_s = (max(times) - min(times)) if times else 0.0
    accounted = goodput_s + badput_s
    return {
        "runs": len(runs),
        "steps": steps,
        "tokens": tokens,
        "goodput_s": goodput_s,
        "badput_s": {**{name: _charge(name, agg) for name, agg in
                        sorted(phases.items())},
                     "idle_gap": idle_gap_s},
        "phases": phases,
        "idle_gap_s": idle_gap_s,
        "total_s": total_s,
        "goodput_fraction": (goodput_s / accounted) if accounted else None,
        "tokens_per_s": (tokens / goodput_s) if goodput_s else None,
        "mfu": (mfu_weighted / mfu_tokens) if mfu_tokens else None,
        "unavailability_windows": unavailability_windows(records),
        "last_step": max((rec.get("step", 0) for rec in records
                          if rec.get("kind") in ("step", "run_end",
                                                 "run_start")), default=0),
    }


def publish_summary(summary: Dict[str, Any], metrics) -> None:
    """Export a :func:`summarize` result as workload gauges, the
    efficiency decomposition the trainer's CLI prints:

    - ``goodput_fraction`` / ``goodput_seconds`` gauges,
    - ``badput_phase_seconds{phase=...}`` per badput cause (idle_gap
      included — the evicted window is badput like any other).

    Rendered under the ``tpu_workload`` prefix like every other gauge on
    the trainer's hub (``HELP_TEXTS`` carries the full names)."""
    if metrics is None or not summary:
        return
    fraction = summary.get("goodput_fraction")
    if fraction is not None:
        metrics.set_gauge("goodput_fraction", float(fraction))
    metrics.set_gauge("goodput_seconds",
                      float(summary.get("goodput_s", 0.0)))
    for phase, seconds in (summary.get("badput_s") or {}).items():
        metrics.set_gauge("badput_phase_seconds", float(seconds),
                          labels={"phase": phase})
