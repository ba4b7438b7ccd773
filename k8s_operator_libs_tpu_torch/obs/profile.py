"""Tick flight recorder: per-handler self-time profiles of reconcile ticks.

A copy of the JAX package's ``obs/profile.py``; the port imports nothing
of that package.

The span tree (:mod:`.trace`) already records WHAT ran each reconcile
tick; this module turns it into WHERE THE TIME WENT. A
:class:`TickProfiler` is a span :class:`~.trace.Sink` (tee it in front of
the ``--trace-log`` JSONL sink) that groups span records by trace, and on
root-span close folds the whole tick into one :func:`build_profile`
record:

- **self-time decomposition** — per (component, handler) span: its own
  duration minus its children's durations minus the apiserver time the
  :class:`~..core.client.CountingClient` attributed to it, so the
  per-handler self-times plus the attributed apiserver call time sum back
  to the tick's ``reconcile_tick_duration`` sample (the 5 % acceptance
  bar ``tests/test_obs_profile.py`` pins);
- **apiserver-call attribution** — the CountingClient stamps
  ``api_calls`` / ``api_time_s`` attributes on the span that issued each
  call, so "why is this tick slow" is answered as calls × verb per
  handler, not a guess;
- **critical path** — the max-duration root-to-leaf chain of the tick's
  span tree;
- **fixed memory** — a ring of the last N tick profiles plus a bounded
  open-trace table; an idle operator holds a few KiB, a busy one the
  same.

The profiles are exposed as the ``/profile`` ``{"kind", "data"}``
envelope on the operator binary's metrics server (``operator.py
--profile``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.client import CountingClient
from ..utils import threads
from .metrics import API_LATENCY_BUCKETS
from .trace import Sink

# last-N tick profiles kept (one profile is a few hundred bytes of plain
# dicts; 64 ticks at --interval 30 is a half hour of history)
DEFAULT_PROFILE_RING = 64
# abandoned-trace backstop: a span tree whose root never closes (crashed
# thread mid-tick) must not leak its records forever
DEFAULT_MAX_OPEN_TRACES = 64

# emitted-family tables — OBS003 (lint/obs_check.py) closes these
# over obs/metrics.py::HELP_TEXTS in both directions, like the SLO/alert/
# router tables. Keep them literal: the pass reads this file with ast.
PROFILE_HISTOGRAM_FAMILIES = (
    "tpu_operator_apiserver_request_duration_seconds",
    "tpu_operator_obs_scrape_duration_seconds",
)
PROFILE_COUNTER_FAMILIES = (
    "tpu_operator_apiserver_requests_total",
)
PROFILE_GAUGE_FAMILIES = (
    "tpu_operator_tsdb_series",
)

# handler span name -> the upgrade state it serves (the profile's "state"
# dimension; spans outside the upgrade pipeline — placement, health-tick,
# apply_state itself — carry ""). Degrades gracefully: an unmapped new
# handler still profiles, just without a state tag.
HANDLER_STATES: Dict[str, str] = {
    "process_done_or_unknown_nodes": "upgrade-done",
    "process_upgrade_required_nodes": "upgrade-required",
    "process_cordon_required_nodes": "cordon-required",
    "process_wait_for_jobs_required_nodes": "wait-for-jobs-required",
    "process_pod_deletion_required_nodes": "pod-deletion-required",
    "process_drain_nodes": "drain-required",
    "process_pod_restart_nodes": "pod-restart-required",
    "process_upgrade_failed_nodes": "upgrade-failed",
    "process_validation_required_nodes": "validation-required",
    "process_uncordon_required_nodes": "uncordon-required",
}


def counting_client(inner, metrics=None, tracer=None, clock=None
                    ) -> CountingClient:
    """The standard flight-recorder wrapping of a client: apiserver-call
    accounting with the ms-range latency ladder. Wrap OUTSIDE any
    ChaosClient so fault decisions see the unmodified call sequence."""
    return CountingClient(inner, metrics=metrics, tracer=tracer,
                          clock=clock,
                          duration_buckets=API_LATENCY_BUCKETS)


def build_profile(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One closed trace's span records → the tick profile dict.

    ``self_total_s + api_total_s`` telescopes back to the root span's
    duration (each span's self time is its duration minus children minus
    attributed apiserver time), so the decomposition is exact under an
    injected clock and within float noise under a real one."""
    by_id = {r["span"]: r for r in records}
    children: Dict[Optional[int], List[Dict[str, Any]]] = {}
    root: Optional[Dict[str, Any]] = None
    for r in records:
        children.setdefault(r["parent"], []).append(r)
        if r["parent"] is None or r["parent"] not in by_id:
            if root is None or r["duration_s"] >= root["duration_s"]:
                root = r
    if root is None:
        return {"trace": None, "duration_s": 0.0, "entries": [],
                "critical_path": [], "self_total_s": 0.0,
                "api_total_s": 0.0, "api_calls": {}, "api_call_count": 0}

    entries: Dict[tuple, Dict[str, Any]] = {}
    self_total = api_total = 0.0
    all_calls: Dict[str, int] = {}
    for r in records:
        kids = children.get(r["span"], [])
        api_s = float(r["attrs"].get("api_time_s", 0.0))
        self_s = max(0.0, r["duration_s"]
                     - sum(k["duration_s"] for k in kids) - api_s)
        comp = str(r["attrs"].get("component", ""))
        key = (comp, r["name"])
        entry = entries.setdefault(key, {
            "component": comp, "handler": r["name"],
            "state": HANDLER_STATES.get(r["name"], ""),
            "spans": 0, "self_s": 0.0, "api_s": 0.0, "api_calls": {}})
        entry["spans"] += 1
        entry["self_s"] += self_s
        entry["api_s"] += api_s
        for call, n in (r["attrs"].get("api_calls") or {}).items():
            entry["api_calls"][call] = entry["api_calls"].get(call, 0) + n
            all_calls[call] = all_calls.get(call, 0) + n
        self_total += self_s
        api_total += api_s

    path: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = root
    while cur is not None:
        path.append({"name": cur["name"],
                     "component": str(cur["attrs"].get("component", "")),
                     "duration_s": cur["duration_s"]})
        kids = children.get(cur["span"], [])
        cur = max(kids, key=lambda k: k["duration_s"]) if kids else None

    return {
        "trace": root["trace"], "start": root["start"],
        "duration_s": root["duration_s"],
        "self_total_s": self_total, "api_total_s": api_total,
        "entries": sorted(entries.values(),
                          key=lambda e: (-(e["self_s"] + e["api_s"]),
                                         e["component"], e["handler"])),
        "critical_path": path,
        "api_calls": all_calls,
        "api_call_count": sum(all_calls.values()),
    }


class TickProfiler(Sink):
    """Span sink that folds each closed trace into a tick profile.

    Tee semantics: ``inner`` (e.g. the ``--trace-log`` JsonlSink) still
    receives every raw record, so turning profiling on never turns the
    trace log off. Only traces whose ROOT span is named ``root_name``
    profile (the reconcile tick); other traces (the slo-tick sibling)
    pass through and are dropped on close. Thread-safe — drain worker
    spans emit concurrently with the reconcile loop's."""

    def __init__(self, inner: Optional[Sink] = None,
                 max_ticks: int = DEFAULT_PROFILE_RING,
                 root_name: Optional[str] = "reconcile-tick",
                 max_open_traces: int = DEFAULT_MAX_OPEN_TRACES):
        self._inner = inner
        self._root_name = root_name
        self._max_ticks = int(max_ticks)
        self._max_open = int(max_open_traces)
        self._lock = threads.make_lock("tick-profiler")
        self._open: Dict[int, List[Dict[str, Any]]] = {}
        self._ring: List[Dict[str, Any]] = []
        self.ticks_profiled = 0

    def emit(self, record: Dict[str, Any]) -> None:
        if self._inner is not None:
            self._inner.emit(record)
        profile = None
        with self._lock:
            self._open.setdefault(record["trace"], []).append(record)
            if record["parent"] is None:  # root closed: trace complete
                records = self._open.pop(record["trace"])
                if (self._root_name is None
                        or record["name"] == self._root_name):
                    profile = build_profile(records)
            elif len(self._open) > self._max_open:
                for trace_id in list(self._open):
                    if trace_id != record["trace"]:
                        del self._open[trace_id]  # abandoned trace
                        break
            if profile is not None:
                self._ring.append(profile)
                if len(self._ring) > self._max_ticks:
                    self._ring.pop(0)
                self.ticks_profiled += 1

    # --------------------------------------------------------------- reads

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def profiles(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def aggregate(self) -> Dict[str, Any]:
        """Merged view over the retained ring: per (component, handler)
        totals plus overall duration/call sums — the 'where do ticks
        spend time lately' table."""
        with self._lock:
            ring = list(self._ring)
        merged: Dict[tuple, Dict[str, Any]] = {}
        duration = self_total = api_total = 0.0
        calls: Dict[str, int] = {}
        for profile in ring:
            duration += profile["duration_s"]
            self_total += profile["self_total_s"]
            api_total += profile["api_total_s"]
            for call, n in profile["api_calls"].items():
                calls[call] = calls.get(call, 0) + n
            for e in profile["entries"]:
                key = (e["component"], e["handler"])
                m = merged.setdefault(key, {
                    "component": e["component"], "handler": e["handler"],
                    "state": e["state"], "spans": 0, "self_s": 0.0,
                    "api_s": 0.0, "api_calls": {}})
                m["spans"] += e["spans"]
                m["self_s"] += e["self_s"]
                m["api_s"] += e["api_s"]
                for call, n in e["api_calls"].items():
                    m["api_calls"][call] = m["api_calls"].get(call, 0) + n
        return {
            "ticks": len(ring), "duration_s": duration,
            "self_total_s": self_total, "api_total_s": api_total,
            "api_calls": calls,
            "entries": sorted(merged.values(),
                              key=lambda e: (-(e["self_s"] + e["api_s"]),
                                             e["component"],
                                             e["handler"])),
        }

    def payload(self, last: int = 8) -> Dict[str, Any]:
        """The ``/profile`` endpoint's data: recent tick profiles plus
        the ring aggregate."""
        with self._lock:
            ring = list(self._ring)
            count = self.ticks_profiled
        return {"ticks_profiled": count,
                "ring_capacity": self._max_ticks,
                "last": ring[-max(1, int(last)):],
                "aggregate": self.aggregate()}
