"""Prometheus text exposition for the serving and training workloads.

A copy, cut to what the batcher, the server's ``/metrics``, the
trainer's goodput ledger, the router tier (``serving/``), the router
binary (``router.py``) and the capacity market (``market/``) call, of
``_Histogram``/``MetricsHub`` from the JAX package's ``obs/metrics.py``
and of the gauge renderer ``render_prometheus_multi`` from
the JAX package's ``upgrade/metrics.py``. Metric names, HELP texts and
the text format are the same, so a scrape of the port reads like a scrape
of the JAX server.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Tuple

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0, 600.0, 1800.0, 3600.0)

# keyed by the FULL exposed name (prefix included), as in the reference
HELP_TEXTS: Dict[str, str] = {
    # training goodput ledger (obs/goodput.py) and its summary gauges
    "tpu_workload_step_duration_seconds":
        "Wall seconds per training step, averaged over one telemetry "
        "sync window (goodput ledger)",
    "tpu_workload_badput_seconds":
        "Non-productive workload seconds by phase (compile, rewarmup, "
        "ckpt_save, drain_save, ckpt_restore)",
    "tpu_workload_tokens_per_s":
        "Training tokens per second over the last synced step window",
    "tpu_workload_mfu":
        "Achieved-vs-peak model-FLOPs utilization over the last synced "
        "step window",
    "tpu_workload_goodput_fraction":
        "Productive fraction of this workload's wall time, from the "
        "goodput ledger summary (1.0 = every second was train steps)",
    "tpu_workload_goodput_seconds":
        "Seconds of productive train-step time in the goodput ledger "
        "summary window",
    "tpu_workload_badput_phase_seconds":
        "Badput seconds by cause phase (compile / rewarmup / ckpt_save "
        "/ drain_save / ckpt_restore / degraded / idle_gap) from the "
        "goodput ledger summary",
    "tpu_workload_serve_ttft_seconds":
        "Seconds from request submit to its first generated token "
        "(queue wait + prefill)",
    "tpu_workload_serve_queue_wait_seconds":
        "Seconds a request waited in the admission queue for a free "
        "decode slot",
    "tpu_workload_serve_inter_token_seconds":
        "Per-token decode latency of one fused batcher chunk (device "
        "call time / ticks)",
    "tpu_workload_serve_step_duration_seconds":
        "Wall seconds of one ContinuousBatcher.step call (admission "
        "prefills + fused decode)",
    "tpu_workload_serve_request_latency_seconds":
        "Seconds from request submit to retirement (prompt + all "
        "generated tokens)",
    "tpu_workload_serve_generated_tokens":
        "Tokens generated per completed request",
    "tpu_workload_serve_slot_occupancy_ratio":
        "Fraction of decode slots running a request, sampled once per "
        "batcher step",
    "tpu_workload_serve_kv_page_utilization_ratio":
        "Fraction of private KV pool blocks allocated to live requests, "
        "sampled once per batcher step",
    "tpu_workload_serve_slots_total":
        "Decode slots this replica serves (the fused-scan batch size)",
    "tpu_workload_serve_slots_busy":
        "Decode slots currently running a request",
    "tpu_workload_serve_queue_depth":
        "Requests admitted but still waiting for a free slot",
    "tpu_workload_serve_requests_submitted":
        "Requests accepted by submit() since process start",
    "tpu_workload_serve_requests_completed":
        "Requests retired with a full result since process start",
    "tpu_workload_serve_requests_handed_off":
        "Queued requests surfaced to a peer replica by the drain handoff",
    "tpu_workload_serve_up":
        "Constant 1 while the serving process is alive",
    "tpu_workload_serve_failed":
        "1 once the stepper thread crashed and the server went "
        "unhealthy, else 0",
    "tpu_workload_serve_draining":
        "1 once the drain began (admission closed), else 0",
    "tpu_workload_spec_accept_ratio":
        "Accepted-draft fraction (accepted / spec_k) per running slot "
        "per speculative round (models/serve.py draft mode)",
    "tpu_workload_weight_stream_gbs":
        "Effective weight-streaming bandwidth of the last decode call "
        "(streamed weight bytes / device seconds; embedding excluded — "
        "the production twin of bench.py's stream probe)",
    "tpu_workload_build_info":
        "Constant 1; labels carry the workload binary's version and "
        "model",
    "tpu_workload_stream_emitted_tokens":
        "Tokens handed to streaming consumers via poll_stream since "
        "process start (each token exactly once, in order)",
    "tpu_workload_stream_backlog_tokens":
        "Generated-but-not-yet-streamed tokens across running requests "
        "at the last poll_stream (stream consumer staleness)",
    # the router tier (serving/): pool, router and autoscaler families
    "tpu_router_replicas":
        "Serving replicas currently registered with the router tier",
    "tpu_router_replicas_admitting":
        "Registered replicas accepting new requests (alive, not "
        "draining, node schedulable/unquarantined)",
    "tpu_router_replicas_draining":
        "Replicas finishing in-flight work with admission stopped "
        "(upgrade, quarantine, reclaim, or scale-down)",
    "tpu_router_replicas_failed":
        "Replicas whose runtime crashed or became unreachable",
    "tpu_router_queue_depth":
        "Requests held at the router waiting for a replica with "
        "headroom",
    "tpu_router_outstanding_requests":
        "Accepted requests not yet completed (router queue + in flight "
        "on replicas)",
    "tpu_router_requests_routed":
        "Requests placed on a replica at least once since router start",
    "tpu_router_requests_completed":
        "Requests delivered exactly once since router start",
    "tpu_router_requests_rerouted":
        "Request re-placements after a drain handoff or replica "
        "failure (each re-placement counts once)",
    "tpu_router_scale_target":
        "The autoscaler's current desired replica count",
    "tpu_router_scale_ups":
        "Autoscaler scale-up decisions since router start",
    "tpu_router_scale_downs":
        "Autoscaler scale-down decisions since router start",
    "tpu_router_handoff_requests":
        "Queued-but-never-admitted requests migrated to peers per drain "
        "handoff",
    "tpu_router_replica_queue_depth":
        "Scraped per-replica admission queue depth, sampled once per "
        "router scrape cycle",
    "tpu_router_migration_attempts":
        "KV payload transfer attempts for in-flight live migrations "
        "since router start (every retry counts once)",
    "tpu_router_migration_success":
        "In-flight requests successfully live-migrated to a peer "
        "(adopted, stream resumed from the last acked sequence number)",
    "tpu_router_migration_fallbacks":
        "Migrations that exhausted the transfer budget or were rejected "
        "by every peer and fell back to re-prefill-from-prompt at "
        "degraded priority (slower, never lost)",
    "tpu_router_migration_transfer_seconds":
        "Seconds one successful KV payload transfer + adoption took "
        "(per-request migration downtime contribution)",
    "tpu_router_migration_transfer_bytes":
        "Serialized KV payload bytes per successful migration transfer",
    "tpu_router_lane_queue_depth":
        "Requests queued at the router by QoS lane (interactive / "
        "batch / best-effort)",
    "tpu_router_lane_shed":
        "Requests dropped by overload shedding since router start, by "
        "lane (best-effort sheds first; interactive never sheds)",
    "tpu_router_lane_completed":
        "Requests delivered since router start, by QoS lane",
    "tpu_router_lane_queue_wait_seconds":
        "Seconds a request waited at the router before its first "
        "placement, by QoS lane (the per-tenant queueing SLI)",
    # the request flight recorder of the router binary (obs/reqtrace.py)
    "tpu_router_request_stage_seconds":
        "Seconds one request dwelt in one lifecycle stage (admitted / "
        "queued / prefill / streaming / drain / splice / ...), by stage "
        "and QoS lane; per request the stage dwells partition the "
        "measured latency exactly (docs/observability.md \"Request "
        "tracing & servebench\")",
    "tpu_router_proxy_overhead_seconds":
        "REAL router self-time per completed request — the accept / "
        "route / relay / reseq / splice segments measured on a "
        "performance counter, by QoS lane (the servebench "
        "proxy_overhead_p99_ms headline; SERVE_r01 budget-gated)",
    "tpu_router_traces_open":
        "Request trace timelines currently open in the flight "
        "recorder's bounded table",
    "tpu_router_traces_closed":
        "Request trace timelines closed (terminal stage reached) since "
        "router start; the last ring_capacity of them serve /requests "
        "and /trace?rid=",
    "tpu_router_traces_dropped":
        "Open trace timelines evicted by the fixed-memory bound before "
        "reaching a terminal stage (cumulative migration counters stay "
        "truthful anyway)",
    # the capacity market (market/arbiter.py): the exchange between
    # training and serving
    "tpu_market_exchange_rate":
        "Serving pressure divided by marginal training value — the "
        "price at which the arbiter trades slices (docs/"
        "capacity-market.md)",
    "tpu_market_serving_pressure":
        "Demand-side pressure: the worse of the serving SLO burn-rate "
        "multiple and the lane-weighted router backlog",
    "tpu_market_training_value":
        "Supply-side marginal value: normalized goodput one training "
        "slice contributes (from the goodput ledger)",
    "tpu_market_trades":
        "Training slices preempted to serving since arbiter start",
    "tpu_market_returns":
        "Traded slices returned to training since arbiter start",
    "tpu_market_slices_lent":
        "Managed slices currently owned by serving (lent or mid-trade)",
    # the root-cause engine (obs/causes.py)
    "tpu_operator_alert_attributed_total":
        "Firing alerts root-caused by the cause engine, by rule and "
        "top-ranked cause kind (kind=\"none\" when the burn window "
        "held no candidate events)",
}

# migration KV payload sizes: a tiny test config exports a few KiB, a
# production 70B-class slot is hundreds of MiB
TRANSFER_BYTES_BUCKETS: Tuple[float, ...] = (
    1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 4e9)

# router-tier depth histograms (requests per drain handoff, scraped
# per-replica queue depths), from 0 so an always-empty queue shows
QUEUE_DEPTH_BUCKETS: Tuple[float, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 128, 256)


def help_for(metric: str, default: Optional[str] = None) -> str:
    text = HELP_TEXTS.get(metric)
    if text is not None:
        return text
    return default if default is not None else metric.replace("_", " ")


def _fmt_float(v: float) -> str:
    """Integers without the trailing .0, everything else via repr."""
    if v == float("inf"):
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{escape_label_value(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def render_gauges(per_component: Dict[str, Dict[str, float]],
                  prefix: str) -> str:
    """Gauges of several components under one family set, one
    ``component`` label each (the reference's ``render_prometheus_multi``)."""
    names = sorted({name for metrics in per_component.values()
                    for name in metrics})
    lines = []
    for name in names:
        metric = _INVALID.sub("_", f"{prefix}_{name}")
        fallback = _INVALID.sub("_", name).replace("_", " ")
        lines.append(f"# HELP {metric} {help_for(metric, default=fallback)}")
        lines.append(f"# TYPE {metric} gauge")
        for component in sorted(per_component):
            metrics = per_component[component]
            if name in metrics:
                value = escape_label_value(str(component))
                lines.append(
                    f'{metric}{{component="{value}"}} {metrics[name]}')
    return "\n".join(lines) + "\n" if lines else ""


class _Histogram:
    """One histogram family: fixed buckets, one series per label set."""

    def __init__(self, name: str, buckets: Tuple[float, ...]):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.series: Dict[Tuple[Tuple[str, str], ...],
                          Tuple[List[int], float]] = {}

    def observe(self, value: float, labels: Dict[str, str]) -> None:
        key = tuple(sorted(labels.items()))
        counts, total = self.series.get(key) or (
            [0] * (len(self.buckets) + 1), 0.0)
        counts[bisect.bisect_left(self.buckets, value)] += 1
        self.series[key] = (counts, total + value)

    def count(self) -> int:
        return sum(sum(counts) for counts, _ in self.series.values())

    def render(self, full_name: str) -> List[str]:
        lines = [f"# HELP {full_name} {help_for(full_name)}",
                 f"# TYPE {full_name} histogram"]
        for key in sorted(self.series):
            counts, total = self.series[key]
            labels = dict(key)
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                le = 'le="%s"' % _fmt_float(bound)
                lines.append(f"{full_name}_bucket"
                             f"{_label_str(labels, le)} {cumulative}")
            cumulative += counts[-1]
            inf_le = 'le="+Inf"'
            lines.append(f"{full_name}_bucket"
                         f"{_label_str(labels, inf_le)} {cumulative}")
            lines.append(f"{full_name}_sum{_label_str(labels)} "
                         f"{_fmt_float(total)}")
            lines.append(f"{full_name}_count{_label_str(labels)} "
                         f"{cumulative}")
        return lines


class MetricsHub:
    """Process-local registry of histogram, gauge and counter families.
    Thread-safe: the server's stepper thread writes while handlers
    render."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[str, _Histogram] = {}
        self._gauges: Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                     float]] = {}
        # cumulative counters (rendered TYPE counter, names *_total)
        self._counters: Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                       float]] = {}

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Tuple[float, ...]] = None) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Histogram(
                    name, buckets or DEFAULT_BUCKETS)
            hist.observe(float(value), labels or {})

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            series = self._gauges.setdefault(name, {})
            series[tuple(sorted((labels or {}).items()))] = float(value)

    def inc(self, name: str, by: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        """Increment a cumulative counter family (named ``*_total``)."""
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + float(by)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, {}).get(
                tuple(sorted((labels or {}).items())))

    def get_histogram(self, name: str) -> Optional[_Histogram]:
        with self._lock:
            return self._hists.get(name)

    def render(self, prefix: str = "tpu_workload") -> str:
        """Text exposition of every family, name-sorted, HELP/TYPE once
        per family."""
        with self._lock:
            names = sorted(set(self._hists) | set(self._gauges)
                           | set(self._counters))
            lines: List[str] = []
            for name in names:
                full = f"{prefix}_{name}" if prefix else name
                if name in self._hists:
                    lines.extend(self._hists[name].render(full))
                    continue
                counter = name in self._counters
                series = (self._counters if counter else self._gauges)[name]
                lines.append(f"# HELP {full} {help_for(full)}")
                lines.append(f"# TYPE {full} "
                             f"{'counter' if counter else 'gauge'}")
                for key in sorted(series):
                    lines.append(f"{full}{_label_str(dict(key))} "
                                 f"{_fmt_float(series[key])}")
        return "\n".join(lines) + "\n" if lines else ""
