"""Prometheus text exposition for the serving and training workloads.

A copy, cut to what the batcher, the server's ``/metrics``, the
trainer's goodput ledger, the router tier (``serving/``), the router
binary (``router.py``), the capacity market (``market/``) and the
operator with its health, SLO stack and usage meter (``gpu/operator.py``,
``health/``, ``obs/tsdb.py`` reading :meth:`MetricsHub.snapshot`) call,
of ``_Histogram``/``MetricsHub`` from the JAX package's ``obs/metrics.py``
and of the gauge renderer ``render_prometheus_multi`` from
the JAX package's ``upgrade/metrics.py``. Metric names, HELP texts and
the text format are the same, so a scrape of the port reads like a scrape
of the JAX server.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

from ..utils import threads

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0, 600.0, 1800.0, 3600.0)

# keyed by the FULL exposed name (prefix included), as in the reference
HELP_TEXTS: Dict[str, str] = {
    # the operator binary's identity gauges and the client-boundary
    # accounting (core/client.py:CountingClient)
    "tpu_operator_build_info":
        "Constant 1; labels carry the operator version and managed "
        "components",
    "tpu_operator_leader":
        "1 on the replica holding the leader lease (or running without "
        "leader election), 0 on hot standbys",
    "tpu_operator_apiserver_requests_total":
        "Apiserver requests issued through the client boundary since "
        "process start, by verb and kind",
    "tpu_operator_apiserver_request_duration_seconds":
        "Seconds one apiserver request took at the client boundary "
        "(CountingClient middleware; labels carry verb and kind)",
    # upgrade gauges (upgrade/metrics.py collect()) and the upgrade
    # histograms and gauges of the journey and the drain manager
    "tpu_operator_total_managed_nodes":
        "Nodes joined with a managed driver pod this reconcile tick",
    "tpu_operator_upgrades_in_progress":
        "Nodes between admission and done/failed in the upgrade pipeline",
    "tpu_operator_upgrades_done":
        "Nodes whose driver upgrade completed (state upgrade-done)",
    "tpu_operator_upgrades_failed":
        "Nodes parked in upgrade-failed awaiting recovery",
    "tpu_operator_upgrades_pending":
        "Nodes in upgrade-required waiting for an admission slot",
    "tpu_operator_unavailable_nodes":
        "Nodes currently cordoned or not Ready (maxUnavailable arithmetic)",
    "tpu_operator_nodes_in_state_unknown":
        "Nodes with no upgrade-state label yet",
    "tpu_operator_nodes_in_state_upgrade_required":
        "Nodes in state upgrade-required",
    "tpu_operator_nodes_in_state_cordon_required":
        "Nodes in state cordon-required",
    "tpu_operator_nodes_in_state_wait_for_jobs_required":
        "Nodes in state wait-for-jobs-required",
    "tpu_operator_nodes_in_state_pod_deletion_required":
        "Nodes in state pod-deletion-required",
    "tpu_operator_nodes_in_state_drain_required":
        "Nodes in state drain-required",
    "tpu_operator_nodes_in_state_pod_restart_required":
        "Nodes in state pod-restart-required",
    "tpu_operator_nodes_in_state_validation_required":
        "Nodes in state validation-required",
    "tpu_operator_nodes_in_state_uncordon_required":
        "Nodes in state uncordon-required",
    "tpu_operator_nodes_in_state_upgrade_done":
        "Nodes in state upgrade-done",
    "tpu_operator_nodes_in_state_upgrade_failed":
        "Nodes in state upgrade-failed",
    "tpu_operator_phase_duration_seconds":
        "Seconds a node spent in an upgrade-pipeline state, observed at "
        "the transition out of it (journey choke point)",
    "tpu_operator_drain_duration_seconds":
        "Seconds one successful node drain took (cordon excluded)",
    "tpu_operator_stuck_nodes":
        "Nodes dwelling in an upgrade state beyond its stuck threshold",
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
    # the operator's own families (gpu/operator.py), fleet health
    # (health/), the resilient client (core/resilience.py), the SLO
    # stack (obs/tsdb.py, obs/slo.py, obs/alerts.py), the usage meter
    # (obs/usage.py) and the scheduler's placement latency
    "tpu_operator_health_monitored_nodes":
        "Nodes in scope of the fleet-health monitor this tick",
    "tpu_operator_health_monitored_slices":
        "Slices (failure domains) rolled up by the health "
        "classifier",
    "tpu_operator_health_quarantined_nodes":
        "Nodes currently under the health-quarantine label",
    "tpu_operator_health_quarantined_slices":
        "Slices currently quarantined",
    "tpu_operator_health_repairs_in_flight":
        "Slices with a repair riding the upgrade pipeline right now",
    "tpu_operator_health_repairs_injected":
        "Slice repairs injected into the upgrade pipeline this tick",
    "tpu_operator_health_driver_pods_restarted":
        "Failing driver pods deleted at the quiesced restart "
        "barrier this tick",
    "tpu_operator_health_quarantines_deferred":
        "Quarantines deferred this tick to honor the availability "
        "budget",
    "tpu_operator_health_probe_errors":
        "Probes that raised this tick (isolated, not fatal)",
    "tpu_operator_health_masked":
        "1 while the health report is a degraded-mode re-"
        "publication of stale verdicts (control plane unreachable; "
        "remediation suspended)",
    "tpu_operator_health_nodes_verdict_healthy":
        "Nodes with verdict healthy",
    "tpu_operator_health_nodes_verdict_degraded":
        "Nodes with verdict degraded (signal inside the damping "
        "window)",
    "tpu_operator_health_nodes_verdict_unhealthy_transient":
        "Nodes with verdict unhealthy-transient (quarantined, may "
        "recover)",
    "tpu_operator_health_nodes_verdict_unhealthy_persistent":
        "Nodes with verdict unhealthy-persistent (handed to repair)",
    "tpu_operator_health_slices_verdict_healthy":
        "Slices with rolled-up verdict healthy",
    "tpu_operator_health_slices_verdict_degraded":
        "Slices with rolled-up verdict degraded",
    "tpu_operator_health_slices_verdict_unhealthy_transient":
        "Slices with rolled-up verdict unhealthy-transient",
    "tpu_operator_health_slices_verdict_unhealthy_persistent":
        "Slices with rolled-up verdict unhealthy-persistent",
    "tpu_operator_reconcile_tick_duration_seconds":
        "Wall seconds one full TPUOperator reconcile tick took",
    "tpu_operator_placement_latency_seconds":
        "Seconds SliceScheduler.place() took to bind a workload to "
        "its slices",
    "tpu_operator_health_reaction_seconds":
        "Seconds from a slice first leaving healthy to its "
        "quarantine",
    "tpu_operator_tsdb_series":
        "In-process tsdb series by state: active (retained rings) "
        "and evicted (writes refused at the series cap)",
    "tpu_operator_obs_scrape_duration_seconds":
        "Seconds the per-tick tsdb scrape of the hub snapshot and "
        "gauge collectors took — observability overhead, itself "
        "observable",
    "tpu_operator_apiserver_breaker_state":
        "Apiserver circuit breaker state: 0 closed, 1 half-open "
        "(probing), 2 open (calls shed)",
    "tpu_operator_apiserver_retries_total":
        "Idempotent reads transparently retried after a 5xx/timeout"
        " at the resilient client boundary, by verb",
    "tpu_operator_apiserver_shed_total":
        "Calls shed instantly by the open circuit breaker instead "
        "of touching the dead apiserver, by verb",
    "tpu_operator_apiserver_rate_limited_total":
        "429 Retry-After responses that engaged the adaptive rate "
        "limiter (apiserver priority & fairness; PDB eviction 429s "
        "excluded)",
    "tpu_operator_degraded":
        "1 while the operator is in fail-static DEGRADED mode "
        "(breaker open: state-advancing writes suspended, reads "
        "stale, health masked)",
    "tpu_operator_degraded_staleness_seconds":
        "Age of the stale cache the degraded operator is serving "
        "reads from (seconds since the last fresh tick)",
    "tpu_operator_degraded_safety_retries_total":
        "In-flight safety writes (uncordon, quarantine-lift "
        "completion) retried during degraded mode; their outcomes "
        "double as breaker probes",
    "tpu_operator_slo_error_budget_remaining":
        "Fraction of the SLO's rolling-window error budget still "
        "unspent (1 = untouched, 0 = exhausted, negative = "
        "overspent)",
    "tpu_operator_slo_burn_rate":
        "Error-budget burn rate over the fastest long window (1 = "
        "spending exactly the budget over the SLO window)",
    "tpu_operator_alert_firing":
        "1 while the burn-rate alert rule is firing (past its for: "
        "duration), else 0",
    "tpu_operator_usage_seconds_total":
        "Capacity seconds attributed per usage kind and serving "
        "lane; per tick the attributed seconds sum EXACTLY to nodes"
        " x tick seconds (the conservation law, "
        "docs/observability.md \"Utilization & cost accounting\")",
    "tpu_operator_usage_efficiency":
        "Cumulative productive fraction of fleet capacity: serving "
        "+ training seconds over all attributed seconds",
    "tpu_operator_usage_capacity_nodes":
        "Nodes whose capacity the usage meter attributed last tick",
    "tpu_operator_usage_fleet_goodput_fraction":
        "Fleet goodput headline: serving seconds plus training "
        "seconds discounted by the trainer's goodput fraction, over"
        " capacity seconds",
}

# apiserver-call latencies: a fake apiserver answers in microseconds, a
# live one in milliseconds to seconds
API_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0)

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
        self._lock = threads.make_lock("metrics-hub")
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

    def histogram_families(self) -> List[str]:
        with self._lock:
            return sorted(self._hists)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy for the tsdb scraper (names unprefixed, as
        stored): ``{"gauges": {name: [(labels, value), ...]},
        "counters": same shape (cumulative values), "histograms": {name:
        [(labels, [(le, cumulative_count), ... (+Inf, total)], sum,
        count), ...]}}``."""
        with self._lock:
            gauges = {name: [(dict(key), value)
                             for key, value in series.items()]
                      for name, series in self._gauges.items()}
            counters = {name: [(dict(key), value)
                               for key, value in series.items()]
                        for name, series in self._counters.items()}
            hists: Dict[str, list] = {}
            for name, hist in self._hists.items():
                fam = []
                for key, (counts, total) in hist.series.items():
                    cumulative = 0
                    cum = []
                    for bound, c in zip(hist.buckets, counts):
                        cumulative += c
                        cum.append((bound, cumulative))
                    cumulative += counts[-1]
                    cum.append((float("inf"), cumulative))
                    fam.append((dict(key), cum, total, cumulative))
                hists[name] = fam
        return {"gauges": gauges, "counters": counters,
                "histograms": hists}

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
