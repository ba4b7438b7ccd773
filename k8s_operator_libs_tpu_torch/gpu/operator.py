"""The thin GPU operator: a ready-made reconcile driver over the libraries.

GPU twin of the JAX package's ``tpu/operator.py`` (``TPUOperator``). One
object that, per reconcile tick,

1. runs the upgrade state machine for each managed driver component (the
   NVIDIA driver, the device plugin) with clique-atomic grouping
   (``gpu/topology.py:GPUNodeGrouper``: a multi-node NVLink domain is one
   group, any other node its own),
2. runs fleet health (probe, classify, quarantine, repair through the
   upgrade pipeline), the stuck-node detectors, placement of pending GPU
   workloads through ``gpu/scheduler.py:GPUScheduler``, the usage meter,
   and last the SLO scrape and evaluation,

in the reference's order, with its fail-static degraded mode. Where the
reference groups by ICI slice, deletes pods holding ``google.com/tpu``
and links ``node/<n>`` to ``slice/<nodepool>``, this one groups by
clique, deletes pods holding ``nvidia.com/gpu`` and links ``node/<n>``
to ``clique/<id>``. Everything is injected, so it runs against the fake
apiserver in tests and a real client in production.

The port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import types
from typing import Dict, List, Optional

from ..api.v1alpha1 import DriverUpgradePolicySpec
from ..core.client import ApiError, Client, EventRecorder
from ..core.resilience import BreakerOpenError, ResilientClient
from ..upgrade.consts import UpgradeState
from ..wire import (LANE_LABEL, MARKET_OWNER_LABEL,
                    PRE_QUARANTINE_CORDON_ANNOTATION, QUARANTINE_LABEL,
                    QUARANTINE_LIFT_ANNOTATION,
                    QUARANTINE_REASON_ANNOTATION, QUARANTINE_TAINT_KEY,
                    REPAIR_ANNOTATION, REPLICA_ID_LABEL)
from ..health import metrics as health_metrics
from ..health.consts import HealthVerdict
from ..health.monitor import (FleetHealthMonitor, HealthOptions,
                              HealthReport)
from ..obs.alerts import AlertManager
from ..obs.causes import CauseAnalyzer
from ..obs.journey import StuckNodeDetector
from ..obs.metrics import API_LATENCY_BUCKETS
from ..obs.slo import SLOEngine, SLOOptions
from ..obs.timeline import FleetTimeline
from ..obs.tsdb import TimeSeriesStore
from ..obs.usage import MAINTENANCE_STATES, NodeSignals, UsageMeter
from ..upgrade import metrics as upgrade_metrics
from ..upgrade.groups import GroupPolicy
from ..upgrade.upgrade_state import ClusterUpgradeStateManager
from ..upgrade.util import KeyFactory, log_event
from ..utils.clock import Clock, RealClock
from .device_plugin import gpu_workload_deletion_filter
from .scheduler import GPUScheduler, GPUWorkload, Placement
from .topology import CLIQUE_LABEL, GPUNodeGrouper

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ManagedComponent:
    """One driver DaemonSet family under upgrade management."""

    name: str                      # e.g. "gpu"
    namespace: str                 # where its DaemonSet lives
    driver_labels: Dict[str, str]  # selects the DS + its pods
    policy: DriverUpgradePolicySpec


class GPUOperator:
    def __init__(self, client: Client,
                 components: List[ManagedComponent],
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 group_policy: Optional[GroupPolicy] = None,
                 synchronous: bool = False,
                 health: Optional[HealthOptions] = None,
                 tracer=None, metrics=None,
                 stuck_thresholds: Optional[Dict[str, float]] = None,
                 slo: Optional[SLOOptions] = None,
                 shard_workers: int = 0, shard_parallel: bool = True,
                 verify_incremental: bool = False,
                 resilience: Optional[ResilientClient] = None,
                 timeline: Optional[FleetTimeline] = None,
                 usage: Optional[UsageMeter] = None):
        self.client = client
        self.components = components
        self.clock = clock or RealClock()
        self.recorder = recorder
        # observability (obs/): the tracer draws the reconcile-tick span
        # tree, the MetricsHub collects the duration histograms and stuck
        # gauges, and one stuck detector per component reads the journeys
        # the state providers persist. All optional (None = off) except the
        # journey annotations themselves, which are always recorded.
        self.tracer = tracer
        self.metrics = metrics
        # fleet black box (obs/timeline.py): one unified causal event
        # store every subsystem records into at its choke point. Always
        # on (like the journey annotations) — it is fixed-memory and
        # lock-free, so a library consumer pays one bounded ring.
        self.timeline = timeline or FleetTimeline(clock=self.clock)
        # fleet ledger (obs/usage.py): every node-second this tick joined
        # lands in exactly one usage bucket — conservation-checked
        # utilization accounting, optionally billed to a durable ledger
        self.usage = usage
        self.scheduler = GPUScheduler(client, metrics=metrics,
                                      clock=self.clock)
        self._pending: List[GPUWorkload] = []
        self.placements: List[Placement] = []
        # one state manager per component — instance-scoped keys make this
        # possible in one process (unlike the reference's DriverName global)
        self.managers: Dict[str, ClusterUpgradeStateManager] = {}
        self.stuck_detectors: Dict[str, StuckNodeDetector] = {}
        self.last_stuck: Dict[str, dict] = {}
        # fail-static degraded mode (docs/resilience.md): when the
        # resilient client boundary's circuit breaker opens, the
        # operator suspends state-ADVANCING writes, serves stale reads,
        # masks health verdicts, and keeps retrying only the in-flight
        # safety writes until the breaker closes again
        self.resilience = resilience
        if resilience is not None:
            bind = getattr(resilience, "bind_timeline", None)
            if bind is not None:
                # breaker open/close edges land on the same timeline
                bind(self.timeline)
        self.degraded = False
        self.degraded_since: Optional[float] = None
        self._last_fresh = self.clock.now()
        all_keys = {comp.name: KeyFactory(comp.name) for comp in components}
        self._all_keys = all_keys
        for comp in components:
            # sibling_keys: the other components on the same nodes — the
            # state machine coordinates admission attribution and uncordon
            # deferral across them (see upgrade_state.py SIBLING_BLOCKING)
            mgr = ClusterUpgradeStateManager(
                client, all_keys[comp.name], recorder,
                self.clock, grouper=GPUNodeGrouper(),
                group_policy=group_policy, synchronous=synchronous,
                sibling_keys=[k for name, k in all_keys.items()
                              if name != comp.name],
                metrics=metrics, tracer=tracer,
                shard_workers=shard_workers, shard_parallel=shard_parallel,
                timeline=self.timeline)
            mgr.verify_incremental = verify_incremental
            if comp.policy.pod_deletion is not None:
                # delete exactly the pods holding GPUs before drain
                mgr.with_pod_deletion_enabled(gpu_workload_deletion_filter)
            self.managers[comp.name] = mgr
            keys = all_keys[comp.name]
            self.stuck_detectors[comp.name] = StuckNodeDetector(
                client, component=comp.name,
                state_label=keys.state_label,
                annotation_key=keys.journey_annotation,
                stuck_key=keys.stuck_reported_annotation,
                thresholds=stuck_thresholds, recorder=recorder,
                clock=self.clock, metrics=metrics)
        # fleet health: probe → classify → quarantine → clique-atomic
        # repair through one component's upgrade pipeline; shares the
        # clique grouper so health and upgrades agree on failure
        # domains, and the repair component's KeyFactory so injected repairs
        # ride the exact same state machine and availability budget
        self.health_monitor: Optional[FleetHealthMonitor] = None
        self.last_health: Optional[HealthReport] = None
        self.health_component: Optional[str] = None
        self._prev_verdicts: Dict[str, str] = {}
        if health is not None:
            repair_comp = next(
                (c for c in components if c.name == health.component),
                components[0])
            self.health_component = repair_comp.name
            self.health_monitor = FleetHealthMonitor(
                client, all_keys[repair_comp.name],
                namespace=repair_comp.namespace,
                driver_labels=repair_comp.driver_labels,
                grouper=GPUNodeGrouper(), recorder=recorder,
                clock=self.clock, options=health, metrics=metrics)
        # SLO layer (obs/slo.py): the tsdb scrapes the hub + gauge
        # collectors once per tick, the engine turns the history into
        # error budgets and burn rates, and the alert manager drives
        # pending -> firing -> resolved with Kubernetes Events. All of it
        # lives strictly AFTER the reconcile work in the tick — a failed
        # evaluation can never wedge an upgrade.
        self.tsdb: Optional[TimeSeriesStore] = None
        self.slo_engine: Optional[SLOEngine] = None
        self.alert_manager: Optional[AlertManager] = None
        self.cause_analyzer: Optional[CauseAnalyzer] = None
        self.last_slo: Dict[str, dict] = {}
        self._slo_options = slo
        if slo is not None:
            self.tsdb = TimeSeriesStore(
                clock=self.clock, raw_points=slo.raw_points,
                downsample_every=slo.downsample_every,
                coarse_points=slo.coarse_points)
            self.slo_engine = SLOEngine(self.tsdb, slo.specs,
                                        clock=self.clock, metrics=metrics)
            # root-cause engine (obs/causes.py): the alert manager hands
            # it every pending→firing edge; it walks the timeline + the
            # entity graph backwards over the burn window
            self.cause_analyzer = CauseAnalyzer(
                self.timeline, specs=self.slo_engine.specs,
                clock=self.clock, metrics=metrics)
            self.alert_manager = AlertManager(clock=self.clock,
                                              metrics=metrics,
                                              recorder=recorder,
                                              causes=self.cause_analyzer,
                                              timeline=self.timeline)

    # ---------------------------------------------------------- workloads

    def submit(self, workload: GPUWorkload) -> None:
        """Queue a workload for placement. Validates up front so a malformed
        workload is rejected at the API boundary instead of poisoning every
        subsequent reconcile tick."""
        if workload.num_slices < 1:
            raise ValueError(f"workload {workload.name}: num_slices must be "
                             f">= 1, got {workload.num_slices}")
        if workload.num_nodes < 1:
            raise ValueError(f"workload {workload.name}: num_nodes must be "
                             f">= 1, got {workload.num_nodes}")
        self._pending.append(workload)

    @property
    def pending_workloads(self) -> List[GPUWorkload]:
        return list(self._pending)

    # ---------------------------------------------------------- reconcile

    def reconcile(self) -> Dict[str, Optional[object]]:
        """One tick: upgrade pipeline per component, then placement of
        pending workloads. Errors from one component don't starve the others
        (each reconcile is idempotent; the next tick retries).

        The whole tick is one trace: a ``reconcile-tick`` root span with
        child spans per component ``apply_state`` (whose handler passes are
        grandchildren — upgrade_state.py), the health tick, stuck-node
        detection, and placement; tick wall time feeds the
        ``reconcile_tick_duration_seconds`` histogram.

        Returns {component name: the ClusterUpgradeState this tick acted on,
        or None if its reconcile raised} — consumers render metrics and
        health from it without re-listing the cluster.

        Fail-static gate: when a resilient client boundary is wired and
        its circuit breaker is not closed, the tick runs in DEGRADED mode
        instead — no state-advancing writes, stale reads, masked health,
        safety retries only — until a successful probe closes the breaker,
        at which point the informers resync and one full-rebuild tick
        resumes the state machine where the durable labels say it was."""
        if self.resilience is not None:
            if not self.degraded and not self.resilience.breaker.is_closed:
                self._enter_degraded()
            if self.degraded and not self._degraded_tick():
                return {comp.name: None for comp in self.components}
            # breaker closed (possibly just now): fall through into a
            # normal, fully-rebuilt tick
        t0 = self.clock.now()
        states: Dict[str, Optional[object]] = {}
        with self._span("reconcile-tick", components=len(self.components)):
            # informer-backed read path (core/cachedclient.py): advance the
            # pumped caches once, then drain the per-kind dirty sets that
            # feed each component's incremental BuildState — the tick's
            # work becomes proportional to what changed, not to fleet size
            deltas = None
            pump = getattr(self.client, "pump", None)
            drain_deltas = getattr(self.client, "drain_deltas", None)
            if pump is not None:
                with self._span("cache-pump"):
                    pump()
            if drain_deltas is not None:
                deltas = drain_deltas()
            for comp in self.components:
                mgr = self.managers[comp.name]
                with self._span("apply_state", component=comp.name):
                    try:
                        state = mgr.build_state(comp.namespace,
                                                comp.driver_labels,
                                                deltas=deltas)
                        mgr.apply_state(state, comp.policy)
                        states[comp.name] = state
                    except ApiError as exc:
                        logger.exception("upgrade reconcile failed for %s",
                                         comp.name)
                        states[comp.name] = None
                        if (isinstance(exc, BreakerOpenError)
                                and self.resilience is not None
                                and not self.degraded):
                            # the breaker opened mid-tick: every later
                            # phase would trade on the same dead
                            # apiserver — fail static NOW, not next tick
                            # (remaining components, health, placement
                            # and SLO all wait for the degraded loop)
                            self._enter_degraded()
                            for rest in self.components:
                                states.setdefault(rest.name, None)
                            return states
                    except Exception:  # exc: allow — per-component isolation: one component's bug must not starve the others (next tick retries idempotently)
                        logger.exception("upgrade reconcile failed for %s",
                                         comp.name)
                        states[comp.name] = None
            # health tick AFTER the upgrade pass (its driver-pod restarts
            # leave a DS-pod-count mismatch that BuildState refuses until
            # the controller recreates the pod) and BEFORE placement (a
            # group quarantined this tick must not receive this tick's
            # workloads)
            if self.health_monitor is not None:
                with self._span("health-tick"):
                    try:
                        self.last_health = self.health_monitor.tick()
                    except Exception:  # exc: allow — health-tick isolation: the monitor classifies ApiError itself (masked report); a probe bug must not stop upgrades or placement
                        logger.exception("health tick failed; upgrades and "
                                         "placement continue")
                self._emit_verdict_change_events()
            with self._span("stuck-detection"):
                self._check_stuck_nodes(states)
            still_pending: List[GPUWorkload] = []
            with self._span("placement", pending=len(self._pending)):
                for wl in self._pending:
                    # per-workload isolation: one failing placement must not
                    # starve upgrades or the other workloads (mirrors the
                    # per-component try/except above)
                    try:
                        placement = self.scheduler.place(wl)
                    except ApiError:
                        # classified: pod create/delete failed against
                        # the apiserver — keep the workload pending and
                        # let the breaker see the failure shape
                        logger.exception("placement of workload %s failed; "
                                         "keeping it pending", wl.name)
                        still_pending.append(wl)
                        continue
                    except Exception:  # exc: allow — per-workload isolation: a scheduler bug on one workload must not starve upgrades or the other workloads
                        logger.exception("placement of workload %s failed; "
                                         "keeping it pending", wl.name)
                        still_pending.append(wl)
                        continue
                    if placement is None:
                        still_pending.append(wl)
                    else:
                        logger.info("placed workload %s on %s", wl.name,
                                    placement.slice_id)
                        self.placements.append(placement)
            self._pending = still_pending
            # fleet ledger: attribute this tick's capacity off the nodes
            # the tick already joined (no extra LISTs) — BEFORE the SLO
            # scrape so the usage gauges land in this tick's tsdb sample
            if self.usage is not None:
                with self._span("usage-tick"):
                    # a tick where NO component state built (apiserver
                    # dying, breaker not yet open) saw nothing — the
                    # fleet didn't shrink to zero, we were blind. Skip
                    # the observation and leave the span open: the next
                    # real (or degraded) tick attributes it, so the
                    # capacity seconds never silently vanish
                    blind = (bool(self.components)
                             and all(s is None for s in states.values()))
                    try:
                        if not blind:
                            self.usage.observe(
                                self._usage_signals(states))
                    except Exception:  # exc: allow — usage accounting is observability; a meter bug must not stop the tick
                        logger.exception("usage tick failed; reconcile "
                                         "result unaffected")
        self._last_fresh = self.clock.now()
        if self.metrics is not None:
            self.metrics.set_gauge("degraded", 0.0)
            self.metrics.set_gauge("degraded_staleness_seconds", 0.0)
            self.metrics.observe("reconcile_tick_duration_seconds",
                                 max(0.0, self.clock.now() - t0))
        if self.slo_engine is not None:
            with self._span("slo-tick"):
                try:
                    self._slo_tick(states)
                except Exception:  # exc: allow — SLO evaluation is observability; it must never affect the reconcile result
                    logger.exception("SLO tick failed; reconcile result "
                                     "unaffected")
        return states

    # ----------------------------------------------------- degraded mode
    #
    # Fail-static (docs/resilience.md): when the control plane is sick,
    # the data plane must not notice. The breaker tells us the apiserver
    # is down; the operator then (a) stops issuing state-ADVANCING writes
    # (new cordons, drains, repairs — nothing new leaves service), (b)
    # serves stale cached reads with an explicit staleness gauge, (c)
    # masks health verdicts (stale data must never quarantine a healthy
    # fleet), and (d) keeps retrying only the in-flight SAFETY writes —
    # uncordon decrees and quarantine-lift completions, both capacity-
    # RETURNING and already durably decided — whose outcomes double as
    # the breaker's recovery probes.

    def staleness_seconds(self) -> float:
        """Age of the stale cache being served (0 while fresh) — the
        degraded-staleness gauge's value, for status surfaces."""
        if not self.degraded:
            return 0.0
        return max(0.0, self.clock.now() - self._last_fresh)

    def _operator_obj(self):
        return types.SimpleNamespace(
            kind="GPUOperator",
            metadata=types.SimpleNamespace(
                name="-".join(c.name for c in self.components)
                or "gpu-operator"))

    def _enter_degraded(self) -> None:
        self.degraded = True
        self.degraded_since = self.clock.now()
        logger.warning(
            "apiserver circuit breaker %s: entering fail-static DEGRADED "
            "mode (state-advancing writes suspended; safety writes keep "
            "retrying)", self.resilience.breaker.state)
        if self.metrics is not None:
            self.metrics.set_gauge("degraded", 1.0)
        self.timeline.record_event(
            kind="degraded-enter", entity="operator/self",
            detail=f"breaker {self.resilience.breaker.state}: "
                   f"fail-static, writes suspended")
        log_event(self.recorder, self._operator_obj(), "Warning",
                  "OperatorDegraded",
                  "apiserver unreachable (circuit breaker open): "
                  "fail-static degraded mode — reads stale, "
                  "state-advancing writes suspended, health verdicts "
                  "masked, serving tier unaffected")

    def _exit_degraded(self) -> None:
        outage_s = max(0.0, self.clock.now() - (self.degraded_since
                                                or self.clock.now()))
        self.degraded = False
        self.degraded_since = None
        # the watch replay window is gone: force every informer to
        # re-LIST, which flags the next drained deltas `resynced` and
        # makes the next BuildState a full rebuild from fresh state
        resync = getattr(self.client, "resync", None)
        if resync is not None:
            resync()
        if self.health_monitor is not None:
            # agent-sourced signals are exactly as stale as the outage:
            # defer NEW quarantines for one staleness window
            self.health_monitor.note_recovery()
        self._last_fresh = self.clock.now()
        if self.metrics is not None:
            self.metrics.set_gauge("degraded", 0.0)
            self.metrics.set_gauge("degraded_staleness_seconds", 0.0)
        logger.warning("apiserver circuit breaker closed after %.0fs: "
                       "resyncing informers and resuming with a full "
                       "BuildState rebuild", outage_s)
        self.timeline.record_event(
            kind="degraded-exit", entity="operator/self",
            detail=f"recovered after {outage_s:.0f}s; informers resynced")
        log_event(self.recorder, self._operator_obj(), "Normal",
                  "OperatorRecovered",
                  f"apiserver reachable again after {outage_s:.0f}s "
                  f"degraded: informers resynced, state machine resumed "
                  f"from durable labels")

    def _degraded_tick(self) -> bool:
        """One fail-static tick. Returns True when the breaker closed
        (the caller then runs a normal tick immediately — recovery is
        never delayed a tick)."""
        with self._span("degraded-tick"):
            # the pump doubles as the recovery probe: while the breaker
            # is open its list/watch calls shed instantly; once half-open
            # they go through, and a success closes the breaker
            pump = getattr(self.client, "pump", None)
            if pump is not None:
                pump()
            else:
                self.resilience.probe()
            if self.resilience.breaker.is_closed:
                self._exit_degraded()
                return True
            if self.metrics is not None:
                self.metrics.set_gauge("degraded", 1.0)
                self.metrics.set_gauge(
                    "degraded_staleness_seconds",
                    max(0.0, self.clock.now() - self._last_fresh))
            with self._span("degraded-safety"):
                self._degraded_safety_pass()
            if self.resilience.breaker.is_closed:
                # a safety write landed and closed the breaker mid-pass
                self._exit_degraded()
                return True
            if self.health_monitor is not None:
                self.last_health = self.health_monitor.masked_report()
            if self.usage is not None:
                # the frozen fleet is still capacity: every last-known
                # node bills as degraded-frozen, never idle — fail-static
                # waste must be visible in the account
                try:
                    self.usage.observe_degraded()
                except Exception:  # exc: allow — usage accounting is observability, also while degraded
                    logger.exception("degraded usage tick failed")
        # observability keeps working through the outage: the tsdb
        # scrape is in-memory and alert Events ride the exempt
        # create_event path, so a burn that started before the blackout
        # still pages during it
        if self.slo_engine is not None:
            with self._span("slo-tick"):
                try:
                    self._slo_tick({})
                except Exception:  # exc: allow — SLO evaluation is observability, also while degraded
                    logger.exception("SLO tick failed during degraded "
                                     "mode")
        return False

    def _degraded_safety_pass(self) -> None:
        """Retry the in-flight safety writes off the stale cache through
        the breaker-bypassing safety view. Only writes that RETURN
        capacity and were already durably decreed qualify:

        - a node the machine parked in ``uncordon-required`` (drain and
          validation complete — the uncordon decree is durable in the
          state label) is uncordoned;
        - a quarantine lift that already stamped its durable lift-intent
          annotation is finished (taint removal, uncordon unless a
          pre-quarantine cordon is recorded, label clear).

        Every attempt is idempotent; failures are swallowed (retried
        next tick) and their outcomes feed the breaker as probes."""
        safety = self.resilience.safety()
        try:
            nodes = self.client.list_nodes()
        except (ApiError, TimeoutError):
            return  # even the stale cache is unavailable; nothing to do
        attempts = 0
        for node in nodes:
            name = node.metadata.name
            labels = node.metadata.labels
            annos = node.metadata.annotations
            if node.spec.unschedulable and any(
                    labels.get(keys.state_label)
                    == UpgradeState.UNCORDON_REQUIRED
                    for keys in self._all_keys.values()):
                attempts += 1
                try:
                    safety.patch_node_unschedulable(name, False)
                except (ApiError, TimeoutError):
                    logger.debug("degraded safety uncordon of %s failed; "
                                 "retrying next tick", name)
            if QUARANTINE_LIFT_ANNOTATION in annos \
                    and QUARANTINE_LABEL in labels:
                attempts += 1
                try:
                    if any(t.key == QUARANTINE_TAINT_KEY
                           for t in node.spec.taints):
                        safety.patch_node_taints(name, [
                            {"$patch": "delete",
                             "key": QUARANTINE_TAINT_KEY}])
                    if node.spec.unschedulable and \
                            PRE_QUARANTINE_CORDON_ANNOTATION not in annos:
                        safety.patch_node_unschedulable(name, False)
                    safety.patch_node_metadata(
                        name,
                        labels={QUARANTINE_LABEL: None},
                        annotations={
                            QUARANTINE_REASON_ANNOTATION: None,
                            PRE_QUARANTINE_CORDON_ANNOTATION: None,
                            QUARANTINE_LIFT_ANNOTATION: None,
                            REPAIR_ANNOTATION: None,
                        })
                except (ApiError, TimeoutError):
                    logger.debug("degraded safety lift of %s failed; "
                                 "retrying next tick", name)
        if attempts and self.metrics is not None:
            self.metrics.inc("degraded_safety_retries_total", by=attempts)

    # ------------------------------------------------------- observability

    def _span(self, name: str, **attrs):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **attrs)

    def _slo_tick(self, states: Dict[str, Optional[object]]) -> None:
        """Scrape this tick's signals into the tsdb, then evaluate every
        SLO and alert rule. The gauge collectors run on the states the
        tick already joined — no extra apiserver LISTs, and nothing here
        touches the reconcile hot path."""
        extra: Dict[str, list] = {}
        for comp in self.components:
            state = states.get(comp.name)
            if state is None:
                continue
            collected = upgrade_metrics.collect(self.managers[comp.name],
                                                state)
            for name, value in collected.items():
                full = upgrade_metrics.sanitize_metric_name(
                    f"tpu_operator_{name}")
                extra.setdefault(full, []).append(
                    ({"component": comp.name}, float(value)))
        if self.last_health is not None:
            for name, value in health_metrics.collect(
                    self.last_health).items():
                full = upgrade_metrics.sanitize_metric_name(
                    f"{health_metrics.HEALTH_PREFIX}_{name}")
                extra.setdefault(full, []).append(
                    ({"component": self.health_component or ""},
                     float(value)))
        # an unlabelled aggregate per family so label-free SLO specs
        # (e.g. slice-unavailability) see the fleet, not one component;
        # max, not sum — every component's manager counts the same
        # cordoned/not-Ready nodes, so summing would double-count them
        for full, entries in list(extra.items()):
            if len(entries) > 1 or entries[0][0]:
                extra[full] = entries + [
                    ({}, max(value for _, value in entries))]
        # observability overhead is itself observable: time the scrape on
        # the injected clock and publish the tsdb's series accounting, so
        # a fleet benchmark can hold scrape cost sub-tick at 10k nodes
        scrape_t0 = self.clock.now()
        self.tsdb.scrape(hub=self.metrics, extra_gauges=extra)
        if self.metrics is not None:
            self.metrics.observe("obs_scrape_duration_seconds",
                                 max(0.0, self.clock.now() - scrape_t0),
                                 buckets=API_LATENCY_BUCKETS)
            self.metrics.set_gauge("tsdb_series",
                                   self.tsdb.series_count(),
                                   labels={"state": "active"})
            self.metrics.set_gauge("tsdb_series",
                                   self.tsdb.dropped_series,
                                   labels={"state": "evicted"})
        self.last_slo = self.slo_engine.evaluate()
        opts = self._slo_options
        self.alert_manager.evaluate(self.slo_engine.alert_conditions(
            self.last_slo, page_for_s=opts.page_for_s,
            ticket_for_s=opts.ticket_for_s))

    def _usage_signals(self, states: Dict[str, Optional[object]]
                       ) -> List[NodeSignals]:
        """Join the usage meter's per-node signals off the nodes this
        tick's BuildState already holds — no extra apiserver LISTs, and
        the obs layer never sees a label key (ARC001): quarantine /
        upgrade-state / market-owner / serving-lane label VALUES plus
        the operator's own placements, one :class:`NodeSignals` per
        unique node."""
        placed: set = set()
        for placement in self.placements:
            placed.update(placement.node_names)
        state_labels = [keys.state_label
                        for keys in self._all_keys.values()]
        signals: Dict[str, NodeSignals] = {}
        for comp in self.components:
            state = states.get(comp.name)
            if state is None:
                continue
            for bucket in state.node_states.values():
                for ns in bucket:
                    node = ns.node
                    name = node.metadata.name
                    sig = signals.get(name)
                    if sig is None:
                        sig = signals[name] = NodeSignals(
                            node=name, training=name in placed)
                    labels = node.metadata.labels
                    if QUARANTINE_LABEL in labels:
                        sig.quarantined = True
                    for state_label in state_labels:
                        value = labels.get(state_label, "")
                        if value in MAINTENANCE_STATES:
                            # any component mid-maintenance claims the
                            # node; idle/done values never overwrite it
                            sig.upgrade_state = value
                    sig.market_owner = labels.get(MARKET_OWNER_LABEL,
                                                  sig.market_owner)
                    sig.lane = labels.get(LANE_LABEL, sig.lane)
                    if REPLICA_ID_LABEL in labels:
                        sig.replica = True
        return list(signals.values())

    def _check_stuck_nodes(self, states: Dict[str, Optional[object]]) -> None:
        """Run each component's stuck detector over the nodes this tick's
        BuildState already joined — no extra apiserver LISTs."""
        for comp in self.components:
            state = states.get(comp.name)
            if state is None:
                continue
            nodes = [ns.node for bucket in state.node_states.values()
                     for ns in bucket]
            # entity graph upkeep (node ∈ clique) off the nodes this tick
            # already joined — the causes engine walks these links;
            # link() is a bounded last-write-wins dict set, safe to
            # re-assert every tick
            for node in nodes:
                clique = node.metadata.labels.get(CLIQUE_LABEL)
                if clique:
                    self.timeline.link(f"node/{node.metadata.name}",
                                       f"clique/{clique}")
            try:
                self.last_stuck[comp.name] = \
                    self.stuck_detectors[comp.name].check(nodes)
            except Exception:  # exc: allow — stuck detection is observability; a detector bug must not stop the tick
                logger.exception("stuck detection failed for %s", comp.name)

    def _emit_verdict_change_events(self) -> None:
        """One Kubernetes Event per node HEALTH VERDICT transition —
        Warning on escalation, Normal on recovery — so `kubectl describe
        node` shows the sequence of events that led a group into
        quarantine."""
        if self.last_health is None:
            return
        current = {name: nh.verdict
                   for name, nh in self.last_health.node_health.items()}
        for name, verdict in current.items():
            prev = self._prev_verdicts.get(name, HealthVerdict.HEALTHY)
            if prev == verdict:
                continue
            escalated = HealthVerdict.worst([prev, verdict]) == verdict
            self.timeline.record_event(
                kind="health-verdict", entity=f"node/{name}",
                detail=f"{prev} -> {verdict}")
            if self.recorder is None:
                continue
            try:
                node = self.client.direct().get_node(name)
            except (ApiError, TimeoutError):
                continue  # node gone mid-tick; next tick re-evaluates
            log_event(self.recorder, node,
                      "Warning" if escalated else "Normal",
                      "FleetHealthVerdict",
                      f"Health verdict of node {name} changed "
                      f"{prev} -> {verdict}")
        self._prev_verdicts = current
