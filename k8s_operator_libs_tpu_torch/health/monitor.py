"""FleetHealthMonitor — one tick of probe → classify → quarantine → repair.

The monitor is the health subsystem's composition root, wired by
``gpu/operator.py:GPUOperator`` (the twin of the JAX package's
``TPUOperator``) the
same way the upgrade state machine is: everything injected, so the whole
loop runs against :mod:`..core.fakecluster` in tests and a live client in
production.

Reads: the monitor requires READ-YOUR-LAST-TICK-WRITES — remediation acts
on labels the monitor itself wrote last tick, and a view that lags past
one tick would double-inject repairs and double-count quarantines. Two
read paths satisfy that freshness barrier:

- **Pumped informer store** (the deterministic read path, and the
  default whenever the injected client exposes ``pump``): the monitor
  pumps the Node + Pod informers at tick start — the explicit freshness
  barrier — and reads from the store. The barrier is sufficient because
  (a) a pump drains every watch event due by *now* on the injected
  clock, (b) the tick interval of every consumer (operator ``--interval``,
  the campaign's 15 s, fleetbench's modelled 30 s) exceeds the
  server-side cache lag, so last tick's writes are always due, and
  (c) same-tick upgrade-pipeline writes are provider-barriered (the
  barrier itself sleeps the clock past the lag). This removes the last
  O(fleet) apiserver read from the steady-state tick (FLEET_r03).
- **Direct (uncached)**, when the client has no pump — the live threaded
  informer cache advances asynchronously and cannot give a per-tick
  freshness guarantee, so the monitor keeps the original one node LIST +
  one scoped pod LIST per tick there.

A copy of the JAX package's ``health/monitor.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

from ..core.client import ApiError, Client, EventRecorder
from ..core.objects import Node, Pod
from ..upgrade.consts import UpgradeState
from ..upgrade.groups import NodeGrouper, SingleNodeGrouper
from ..upgrade.util import KeyFactory
from ..utils.clock import Clock, RealClock
from . import consts
from .classifier import (ClassifierConfig, HealthClassifier, NodeHealth,
                         SliceHealth)
from .consts import HealthVerdict
from .probes import Probe, Snapshot, default_probes, run_probes
from .remediation import (Actions, HealthRemediator, RemediationContext,
                          RemediationPolicy)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class HealthOptions:
    """Everything a consumer configures about the health subsystem; the
    monitor itself is built from this by ``TPUOperator`` /
    ``cmd/operator.py``."""

    # which managed component's upgrade pipeline performs repairs
    # (None = the operator's first component)
    component: Optional[str] = None
    classifier: ClassifierConfig = dataclasses.field(
        default_factory=ClassifierConfig)
    policy: RemediationPolicy = dataclasses.field(
        default_factory=RemediationPolicy)
    restart_threshold: int = 3
    heartbeat_stale_seconds: float = 180.0

    @classmethod
    def from_dict(cls, d: dict) -> "HealthOptions":
        """YAML round-trip (camelCase keys, CRD convention — matches the
        ``health:`` section of the operator config)."""
        opts = cls(
            component=d.get("repairComponent"),
            classifier=ClassifierConfig(
                damping_seconds=d.get("dampingSeconds", 60.0),
                persist_seconds=d.get("persistSeconds", 300.0)),
            policy=RemediationPolicy(
                quarantine=d.get("quarantine", True),
                repair=d.get("repair", True),
                recovery_seconds=d.get("recoverySeconds", 120.0),
                backoff_base_seconds=d.get("backoffBaseSeconds", 300.0),
                backoff_max_seconds=d.get("backoffMaxSeconds", 3600.0),
                max_unavailable=d.get("maxUnavailable")),
            restart_threshold=d.get("restartThreshold", 3),
            heartbeat_stale_seconds=d.get("heartbeatStaleSeconds", 180.0))
        opts.classifier.validate()
        opts.policy.validate()
        return opts


@dataclasses.dataclass
class HealthReport:
    """What one tick observed and did — rendered into /metrics and asserted
    by tests; never required by the next tick (cluster labels are the only
    durable state)."""

    node_health: Dict[str, NodeHealth]
    slices: List[SliceHealth]
    quarantined_nodes: int
    quarantined_slices: int
    repairs_in_flight: int
    actions: Actions
    probe_errors: List[str]
    # True when this report is a degraded-mode re-publication of the last
    # fresh verdicts: the control plane is unreachable, probes did not
    # run, and nothing here may drive remediation (docs/resilience.md)
    masked: bool = False

    def verdict_counts(self) -> Dict[str, int]:
        out = {v: 0 for v in HealthVerdict.ALL}
        for nh in self.node_health.values():
            out[nh.verdict] += 1
        return out

    def slice_verdict_counts(self) -> Dict[str, int]:
        out = {v: 0 for v in HealthVerdict.ALL}
        for sv in self.slices:
            out[sv.verdict] += 1
        return out


class FleetHealthMonitor:
    def __init__(self, client: Client, keys: KeyFactory,
                 namespace: str, driver_labels: Dict[str, str],
                 grouper: Optional[NodeGrouper] = None,
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 probes: Optional[List[Probe]] = None,
                 classifier: Optional[HealthClassifier] = None,
                 remediator: Optional[HealthRemediator] = None,
                 options: Optional[HealthOptions] = None,
                 metrics=None):
        options = options or HealthOptions()
        self._client = client
        self._keys = keys
        self._namespace = namespace
        self._driver_labels = dict(driver_labels)
        self._grouper = grouper or SingleNodeGrouper()
        self._clock = clock or RealClock()
        # probe→quarantine reaction-time histogram: soft state only (when a
        # slice FIRST left healthy); losing it on restart just skips one
        # observation, never double-counts
        self._metrics = metrics
        self._unhealthy_since: Dict[str, float] = {}
        self.probes = probes if probes is not None else default_probes(
            restart_threshold=options.restart_threshold,
            heartbeat_stale_seconds=options.heartbeat_stale_seconds)
        self.classifier = classifier or HealthClassifier(
            clock=self._clock, config=options.classifier)
        self.remediator = remediator or HealthRemediator(
            client, keys, recorder=recorder, clock=self._clock,
            policy=options.policy)
        self.last_report: Optional[HealthReport] = None
        self._options = options
        # post-blackout quarantine grace: until this wall time, signals
        # sourced from node-agent annotations are untrustworthy (the
        # agents could not write through the dead apiserver either), so
        # NEW quarantines are deferred; lifts keep working
        self._quarantine_grace_until = 0.0

    # ------------------------------------------------------------ degraded

    def masked_report(self) -> Optional[HealthReport]:
        """Degraded-mode view: re-publish the last fresh report with its
        verdicts MASKED — probes do not run on stale data (a blackout
        would manufacture heartbeat-staleness verdicts for the whole
        fleet), verdict labels are not written, and remediation is
        suspended. Returns None when no fresh report ever existed."""
        if self.last_report is None:
            return None
        report = dataclasses.replace(self.last_report, masked=True,
                                     actions=Actions(), probe_errors=[])
        self.last_report = report
        return report

    def note_recovery(self, grace_seconds: Optional[float] = None) -> None:
        """Called by the operator when the control plane returns: defer
        NEW quarantines for one staleness window (default: the heartbeat
        staleness threshold) — every agent-sourced annotation is exactly
        as old as the blackout, and quarantining a healthy fleet off
        that is the failure mode fail-static exists to prevent."""
        if grace_seconds is None:
            grace_seconds = self._options.heartbeat_stale_seconds
        self._quarantine_grace_until = self._clock.wall() + grace_seconds

    # ----------------------------------------------------------------- tick

    def tick(self) -> Optional[HealthReport]:
        # freshness barrier + read path selection (see module docstring)
        pump = getattr(self._client, "pump", None)
        try:
            if pump is not None:
                pump(kinds=("Node", "Pod"))
                view = self._client
            else:
                view = self._client.direct()
            pods = view.list_pods(namespace=self._namespace,
                                  label_selector=self._driver_labels)
            pods_by_node: Dict[str, List[Pod]] = {}
            for pod in pods:
                if pod.spec.node_name:
                    pods_by_node.setdefault(pod.spec.node_name,
                                            []).append(pod)
            nodes = [n for n in view.list_nodes() if self._in_scope(
                n, pods_by_node)]
        except ApiError:
            # classified: the fleet read failed mid-tick — never probe
            # a half-read snapshot; re-publish the last fresh report
            # with verdicts masked (None before any fresh tick existed)
            logger.warning("fleet read failed mid-tick; serving the "
                           "masked last report", exc_info=True)
            return self.masked_report()

        snapshot = Snapshot(nodes=nodes, pods_by_node=pods_by_node,
                            clock=self._clock)
        signals, probe_errors = run_probes(self.probes, snapshot)
        node_health = self.classifier.classify(signals, nodes)
        slices = self.classifier.rollup(node_health, nodes, self._grouper)

        self._sync_verdict_labels(nodes, node_health)

        total = len(nodes)
        # the same arithmetic GetUpgradesAvailable uses: cordoned or
        # not-Ready, PLUS nodes the machine admitted this tick and is about
        # to cordon (state label cordon-required) — otherwise health and the
        # machine can each approve their own cordons in the same tick window
        # and together bust the shared budget
        unavailable = sum(
            1 for n in nodes
            if n.spec.unschedulable or not n.is_ready()
            or n.metadata.labels.get(self._keys.state_label)
            == UpgradeState.CORDON_REQUIRED)
        # stamp when each slice first leaves healthy, BEFORE remediation
        # acts — reaction time measures signal-confirmed → quarantined
        now = self._clock.wall()
        for sv in slices:
            if sv.verdict == HealthVerdict.HEALTHY:
                self._unhealthy_since.pop(sv.key, None)
            else:
                self._unhealthy_since.setdefault(sv.key, now)

        ctx = RemediationContext(
            nodes={n.metadata.name: n for n in nodes},
            pods_by_node=pods_by_node,
            total_nodes=total, unavailable=unavailable,
            suppress_quarantine=(self._clock.wall()
                                 < self._quarantine_grace_until))
        actions = self.remediator.apply(slices, ctx)

        if self._metrics is not None:
            for key in actions.quarantined_slices:
                since = self._unhealthy_since.get(key)
                if since is not None:
                    self._metrics.observe(
                        "health_reaction_seconds",
                        max(0.0, self._clock.wall() - since),
                        labels={"component": self._keys.component})

        quarantined = {n.metadata.name for n in nodes
                       if consts.QUARANTINE_LABEL in n.metadata.labels}
        q_slices = {sv.key for sv in slices
                    if any(m in quarantined for m in sv.node_names)}
        for sv_key in actions.quarantined_slices:
            q_slices.add(sv_key)
        q_slices -= set(actions.lifted_slices)
        slice_members = {sv.key: sv.node_names for sv in slices}
        q_nodes = set(quarantined)
        for key in actions.quarantined_slices:
            q_nodes.update(slice_members.get(key, []))
        for key in actions.lifted_slices:
            q_nodes -= set(slice_members.get(key, []))
        repairs = sum(
            1 for sv in slices
            if any(consts.REPAIR_ANNOTATION
                   in ctx.nodes[m].metadata.annotations
                   for m in sv.node_names if m in ctx.nodes)
            or sv.key in actions.repairs_injected)

        self.last_report = HealthReport(
            node_health=node_health, slices=slices,
            quarantined_nodes=len(q_nodes),
            quarantined_slices=len(q_slices),
            repairs_in_flight=repairs,
            actions=actions, probe_errors=probe_errors)
        return self.last_report

    # -------------------------------------------------------------- helpers

    def _in_scope(self, node: Node,
                  pods_by_node: Dict[str, List[Pod]]) -> bool:
        """Monitor nodes that host (or should host) the managed driver: a
        driver pod present, or health state left over from an earlier tick
        (a node mid-repair whose pod is being recreated must stay visible)."""
        if node.metadata.name in pods_by_node:
            return True
        labels = node.metadata.labels
        annotations = node.metadata.annotations
        return (consts.QUARANTINE_LABEL in labels
                or consts.VERDICT_LABEL in labels
                or consts.REPAIR_ANNOTATION in annotations)

    def _sync_verdict_labels(self, nodes: List[Node],
                             node_health: Dict[str, NodeHealth]) -> None:
        """Keep the ``tpu.dev/health`` verdict label current: set while
        non-healthy, removed when healthy — zero churn on an idle fleet."""
        for node in nodes:
            nh = node_health.get(node.metadata.name)
            if nh is None:
                continue
            current = node.metadata.labels.get(consts.VERDICT_LABEL)
            want = None if nh.verdict == HealthVerdict.HEALTHY else nh.verdict
            if current == want:
                continue
            try:
                self._client.patch_node_metadata(
                    node.metadata.name,
                    labels={consts.VERDICT_LABEL: want})
                # keep the local copy coherent for the remediation pass
                if want is None:
                    node.metadata.labels.pop(consts.VERDICT_LABEL, None)
                else:
                    node.metadata.labels[consts.VERDICT_LABEL] = want
            except (ApiError, TimeoutError):
                logger.exception("could not sync verdict label on %s",
                                 node.metadata.name)
