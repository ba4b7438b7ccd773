"""Remediation policy: verdicts → quarantine → slice-atomic repair.

The remediator is the only part of the health subsystem that writes to the
cluster. It closes the loop in two stages:

- **Quarantine** (``unhealthy-transient`` and worse): cordon every member of
  the slice, add the ``tpu.dev/health-quarantine`` NoSchedule taint, and
  label the nodes with the verdict — ``tpu/scheduler.py`` already refuses
  unschedulable members, so placement onto the sick slice stops immediately.
  Quarantine is slice-atomic by construction: it acts on the rolled-up
  :class:`~.classifier.SliceHealth`, never on a lone node of a multi-host
  slice.

- **Repair** (``unhealthy-persistent``): hand the WHOLE slice to the upgrade
  state machine by setting the managed component's ``upgrade-requested``
  annotation on every member. The machine then runs its normal
  cordon → wait-for-jobs → drain → driver-restart → validate pipeline with
  the SAME slice-atomic group admission and maxUnavailable arithmetic
  (:mod:`..upgrade.groups`) that rolling upgrades use — remediation and
  upgrades draw from one availability budget and cannot deadlock each other
  (quarantined nodes count as unavailable in
  ``GetCurrentUnavailableNodes``, and a fully-cordoned sick slice rides the
  reference's already-cordoned admission bypass since it consumes no *new*
  availability). Because the driver revision usually hasn't drifted, the
  machine alone would wait forever at pod-restart for a pod it considers in
  sync — so once every member is at/past the restart barrier (the ICI
  domain is quiesced), the remediator deletes the failing driver pods and
  lets the DaemonSet controller bring up fresh ones; the machine's
  failed-node auto-recovery then walks the slice to done.

Repair injection is rate-limited by exponential backoff
(``backoff_base_seconds * 2^(attempts-1)``, capped) recorded in node
annotations, so a fault that repair cannot fix does not thrash the slice.
Quarantine is lifted only after the slice has been continuously healthy for
``recovery_seconds`` AND the repair pipeline has fully unwound.

A copy of the JAX package's ``health/remediation.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

from ..api.v1alpha1 import IntOrStr, scaled_int_or_percent
from ..core.client import Client, EventRecorder, NotFoundError
from ..core.objects import Node, Pod
from ..upgrade.consts import UpgradeState
from ..upgrade.groups import AT_OR_PAST_POD_RESTART
from ..upgrade.util import KeyFactory, log_event
from ..utils.clock import Clock, RealClock
from . import consts
from .classifier import SliceHealth
from .consts import HealthVerdict

logger = logging.getLogger(__name__)

EVENT_REASON = "FleetHealth"
TRUE_STRING = "true"

# machine states that mean "the upgrade pipeline is not holding these nodes"
IDLE_STATES = (UpgradeState.UNKNOWN, UpgradeState.DONE)

# cap for the human-readable quarantine-reason annotation
_REASON_MAX = 512


@dataclasses.dataclass
class RemediationPolicy:
    """Knobs for the quarantine/repair loop."""

    quarantine: bool = True
    repair: bool = True
    # continuous healthy streak (seconds) required before lifting quarantine
    recovery_seconds: float = 120.0
    # exponential backoff between repair injections on the same slice
    backoff_base_seconds: float = 300.0
    backoff_max_seconds: float = 3600.0
    # optional quarantine budget, int or "25%"-style percent of fleet size;
    # shares semantics with the upgrade policy's maxUnavailable: quarantine
    # that would push total unavailability past it is deferred (the repair
    # injection still goes through the state machine's own budget check)
    max_unavailable: Optional[IntOrStr] = None

    def validate(self) -> None:
        for field in ("recovery_seconds", "backoff_base_seconds",
                      "backoff_max_seconds"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")
        if self.max_unavailable is not None:
            scaled_int_or_percent(self.max_unavailable, 100)


@dataclasses.dataclass
class Actions:
    """What one remediation pass did (feeds metrics and tests)."""

    quarantined_slices: List[str] = dataclasses.field(default_factory=list)
    lifted_slices: List[str] = dataclasses.field(default_factory=list)
    repairs_injected: List[str] = dataclasses.field(default_factory=list)
    driver_pods_restarted: List[str] = dataclasses.field(default_factory=list)
    deferred_slices: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RemediationContext:
    """Fresh (direct-read) cluster view for one pass."""

    nodes: Dict[str, Node]                 # by name
    pods_by_node: Dict[str, List[Pod]]     # managed driver pods
    total_nodes: int
    unavailable: int                       # cordoned or not-Ready, fleet-wide
    actions: Actions = dataclasses.field(default_factory=Actions)
    # post-blackout grace (monitor.note_recovery): every agent-sourced
    # signal is as stale as the outage was long, so NEW quarantines are
    # deferred for one staleness window; lifts and repairs of slices
    # already quarantined proceed (docs/resilience.md)
    suppress_quarantine: bool = False


class HealthRemediator:
    def __init__(self, client: Client, keys: KeyFactory,
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 policy: Optional[RemediationPolicy] = None):
        self._client = client
        self._keys = keys
        self._recorder = recorder
        self._clock = clock or RealClock()
        self.policy = policy or RemediationPolicy()
        self.policy.validate()

    # ----------------------------------------------------------- dispatch

    def handlers(self):
        """Verdict → handler dispatch table, exhaustive over
        :class:`HealthVerdict` (``tests/test_torch_health.py`` holds it
        so)."""
        return {
            HealthVerdict.HEALTHY: self.process_healthy,
            HealthVerdict.DEGRADED: self.process_degraded,
            HealthVerdict.UNHEALTHY_TRANSIENT:
                self.process_unhealthy_transient,
            HealthVerdict.UNHEALTHY_PERSISTENT:
                self.process_unhealthy_persistent,
        }

    def apply(self, slices: List[SliceHealth],
              ctx: RemediationContext) -> Actions:
        """One pass over the rolled-up slice verdicts."""
        handlers = self.handlers()
        for sv in slices:
            handler = handlers.get(sv.verdict)
            if handler is None:
                raise ValueError(
                    f"no remediation handler for verdict {sv.verdict!r}")
            try:
                handler(sv, ctx)
            except Exception:  # exc: allow — per-slice isolation: one slice's failure must not starve the rest; next tick retries idempotently
                # one slice's apiserver hiccup must not starve the rest;
                # the next tick retries idempotently (all state is labels)
                logger.exception("remediation of %s failed", sv.key)
        return ctx.actions

    # ----------------------------------------------------------- handlers

    def process_healthy(self, sv: SliceHealth,
                        ctx: RemediationContext) -> None:
        """A healthy slice: lift quarantine once the clean streak is long
        enough and the repair pipeline has unwound to done."""
        members = self._members(sv, ctx)
        if not any(consts.QUARANTINE_LABEL in m.metadata.labels
                   for m in members):
            return
        if sv.min_healthy_for() < self.policy.recovery_seconds:
            return
        states = [m.metadata.labels.get(self._keys.state_label, "")
                  for m in members]
        if any(s not in IDLE_STATES for s in states):
            return  # repair pipeline still holds the slice
        self._lift(sv, members, ctx)

    def process_degraded(self, sv: SliceHealth,
                         ctx: RemediationContext) -> None:
        """Observed-but-unconfirmed (flapping or freshly-firing) signals:
        no cluster action — the verdict label and metrics carry the state,
        and acting here is exactly the flap-churn damping exists to stop."""

    def process_unhealthy_transient(self, sv: SliceHealth,
                                    ctx: RemediationContext) -> None:
        if self.policy.quarantine:
            self._quarantine(sv, ctx)

    def process_unhealthy_persistent(self, sv: SliceHealth,
                                     ctx: RemediationContext) -> None:
        if self.policy.quarantine:
            self._quarantine(sv, ctx)
        if not self.policy.repair:
            return
        members = self._members(sv, ctx)
        self._maybe_inject_repair(sv, members, ctx)
        self._maybe_restart_drivers(sv, members, ctx)

    # --------------------------------------------------------- primitives

    def _members(self, sv: SliceHealth,
                 ctx: RemediationContext) -> List[Node]:
        return [ctx.nodes[n] for n in sv.node_names if n in ctx.nodes]

    def _quarantine(self, sv: SliceHealth, ctx: RemediationContext) -> None:
        members = self._members(sv, ctx)
        todo = [m for m in members
                if m.metadata.labels.get(consts.QUARANTINE_LABEL)
                != sv.verdict]
        if not todo:
            return
        if ctx.suppress_quarantine:
            logger.warning("deferring quarantine of %s: post-blackout "
                           "grace window (signals as stale as the "
                           "outage)", sv.key)
            ctx.actions.deferred_slices.append(sv.key)
            log_event(self._recorder, members[0], "Warning", EVENT_REASON,
                      f"Quarantine of {sv.key} deferred: post-blackout "
                      f"grace window, agent signals not yet fresh")
            return
        # shared-availability budget: members that are still schedulable and
        # Ready become newly unavailable; defer if that busts the budget
        newly_unavailable = [m for m in todo
                             if not m.spec.unschedulable and m.is_ready()]
        if self.policy.max_unavailable is not None and newly_unavailable:
            budget = scaled_int_or_percent(self.policy.max_unavailable,
                                           ctx.total_nodes, round_up=True)
            if ctx.unavailable + len(newly_unavailable) > budget:
                logger.warning(
                    "deferring quarantine of %s: %d unavailable + %d new "
                    "would exceed budget %d", sv.key, ctx.unavailable,
                    len(newly_unavailable), budget)
                ctx.actions.deferred_slices.append(sv.key)
                log_event(self._recorder, members[0], "Warning",
                          EVENT_REASON,
                          f"Quarantine of {sv.key} deferred: availability "
                          f"budget {budget} exhausted "
                          f"({ctx.unavailable} already unavailable)")
                return
        reason = "; ".join(sv.reasons)[:_REASON_MAX]
        for node in todo:
            # (re-)arming quarantine cancels any in-flight lift decree:
            # a stale lift-intent marker would let the safety pass undo
            # this quarantine
            annotations = {consts.QUARANTINE_REASON_ANNOTATION: reason,
                           consts.QUARANTINE_LIFT_ANNOTATION: None}
            if (node.spec.unschedulable
                    and consts.QUARANTINE_LABEL not in node.metadata.labels):
                # remember a pre-existing cordon (admin maintenance or an
                # in-flight upgrade) so lifting quarantine does not remove
                # it. A verdict ESCALATION re-labels an already-quarantined
                # node, whose cordon is our own — never recorded.
                annotations[consts.PRE_QUARANTINE_CORDON_ANNOTATION] = \
                    TRUE_STRING
            self._client.patch_node_metadata(
                node.metadata.name,
                labels={consts.QUARANTINE_LABEL: sv.verdict},
                annotations=annotations)
            if not node.spec.unschedulable:
                self._client.patch_node_unschedulable(node.metadata.name,
                                                      True)
            if not any(t.key == consts.QUARANTINE_TAINT_KEY
                       for t in node.spec.taints):
                self._client.patch_node_taints(node.metadata.name, [{
                    "key": consts.QUARANTINE_TAINT_KEY,
                    "value": sv.verdict,
                    "effect": consts.QUARANTINE_TAINT_EFFECT}])
        ctx.unavailable += len(newly_unavailable)
        ctx.actions.quarantined_slices.append(sv.key)
        log_event(self._recorder, members[0], "Warning", EVENT_REASON,
                  f"Quarantined {sv.key} ({sv.verdict}): {reason}")
        logger.warning("quarantined %s (%s): %s", sv.key, sv.verdict, reason)

    def _lift(self, sv: SliceHealth, members: List[Node],
              ctx: RemediationContext) -> None:
        for node in members:
            keep_cordon = (consts.PRE_QUARANTINE_CORDON_ANNOTATION
                           in node.metadata.annotations)
            # crash-safe ordering, two guarantees:
            # 1. the durable LIFT-INTENT annotation lands FIRST — from
            #    then on every remaining step is a pure capacity-
            #    returning write, so a crash/blackout anywhere inside
            #    the sequence leaves unambiguous evidence the degraded-
            #    mode safety pass (gpu/operator.py) may finish from;
            #    without it, "label present, taint absent" could as
            #    well be a crash mid-QUARANTINE, which must never be
            #    "finished" by removing the label;
            # 2. undo the taint and the cordon BEFORE removing the
            #    quarantine label. The label is what makes
            #    process_healthy retry the lift — removing it first
            #    meant a failed uncordon (apiserver conflict, restart
            #    mid-lift) left the node cordoned forever with nothing
            #    left to retry (found by the chaos campaign's
            #    conflict-storm scenarios; pinned in tests/test_health.py).
            # Every step is idempotent, so a partial lift re-runs next
            # tick.
            if consts.QUARANTINE_LIFT_ANNOTATION \
                    not in node.metadata.annotations:
                self._client.patch_node_metadata(
                    node.metadata.name,
                    annotations={consts.QUARANTINE_LIFT_ANNOTATION:
                                 repr(self._clock.wall())})
            if any(t.key == consts.QUARANTINE_TAINT_KEY
                   for t in node.spec.taints):
                self._client.patch_node_taints(node.metadata.name, [
                    {"$patch": "delete",
                     "key": consts.QUARANTINE_TAINT_KEY}])
            if not keep_cordon and node.spec.unschedulable:
                self._client.patch_node_unschedulable(node.metadata.name,
                                                      False)
            self._client.patch_node_metadata(
                node.metadata.name,
                labels={consts.QUARANTINE_LABEL: None},
                annotations={
                    consts.QUARANTINE_REASON_ANNOTATION: None,
                    consts.PRE_QUARANTINE_CORDON_ANNOTATION: None,
                    consts.QUARANTINE_LIFT_ANNOTATION: None,
                    consts.REPAIR_ANNOTATION: None,
                    # defensive: a lift must never leave a pending upgrade
                    # request behind to re-cordon the slice later
                    self._keys.upgrade_requested_annotation: None,
                })
        ctx.actions.lifted_slices.append(sv.key)
        log_event(self._recorder, members[0], "Normal", EVENT_REASON,
                  f"Quarantine lifted on {sv.key}: healthy for "
                  f"{sv.min_healthy_for():.0f}s")
        logger.info("lifted quarantine on %s", sv.key)

    def _maybe_inject_repair(self, sv: SliceHealth, members: List[Node],
                             ctx: RemediationContext) -> None:
        if not members:
            return
        if any(consts.REPAIR_ANNOTATION in m.metadata.annotations
               for m in members):
            return  # repair already in flight
        states = [m.metadata.labels.get(self._keys.state_label, "")
                  for m in members]
        if any(s not in IDLE_STATES for s in states):
            return  # a rolling upgrade already holds the slice — it will
            # restart the drivers anyway; re-injecting would double-trigger
        attempts = max((self._int_annotation(
            m, consts.REPAIR_ATTEMPTS_ANNOTATION) for m in members),
            default=0)
        last = max((self._float_annotation(
            m, consts.REPAIR_LAST_ANNOTATION) for m in members), default=0.0)
        now = self._clock.wall()
        if attempts > 0:
            delay = min(
                self.policy.backoff_base_seconds * (2 ** (attempts - 1)),
                self.policy.backoff_max_seconds)
            if now - last < delay:
                logger.info("repair of %s backing off (attempt %d, "
                            "%.0fs of %.0fs elapsed)", sv.key, attempts + 1,
                            now - last, delay)
                return
        for node in members:
            self._client.patch_node_metadata(
                node.metadata.name,
                annotations={
                    consts.REPAIR_ANNOTATION: consts.REPAIR_PENDING,
                    consts.REPAIR_ATTEMPTS_ANNOTATION: str(attempts + 1),
                    consts.REPAIR_LAST_ANNOTATION: repr(now),
                    self._keys.upgrade_requested_annotation: TRUE_STRING,
                })
        ctx.actions.repairs_injected.append(sv.key)
        log_event(self._recorder, members[0], "Warning", EVENT_REASON,
                  f"Injecting slice-atomic repair of {sv.key} through the "
                  f"{self._keys.component} upgrade pipeline "
                  f"(attempt {attempts + 1})")
        logger.warning("injected repair of %s via %s upgrade pipeline "
                       "(attempt %d)", sv.key, self._keys.component,
                       attempts + 1)

    def _maybe_restart_drivers(self, sv: SliceHealth, members: List[Node],
                               ctx: RemediationContext) -> None:
        """Once the state machine has the whole slice at/past the restart
        barrier (every host drained — quiesced ICI domain), delete the
        failing driver pods so the DaemonSet controller replaces them; the
        machine's in-sync/Ready checks then walk the slice to done."""
        if not any(consts.REPAIR_ANNOTATION in m.metadata.annotations
                   for m in members):
            return
        states = [m.metadata.labels.get(self._keys.state_label, "")
                  for m in members]
        if not all(s in AT_OR_PAST_POD_RESTART for s in states):
            return
        for node in members:
            for pod in ctx.pods_by_node.get(node.metadata.name, []):
                if pod.metadata.deletion_timestamp is not None:
                    continue
                if not self._pod_failing(pod):
                    continue
                try:
                    self._client.direct().delete_pod(pod.metadata.namespace,
                                                     pod.metadata.name)
                except NotFoundError:
                    continue
                ctx.actions.driver_pods_restarted.append(pod.metadata.name)
                log_event(self._recorder, node, "Warning", EVENT_REASON,
                          f"Restarting failing driver pod "
                          f"{pod.metadata.name} (slice {sv.key} quiesced)")
                logger.warning("deleted failing driver pod %s on %s "
                               "(slice %s quiesced)", pod.metadata.name,
                               node.metadata.name, sv.key)

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _pod_failing(pod: Pod) -> bool:
        if pod.status.phase in ("Failed", "Unknown"):
            return True
        statuses = (list(pod.status.init_container_statuses)
                    + list(pod.status.container_statuses))
        return any(not cs.ready for cs in statuses) or not statuses

    @staticmethod
    def _int_annotation(node: Node, key: str) -> int:
        try:
            return int(node.metadata.annotations.get(key, 0))
        except (TypeError, ValueError):
            return 0

    @staticmethod
    def _float_annotation(node: Node, key: str) -> float:
        try:
            return float(node.metadata.annotations.get(key, 0.0))
        except (TypeError, ValueError):
            return 0.0
