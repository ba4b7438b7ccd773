"""Alert rule evaluation: ``for:``-duration pending→firing→resolved.

The last mile of the SLO engine: a condition (burn-rate pair triggered)
becomes an *alert* only after holding for the rule's ``for_s`` duration —
the Prometheus ``for:`` semantic that keeps a single slow reconcile tick
from paging anyone. State machine per rule::

    inactive ──condition──▶ pending ──held for_s──▶ firing
       ▲                       │                       │
       └───────cleared─────────┘        cleared────────▶ resolved
                                                   (back to pending on
                                                    the next episode)

Deduplication is structural: exactly ONE Kubernetes Event per
pending→firing transition (reason ``SLOAlertFiring``) and one per
firing→resolved (``SLOAlertResolved``), recorded through the injected
:class:`~..core.client.EventRecorder` — the same ``ClientEventRecorder``
wiring the upgrade and health loops already use, so ``kubectl get
events`` shows budget burns next to cordons and quarantines. A rule that
stays firing re-emits nothing.

The ``tpu_operator_alert_firing{rule,severity}`` gauge (0/1 per known
rule) rides the shared :class:`~.metrics.MetricsHub`; :meth:`AlertManager.
status` is the JSON the operator's ``/alerts`` endpoint and ``status
--alerts`` render.

A copy of the JAX package's ``obs/alerts.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Tuple

from ..utils.clock import Clock, RealClock

logger = logging.getLogger(__name__)

INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

FIRING_EVENT_REASON = "SLOAlertFiring"
RESOLVED_EVENT_REASON = "SLOAlertResolved"
ATTRIBUTED_EVENT_REASON = "SLOAlertAttributed"

# gauge families emitted through the hub (full exposed names; each has
# a HELP_TEXTS entry)
ALERT_GAUGE_FAMILIES = (
    "tpu_operator_alert_firing",
)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One evaluated rule. ``for_s`` is the Prometheus ``for:`` — the
    condition must hold this long before pending becomes firing."""

    name: str
    severity: str = "page"
    for_s: float = 60.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    description: str = ""

    def __post_init__(self):
        # labels must stay hashable-independent; freeze a copy so a
        # caller mutating its dict cannot skew an already-seen rule
        object.__setattr__(self, "labels", dict(self.labels))


class _AlertMeta:
    def __init__(self, name: str):
        self.name = name


class _AlertObject:
    """Event anchor: alerts have no node to attach to, so the Event's
    involved object is a synthetic ``SLOAlert/<rule>``."""

    kind = "SLOAlert"

    def __init__(self, name: str):
        self.metadata = _AlertMeta(name)


class AlertManager:
    """Tracks rule state across evaluations. Clock-injected; one
    instance per operator process (the reconcile loop is the only
    writer, HTTP handlers only read :meth:`status`)."""

    def __init__(self, clock: Optional[Clock] = None, metrics=None,
                 recorder=None, causes=None, timeline=None):
        self._clock = clock or RealClock()
        self._metrics = metrics
        self._recorder = recorder
        # optional black-box wiring (obs/timeline.py, obs/causes.py):
        # every state transition is recorded on the timeline, and each
        # pending→firing edge triggers exactly one root-cause
        # attribution — the same structural dedup the Events use
        self._causes = causes
        self._timeline = timeline
        self._states: Dict[str, Dict[str, Any]] = {}

    def _alert_entity(self, rule: AlertRule) -> str:
        """Timeline entity for a rule, linked alert→SLO in the entity
        graph (the causes engine walks the other direction, SLO→metric
        families, but the link makes ``--incident`` renders coherent)."""
        entity = f"alert/{rule.name}"
        slo = rule.labels.get("slo")
        if slo:
            self._timeline.link(entity, f"slo/{slo}")
        return entity

    # --------------------------------------------------------- evaluation

    def evaluate(self, conditions: List[Tuple[AlertRule, bool, str]]
                 ) -> None:
        """One evaluation pass: ``conditions`` is ``[(rule, active,
        message), ...]`` — every rule the caller knows about, each tick
        (a rule missing from the list keeps its last state)."""
        now = self._clock.wall()
        for rule, active, message in conditions:
            st = self._states.get(rule.name)
            if st is None:
                st = self._states[rule.name] = {
                    "rule": rule.name,
                    "severity": rule.severity,
                    "labels": dict(rule.labels),
                    "description": rule.description,
                    "for_s": rule.for_s,
                    "state": INACTIVE,
                    "pending_since": None,
                    "firing_since": None,
                    "resolved_at": None,
                    "message": "",
                    "events_emitted": 0,
                    "cause_id": None,
                }
            st["for_s"] = rule.for_s
            if active:
                st["message"] = message or st["message"]
                if st["state"] in (INACTIVE, RESOLVED):
                    st["state"] = PENDING
                    st["pending_since"] = now
                    if self._timeline is not None:
                        self._timeline.record_event(
                            kind="alert-pending",
                            entity=self._alert_entity(rule),
                            detail=st["message"])
                if (st["state"] == PENDING
                        and now - st["pending_since"] >= rule.for_s):
                    st["state"] = FIRING
                    st["firing_since"] = now
                    st["resolved_at"] = None
                    st["events_emitted"] += 1
                    self._emit(rule, "Warning", FIRING_EVENT_REASON,
                               st["message"] or
                               f"alert {rule.name} firing")
                    logger.warning("alert %s FIRING: %s", rule.name,
                                   st["message"])
                    if self._timeline is not None:
                        self._timeline.record_event(
                            kind="alert-firing",
                            entity=self._alert_entity(rule),
                            detail=st["message"])
                    self._attribute(rule, st, now)
            else:
                if st["state"] == PENDING:
                    # never fired: no event owed, drop back silently
                    st["state"] = INACTIVE
                    st["pending_since"] = None
                elif st["state"] == FIRING:
                    st["state"] = RESOLVED
                    st["resolved_at"] = now
                    # a resolved incident is self-describing: firing
                    # duration plus the attributed cause id, so nobody
                    # has to re-query /causes from `kubectl get events`
                    resolved_msg = (f"alert {rule.name} resolved after "
                                    f"{now - st['firing_since']:.0f}s")
                    if st.get("cause_id"):
                        resolved_msg += f" (cause {st['cause_id']})"
                    self._emit(rule, "Normal", RESOLVED_EVENT_REASON,
                               resolved_msg)
                    logger.info("alert %s resolved", rule.name)
                    if self._timeline is not None:
                        self._timeline.record_event(
                            kind="alert-resolved",
                            entity=self._alert_entity(rule),
                            detail=resolved_msg)
        if self._metrics is not None:
            for st in self._states.values():
                self._metrics.set_gauge(
                    "alert_firing",
                    1.0 if st["state"] == FIRING else 0.0,
                    labels={"rule": st["rule"],
                            "severity": st["severity"]})

    def _attribute(self, rule: AlertRule, st: Dict[str, Any],
                   now: float) -> None:
        """Exactly one root-cause attribution per pending→firing edge
        (the same structural dedup as the firing Event — this runs only
        inside that transition): build the CauseReport, stamp its id on
        the rule state, and emit one ``SLOAlertAttributed`` Event naming
        the leading cause with its evidence pointer."""
        if self._causes is None:
            return
        try:
            report = self._causes.on_firing(rule, now)
        except Exception:  # exc: allow — attribution is observability-on-observability; a causes bug must never break alert evaluation
            logger.exception("cause attribution failed for %s", rule.name)
            return
        st["cause_id"] = report["id"]
        causes = report.get("causes") or []
        if causes:
            top = causes[0]
            message = (f"alert {rule.name} attributed to {top['kind']} "
                       f"on {top['entity']} (score {top['score']:g}"
                       f"{': ' + top['detail'] if top['detail'] else ''}"
                       f") — report {report['id']}, "
                       f"{len(causes)} candidate(s)")
        else:
            message = (f"alert {rule.name} attributed to no candidate "
                       f"cause in the {report['window_s']:.0f}s burn "
                       f"window — report {report['id']}")
        self._emit(rule, "Warning", ATTRIBUTED_EVENT_REASON, message)

    def _emit(self, rule: AlertRule, event_type: str, reason: str,
              message: str) -> None:
        if self._recorder is None:
            return
        try:
            self._recorder.event(_AlertObject(rule.name), event_type,
                                 reason, message)
        except Exception:  # exc: allow — events are advisory; alert evaluation must not fail on the recorder
            logger.exception("alert event emit failed for %s", rule.name)

    # -------------------------------------------------------------- reads

    def status(self) -> List[Dict[str, Any]]:
        """JSON-able rule states, firing first then pending, for the
        ``/alerts`` endpoint and ``status --alerts``."""
        order = {FIRING: 0, PENDING: 1, RESOLVED: 2, INACTIVE: 3}
        return sorted((dict(st) for st in self._states.values()),
                      key=lambda st: (order.get(st["state"], 9),
                                      st["rule"]))

    def firing(self) -> List[str]:
        return [st["rule"] for st in self._states.values()
                if st["state"] == FIRING]
