"""Root-cause attribution: from an alert's firing edge to ranked causes.

A copy of the JAX package's ``obs/causes.py``. When an SLO alert fires,
:class:`CauseAnalyzer` ranks the fleet timeline's events
(``obs/timeline.py``) that overlap the alert's burn window:

1. the alert's SLO resolves to its metric families and those to entity
   scopes (:data:`METRIC_FAMILY_SCOPES`, plus the fleet-wide
   :data:`ALWAYS_SCOPES`);
2. every timeline event overlapping the burn window is a candidate;
3. each scores ``overlap x distance decay x kind prior``: the share of
   the event's own window inside the burn window, the entity-graph hops
   to the first scope match (:data:`DISTANCE_DECAY`, :data:`FAR_DECAY`),
   and the closed :data:`CAUSE_PRIORS` table.

Each cause cites the timeline events behind it. :func:`causes_payload`
is the body of the ``/causes`` envelope; the router binary serves it
with its timeline alone (it evaluates no alerts, so its reports list is
empty).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.clock import Clock, RealClock
from .timeline import FleetEvent, FleetTimeline

logger = logging.getLogger(__name__)

# counter families this module emits through the hub (full exposed
# names)
CAUSES_COUNTER_FAMILIES = (
    "tpu_operator_alert_attributed_total",
)

# Kind priors: how likely each event kind is to be a ROOT cause rather
# than a symptom, all else equal (a subset of EVENT_KINDS). Kinds absent
# here (the alert-* kinds: an alert never causes itself) are not
# candidates at all.
CAUSE_PRIORS = {
    "chaos-fault": 1.0,        # labeled ground truth when present
    "breaker-open": 0.9,       # control plane lost
    "degraded-enter": 0.85,    # operator fail-static
    "health-verdict": 0.8,     # hardware/driver went bad
    "router-requeue": 0.7,     # replica crash took requests with it
    "market-trade": 0.65,      # capacity deliberately moved
    "router-shed": 0.6,        # admission pressure
    "journey-transition": 0.55,  # rolling upgrade churn
    "router-drain": 0.5,       # planned replica drain
    "router-migration": 0.45,  # live splice (mitigation, mild symptom)
    "breaker-close": 0.2,      # recovery edges explain resolution,
    "degraded-exit": 0.2,      # not onset — kept low, not excluded
}

# Metric family -> entity-name prefixes whose events can plausibly move
# it; unknown families fall back to DEFAULT_SCOPES.
METRIC_FAMILY_SCOPES = {
    "tpu_operator_phase_duration_seconds": ("node/", "slice/"),
    "tpu_operator_unavailable_nodes": ("node/", "slice/"),
    "tpu_operator_drain_duration_seconds": ("node/", "slice/"),
    "tpu_workload_serve_ttft_seconds": (
        "request/", "replica/", "lane/", "slice/", "node/"),
    "tpu_operator_health_reaction_seconds": ("node/", "slice/"),
}
DEFAULT_SCOPES = ("node/", "slice/")
# Fleet-global actors every SLO can be moved by, appended to every
# family's scopes: the apiserver and its breaker, the operator's own
# mode flips, admission lanes, and capacity trades.
ALWAYS_SCOPES = ("apiserver/", "breaker/", "operator/", "lane/",
                 "trade/")

# distance-decay ladder: hops up the entity graph until scope match
DISTANCE_DECAY = (1.0, 0.7, 0.5, 0.35)
FAR_DECAY = 0.25  # entity whose ancestor chain never reaches scope

# severity -> default burn-window lookback when the SLO spec carries no
# matching window (the fastest of the JAX package's obs/slo.py
# DEFAULT_BURN_WINDOWS per severity)
DEFAULT_WINDOW_BY_SEVERITY = {"page": 3600.0, "ticket": 259200.0}

TOP_CAUSES = 8            # ranked causes kept per report
EVIDENCE_PER_CAUSE = 8    # newest events cited per cause
DEFAULT_REPORT_RING = 64  # reports retained (bounded like every ring)


def _spec_name_metric_windows(spec) -> Tuple[str, str, tuple]:
    if isinstance(spec, dict):
        return (str(spec.get("name", "")), str(spec.get("metric", "")),
                ())
    return (spec.name, spec.metric, tuple(getattr(spec, "burn_windows",
                                                  ()) or ()))


class CauseAnalyzer:
    """Walks the timeline + entity graph backwards from a firing alert
    into a ranked, evidence-chained ``CauseReport``."""

    def __init__(self, timeline: FleetTimeline, specs=None,
                 clock: Optional[Clock] = None, metrics=None,
                 report_ring: int = DEFAULT_REPORT_RING):
        self.timeline = timeline
        self._clock = clock or RealClock()
        self._metrics = metrics
        self.report_ring = max(1, int(report_ring))
        self.reports: List[dict] = []
        self.dropped_reports = 0
        self.attributed_total = 0
        self._fired_counts: Dict[str, int] = {}
        self._specs: Dict[str, Tuple[str, tuple]] = {}
        for spec in (specs or ()):
            name, metric, windows = _spec_name_metric_windows(spec)
            if name:
                self._specs[name] = (metric, windows)

    # ----------------------------------------------------------- window

    def _burn_window_s(self, slo: str, severity: str) -> float:
        metric_windows = self._specs.get(slo)
        if metric_windows is not None:
            for bw in metric_windows[1]:
                if getattr(bw, "severity", None) == severity:
                    return float(bw.long_s)
        return DEFAULT_WINDOW_BY_SEVERITY.get(severity, 3600.0)

    def _families(self, slo: str) -> Tuple[str, ...]:
        metric_windows = self._specs.get(slo)
        if metric_windows is not None and metric_windows[0]:
            return (metric_windows[0],)
        return ()

    # ---------------------------------------------------------- scoring

    def _scopes(self, families: Sequence[str]) -> Tuple[str, ...]:
        scopes: List[str] = []
        for family in families:
            for prefix in METRIC_FAMILY_SCOPES.get(family,
                                                   DEFAULT_SCOPES):
                if prefix not in scopes:
                    scopes.append(prefix)
        if not scopes:
            scopes.extend(DEFAULT_SCOPES)
        for prefix in ALWAYS_SCOPES:
            if prefix not in scopes:
                scopes.append(prefix)
        return tuple(scopes)

    @staticmethod
    def _overlap(ev: FleetEvent, since: float, until: float) -> float:
        """Fraction of the event's window SO FAR — clipped at the
        query's ``until`` (the firing edge) — that lies inside
        [since, until].  A still-burning fault counts fully (its
        scheduled future is irrelevant to why the alert fired NOW);
        only the part of its history predating the window discounts
        it.  Instantaneous events count 1.0 when inside."""
        end = until if ev.until is None else min(ev.until, until)
        if ev.until is None or end <= ev.t:
            return 1.0 if since <= ev.t <= until else 0.0
        span = end - ev.t
        inter = end - max(ev.t, since)
        return max(0.0, min(1.0, inter / span))

    def _distance(self, entity: str, scopes: Tuple[str, ...]) -> int:
        """Hops up the entity graph to the first scope match; -1 when
        the chain never reaches scope."""
        if entity.startswith(scopes):
            return 0
        for hops, ancestor in enumerate(
                self.timeline.ancestors(entity), start=1):
            if ancestor.startswith(scopes):
                return hops
        return -1

    @staticmethod
    def _decay(distance: int) -> float:
        if distance < 0:
            return FAR_DECAY
        if distance < len(DISTANCE_DECAY):
            return DISTANCE_DECAY[distance]
        return DISTANCE_DECAY[-1]

    # ------------------------------------------------------- attribution

    def attribute(self, rule: str, slo: str, severity: str,
                  fired_at: float, window_s: Optional[float] = None,
                  families: Optional[Sequence[str]] = None) -> dict:
        """Build (and retain) one CauseReport for a firing edge."""
        if window_s is None:
            window_s = self._burn_window_s(slo, severity)
        if families is None:
            families = self._families(slo)
        scopes = self._scopes(families)
        since = fired_at - window_s
        groups: Dict[Tuple[str, str], dict] = {}
        for ev in self.timeline.events_overlapping(since, fired_at):
            prior = CAUSE_PRIORS.get(ev.kind)
            if prior is None or ev.entity.startswith("alert/"):
                continue
            overlap = self._overlap(ev, since, fired_at)
            if overlap <= 0.0:
                continue
            distance = self._distance(ev.entity, scopes)
            score = round(overlap * self._decay(distance) * prior, 6)
            group = groups.get((ev.entity, ev.kind))
            if group is None or score > group["score"] or (
                    score == group["score"]
                    and ev.t > group["_best_t"]):
                base = group["evidence"] if group else []
                group = {"kind": ev.kind, "entity": ev.entity,
                         "score": score, "overlap": round(overlap, 6),
                         "distance": distance, "prior": prior,
                         "detail": ev.detail, "_best_t": ev.t,
                         "evidence": base}
                groups[(ev.entity, ev.kind)] = group
            group["evidence"].append(ev.to_dict())
            del group["evidence"][:-EVIDENCE_PER_CAUSE]
        ranked = sorted(groups.values(),
                        key=lambda g: (-g["score"], g["entity"],
                                       g["kind"]))[:TOP_CAUSES]
        for rank, group in enumerate(ranked, start=1):
            group.pop("_best_t", None)
            group["rank"] = rank
        n = self._fired_counts.get(rule, 0) + 1
        self._fired_counts[rule] = n
        report = {
            "id": f"{rule}#{n}",
            "rule": rule, "slo": slo, "severity": severity,
            "fired_at": fired_at, "window_s": float(window_s),
            "families": list(families), "scopes": list(scopes),
            "causes": ranked,
        }
        self.reports.append(report)
        if len(self.reports) > self.report_ring:
            self.reports.pop(0)
            self.dropped_reports += 1
        self.attributed_total += 1
        if self._metrics is not None:
            top_kind = ranked[0]["kind"] if ranked else "none"
            self._metrics.inc("alert_attributed_total",
                              labels={"rule": rule, "kind": top_kind})
        return report

    def on_firing(self, rule, now: float) -> dict:
        """AlertManager hook: attribute one firing edge of ``rule``
        (an obs/alerts.py AlertRule)."""
        slo = rule.labels.get("slo", rule.name)
        return self.attribute(rule=rule.name, slo=slo,
                              severity=rule.severity, fired_at=now)

    # ---------------------------------------------------------- surface

    def latest_for(self, query: str) -> Optional[dict]:
        """Newest report whose rule or SLO matches ``query`` (exact
        rule, rule prefix before ``:burn:``, or SLO name)."""
        for report in reversed(self.reports):
            if query in (report["rule"], report["slo"]) or \
                    report["rule"].startswith(query + ":"):
                return report
        return None

    def payload(self) -> dict:
        return {
            "attributed_total": self.attributed_total,
            "retained": len(self.reports),
            "dropped": self.dropped_reports,
            "reports": list(self.reports),
        }


def causes_payload(analyzer: Optional[CauseAnalyzer] = None,
                   timeline: Optional[FleetTimeline] = None) -> dict:
    """The ``/causes`` envelope body for both metric servers.  The
    operator passes its analyzer (router passes only its timeline — it
    evaluates no alerts, so its reports list is empty)."""
    if analyzer is not None:
        data = analyzer.payload()
        if timeline is None:
            timeline = analyzer.timeline
    else:
        data = {"attributed_total": 0, "retained": 0, "dropped": 0,
                "reports": []}
    data["timeline"] = timeline.payload() if timeline is not None \
        else None
    return data


__all__ = ["CAUSE_PRIORS", "CAUSES_COUNTER_FAMILIES",
           "METRIC_FAMILY_SCOPES", "ALWAYS_SCOPES", "DISTANCE_DECAY",
           "FAR_DECAY", "TOP_CAUSES", "CauseAnalyzer", "causes_payload"]
