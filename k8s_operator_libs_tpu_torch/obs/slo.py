"""Declarative SLOs, error budgets, and multi-window burn-rate evaluation.

This is the layer that turns the histogram/gauge/ledger signals the
operator already emits into *conclusions*: "are we inside our 99.9%
availability budget this month", "is drain latency burning budget 14x too
fast". The model is the Google SRE workbook's:

- an **SLI** is derived from an existing metric family in the
  :class:`~.tsdb.TimeSeriesStore` — either *event-based* (``kind:
  events``: the fraction of histogram observations within a latency
  bound, straight from the ``_bucket`` ladders) or *time-based* (``kind:
  time``: the fraction of wall time a gauge satisfies a bound,
  step-interpolated);
- the **error budget** over the rolling ``window`` is ``1 - target`` of
  it; :meth:`SLOEngine.evaluate` reports the fraction still remaining;
- **burn rate** over a window is ``bad_fraction / (1 - target)`` — 1.0
  means "spending exactly the budget", 14.4 over 1h means the monthly
  budget dies in ~2 days. Alerting uses multi-window multi-burn-rate
  pairs (:data:`DEFAULT_BURN_WINDOWS`): a page needs the LONG window
  burning (real damage) AND the SHORT window burning (still happening),
  which kills both slow-burn false pages and already-recovered pages.

``obs`` sits below ``upgrade``/``health``/``tpu`` in the layering DAG, so
:data:`DEFAULT_SLO_SPECS` references metric families by their full
exposed names. Every referenced family has a ``HELP_TEXTS`` entry, and
every ``tpu_operator_slo_*``/``tpu_operator_alert_*`` HELP entry names a
family this engine (or :mod:`.alerts`) emits
(``tests/test_torch_slo.py`` holds both ways).

A copy of the JAX package's ``obs/slo.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Dict, List, Optional, Tuple

from ..utils.clock import Clock, RealClock
from .alerts import AlertRule
from .tsdb import TimeSeriesStore

logger = logging.getLogger(__name__)

PAGE = "page"
TICKET = "ticket"

# gauge families the engine emits through the hub/tsdb (full exposed
# names; each has a HELP_TEXTS entry)
SLO_GAUGE_FAMILIES = (
    "tpu_operator_slo_error_budget_remaining",
    "tpu_operator_slo_burn_rate",
)


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate pair: trigger when BOTH the long and
    the short window burn faster than ``factor``."""

    long_s: float
    short_s: float
    factor: float
    severity: str  # PAGE | TICKET


# The SRE-workbook ladder for a ~30d budget: 2% of budget in 1h or 5% in
# 6h pages; a steady 1x burn seen over 3d files a ticket.
DEFAULT_BURN_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=3600.0, short_s=300.0, factor=14.4, severity=PAGE),
    BurnWindow(long_s=21600.0, short_s=1800.0, factor=6.0, severity=PAGE),
    BurnWindow(long_s=259200.0, short_s=21600.0, factor=1.0,
               severity=TICKET),
)

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)([smhdw])")
_DURATION_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
                   "w": 604800.0}


def parse_duration(value) -> float:
    """``"30d"`` / ``"1h30m"`` / ``"90"`` / ``90`` → seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    text = str(value).strip()
    if re.fullmatch(r"\d+(\.\d+)?", text):
        return float(text)
    parts = _DURATION_RE.findall(text)
    if not parts or "".join(n + u for n, u in parts) != text:
        raise ValueError(f"unparseable duration {value!r}")
    return sum(float(n) * _DURATION_UNITS[u] for n, u in parts)


def format_duration(seconds: float) -> str:
    for unit, div in (("w", 604800.0), ("d", 86400.0), ("h", 3600.0),
                      ("m", 60.0)):
        if seconds >= div and seconds % div == 0:
            return f"{int(seconds / div)}{unit}"
    return f"{seconds:g}s"


# Shipped default objectives. Every "metric" family here must stay in
# HELP_TEXTS.
# The serving TTFT objective references the workload prefix — it simply
# reports "no data" on an operator whose tsdb never sees a serving hub.
DEFAULT_SLO_SPECS = (
    {"name": "upgrade-phase-duration",
     "metric": "tpu_operator_phase_duration_seconds",
     "kind": "events", "threshold": 1800.0, "target": 0.95,
     "window": "7d",
     "description": "95% of upgrade-pipeline phase transitions complete "
                    "within 30 minutes"},
    {"name": "slice-unavailability",
     "metric": "tpu_operator_unavailable_nodes",
     "kind": "time", "threshold": 0.0, "target": 0.99, "window": "7d",
     "description": "no cordoned/not-Ready managed nodes for 99% of "
                    "rolling-week wall time"},
    {"name": "drain-latency",
     "metric": "tpu_operator_drain_duration_seconds",
     "kind": "events", "threshold": 600.0, "target": 0.99, "window": "7d",
     "description": "99% of node drains finish within 10 minutes"},
    {"name": "serving-ttft-p99",
     "metric": "tpu_workload_serve_ttft_seconds",
     "kind": "events", "threshold": 2.5, "target": 0.99, "window": "7d",
     "description": "99% of serving requests see their first token "
                    "within 2.5 s"},
    {"name": "health-reaction-time",
     "metric": "tpu_operator_health_reaction_seconds",
     "kind": "events", "threshold": 600.0, "target": 0.95, "window": "7d",
     "description": "95% of unhealthy slices are quarantined within 10 "
                    "minutes of first leaving healthy"},
)


@dataclasses.dataclass
class SLOSpec:
    """One objective: ``good`` is metric ``op`` threshold; the target is
    the good fraction over the rolling window."""

    name: str
    metric: str                   # fully-prefixed family name
    kind: str = "events"          # "events" (histogram) | "time" (gauge)
    threshold: float = 0.0
    op: str = "le"                # good iff value <= ("le") / >= ("ge")
    target: float = 0.999
    window_s: float = 7 * 86400.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    description: str = ""
    burn_windows: Tuple[BurnWindow, ...] = DEFAULT_BURN_WINDOWS

    def __post_init__(self):
        if self.kind not in ("events", "time"):
            raise ValueError(f"slo {self.name}: unknown kind {self.kind!r}")
        if self.op not in ("le", "ge"):
            raise ValueError(f"slo {self.name}: unknown op {self.op!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"slo {self.name}: target must be in (0, 1), "
                             f"got {self.target}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOSpec":
        burn = d.get("burnWindows") or d.get("burn_windows")
        windows = DEFAULT_BURN_WINDOWS if burn is None else tuple(
            BurnWindow(long_s=parse_duration(w["long"]),
                       short_s=parse_duration(w["short"]),
                       factor=float(w["factor"]),
                       severity=str(w.get("severity", PAGE)))
            for w in burn)
        return cls(
            name=d["name"], metric=d["metric"],
            kind=d.get("kind", "events"),
            threshold=float(d.get("threshold", 0.0)),
            op=d.get("op", "le"),
            target=float(d.get("target", 0.999)),
            window_s=parse_duration(d.get("window", "7d")),
            labels=dict(d.get("labels") or {}),
            description=d.get("description", ""),
            burn_windows=windows)


@dataclasses.dataclass
class SLOOptions:
    """The ``slo:`` config section: which objectives to run and how the
    alert/no-data machinery behaves. ``from_dict`` accepts::

        slo:
          defaults: true          # include DEFAULT_SLO_SPECS
          objectives:             # extra (or replacement) objectives
            - name: drain-latency-strict
              metric: tpu_operator_drain_duration_seconds
              kind: events
              threshold: 120
              target: 0.999
              window: 3d
          alerting:
            pageFor: 120          # for: durations, pending -> firing
            ticketFor: 900
    """

    specs: List[SLOSpec] = dataclasses.field(default_factory=list)
    page_for_s: float = 120.0
    ticket_for_s: float = 900.0
    raw_points: int = 1024
    downsample_every: int = 16
    coarse_points: int = 1024

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SLOOptions":
        d = d or {}
        specs: List[SLOSpec] = []
        if d.get("defaults", True):
            specs.extend(SLOSpec.from_dict(s) for s in DEFAULT_SLO_SPECS)
        by_name = {s.name: s for s in specs}
        for raw in d.get("objectives") or []:
            spec = SLOSpec.from_dict(raw)
            by_name[spec.name] = spec  # same name overrides a default
        alerting = d.get("alerting") or {}
        history = d.get("history") or {}
        return cls(
            specs=list(by_name.values()),
            page_for_s=parse_duration(alerting.get("pageFor", 120)),
            ticket_for_s=parse_duration(alerting.get("ticketFor", 900)),
            raw_points=int(history.get("rawPoints", 1024)),
            downsample_every=int(history.get("downsampleEvery", 16)),
            coarse_points=int(history.get("coarsePoints", 1024)))


class SLOEngine:
    """Evaluates every spec against the tsdb once per reconcile tick and
    publishes the budget/burn gauges (hub for ``/metrics``, tsdb for the
    dashboard sparklines)."""

    def __init__(self, tsdb: TimeSeriesStore, specs: List[SLOSpec],
                 clock: Optional[Clock] = None, metrics=None):
        self.tsdb = tsdb
        self.specs = list(specs)
        self._clock = clock or RealClock()
        self._metrics = metrics
        self.last: Dict[str, Dict[str, Any]] = {}

    # --------------------------------------------------------- fractions

    def _bad_fraction_events(self, spec: SLOSpec,
                             window_s: float) -> Optional[float]:
        buckets = self.tsdb.bucket_increases(
            spec.metric, spec.labels or None, window_s=window_s)
        if not buckets:
            return None
        total = buckets[-1][1]
        if total <= 0:
            return None
        # good = observations <= the tightest bucket bound covering the
        # threshold from below (conservative when the threshold sits
        # between bounds)
        good = 0.0
        for le, count in buckets:
            if le <= spec.threshold:
                good = count
            else:
                break
        if spec.op == "ge":
            good = total - good
        return min(1.0, max(0.0, (total - good) / total))

    def _bad_fraction_time(self, spec: SLOSpec,
                           window_s: float) -> Optional[float]:
        if spec.op == "le":
            bad = lambda v: v > spec.threshold  # noqa: E731
        else:
            bad = lambda v: v < spec.threshold  # noqa: E731
        bad_s, covered_s = self.tsdb.time_fraction(
            spec.metric, spec.labels or None, window_s=window_s,
            predicate=bad)
        if covered_s <= 0:
            return None
        return min(1.0, max(0.0, bad_s / covered_s))

    def bad_fraction(self, spec: SLOSpec,
                     window_s: float) -> Optional[float]:
        """Bad fraction of the trailing window, or None with no data."""
        if spec.kind == "events":
            return self._bad_fraction_events(spec, window_s)
        return self._bad_fraction_time(spec, window_s)

    # -------------------------------------------------------- evaluation

    def evaluate(self) -> Dict[str, Dict[str, Any]]:
        """→ {slo name: status dict} (JSON-able; the ``/slo`` endpoint
        and ``status --slo`` render exactly this)."""
        out: Dict[str, Dict[str, Any]] = {}
        for spec in self.specs:
            try:
                out[spec.name] = self._evaluate_one(spec)
            except Exception:  # exc: allow — per-SLO isolation: one bad spec must not kill the other evaluations
                logger.exception("SLO %s evaluation failed", spec.name)
        self.last = out
        return out

    def _evaluate_one(self, spec: SLOSpec) -> Dict[str, Any]:
        budget_fraction = 1.0 - spec.target
        window_bad = self.bad_fraction(spec, spec.window_s)
        no_data = window_bad is None
        consumed = 0.0 if no_data else window_bad / budget_fraction
        remaining = 1.0 - consumed

        burn: List[Dict[str, Any]] = []
        worst: Optional[str] = None
        for bw in spec.burn_windows:
            long_bad = self.bad_fraction(spec, bw.long_s)
            short_bad = self.bad_fraction(spec, bw.short_s)
            long_rate = (None if long_bad is None
                         else long_bad / budget_fraction)
            short_rate = (None if short_bad is None
                          else short_bad / budget_fraction)
            triggered = bool(long_rate is not None and
                             short_rate is not None and
                             long_rate > bw.factor and
                             short_rate > bw.factor)
            burn.append({
                "long": format_duration(bw.long_s),
                "short": format_duration(bw.short_s),
                "long_s": bw.long_s, "short_s": bw.short_s,
                "factor": bw.factor, "severity": bw.severity,
                "long_rate": long_rate, "short_rate": short_rate,
                "triggered": triggered,
            })
            if triggered and (worst is None or
                              (bw.severity == PAGE and worst == TICKET)):
                worst = bw.severity

        status: Dict[str, Any] = {
            "name": spec.name,
            "metric": spec.metric,
            "kind": spec.kind,
            "op": spec.op,
            "threshold": spec.threshold,
            "target": spec.target,
            "window": format_duration(spec.window_s),
            "window_s": spec.window_s,
            "description": spec.description,
            "no_data": no_data,
            "bad_fraction": window_bad,
            "error_budget_remaining": remaining,
            "error_budget_consumed": consumed,
            "burn": burn,
            "breach": worst,
        }
        if spec.kind == "events":
            status["quantiles"] = {
                q: self.tsdb.quantile(spec.metric, p, spec.labels or None,
                                      window_s=spec.window_s)
                for q, p in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))}
            buckets = self.tsdb.bucket_increases(
                spec.metric, spec.labels or None, window_s=spec.window_s)
            status["events_total"] = buckets[-1][1] if buckets else 0.0
        else:
            latest = self.tsdb.latest(spec.metric, spec.labels or None)
            status["current_value"] = None if latest is None else latest[1]

        # budget gauge on /metrics; the same number into the tsdb so the
        # dashboard can sparkline it without a second scrape cycle
        if self._metrics is not None:
            self._metrics.set_gauge("slo_error_budget_remaining", remaining,
                                    labels={"slo": spec.name})
        self.tsdb.record("tpu_operator_slo_error_budget_remaining",
                         {"slo": spec.name}, remaining)
        fastest = burn[0] if burn else None
        if fastest is not None and fastest["long_rate"] is not None:
            if self._metrics is not None:
                self._metrics.set_gauge(
                    "slo_burn_rate", fastest["long_rate"],
                    labels={"slo": spec.name, "window": fastest["long"]})
            self.tsdb.record("tpu_operator_slo_burn_rate",
                             {"slo": spec.name, "window": fastest["long"]},
                             fastest["long_rate"])
        return status

    # ----------------------------------------------------------- alerting

    def alert_conditions(self, statuses: Optional[Dict[str, Dict[str, Any]]]
                         = None, page_for_s: float = 120.0,
                         ticket_for_s: float = 900.0
                         ) -> List[Tuple[AlertRule, bool, str]]:
        """Burn-rate alert conditions for :meth:`.alerts.AlertManager.
        evaluate`: one rule per (SLO, severity) so pages and tickets
        dedup independently; active when ANY burn-window pair of that
        severity triggers."""
        statuses = self.last if statuses is None else statuses
        conditions: List[Tuple[AlertRule, bool, str]] = []
        for spec in self.specs:
            status = statuses.get(spec.name)
            if status is None:
                continue
            for severity, for_s in ((PAGE, page_for_s),
                                    (TICKET, ticket_for_s)):
                windows = [b for b in status["burn"]
                           if b["severity"] == severity]
                if not windows:
                    continue
                hot = [b for b in windows if b["triggered"]]
                message = ""
                if hot:
                    b = hot[0]
                    message = (
                        f"SLO {spec.name} burning error budget "
                        f"{b['long_rate']:.1f}x over {b['long']} and "
                        f"{b['short_rate']:.1f}x over {b['short']} "
                        f"(threshold {b['factor']}x, budget remaining "
                        f"{status['error_budget_remaining']:.1%})")
                rule = AlertRule(
                    name=f"{spec.name}:burn:{severity}",
                    severity=severity, for_s=for_s,
                    labels={"slo": spec.name},
                    description=spec.description)
                conditions.append((rule, bool(hot), message))
        return conditions
