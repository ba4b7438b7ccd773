"""The capacity arbiter: a market between training and serving.

A copy of the JAX package's ``market/arbiter.py``. One fleet, two
workloads: the elastic trainer shrinks on a reclaim and grows on
returned capacity (``train/harness.py``), the serving tier takes
replicas (``serving/``, the router binary ``router.py``). This module
decides when a training slice moves to serving and back:

- the **exchange rate** is demand over supply: serving pressure (the
  worse of the serving SLO's page-severity burn-rate multiple and the
  lane-weighted router backlog, priced by the router's
  :data:`~..serving.router.LANE_WEIGHTS`) over the marginal goodput one
  training slice contributes (from the goodput ledger,
  :func:`marginal_goodput`);
- **sustained** high rates preempt a training slice: ``training ->
  preempting -> serving``. Training drain-saves and vacates (the elastic
  trainer shrinks, pricing the window as ``degraded``), then the slice is
  handed to serving (the ``grant`` hook);
- **sustained** troughs return it: ``serving -> returning -> training``.
  The serving replica drains through the router (live migration
  included), then the trainer grows back
  (:class:`~..train.harness.GrowNotice`).

The hysteresis lives here, not in the trainer: a trade needs
``sustain_ticks`` consecutive ticks past its threshold plus a cooldown.

Every decision is **durable before it is acted on**: each member node
of the slice carries the :data:`~..wire.MARKET_OWNER_LABEL`, and its
anchor node the :data:`~..wire.MARKET_LEASE_ANNOTATION` (phase and
decision id) and the :data:`~..wire.MARKET_DECISION_ANNOTATION` (the
rationale as JSON). A restarted arbiter resumes mid-trade from them
(:meth:`CapacityArbiter.resume`).

A trade is refused while the slice is not clean (a member cordoned,
quarantined, reclaim-tainted or inside the upgrade drain window) or
while it would push cordoned and cordon-required nodes past the
``maxUnavailable`` budget.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Callable, Dict, List, Optional

from ..core.client import ApiError
from ..serving.pool import DRAIN_STATES
from ..serving.router import LANE_WEIGHTS
from ..upgrade.consts import UpgradeState
from ..utils.clock import Clock, RealClock
from ..wire import (MARKET_DECISION_ANNOTATION, MARKET_LEASE_ANNOTATION,
                    MARKET_OWNER_LABEL, QUARANTINE_LABEL,
                    RECLAIM_TAINT_KEY)

logger = logging.getLogger(__name__)

# trade phases; the wire owner label collapses both transitional phases
# to "draining"
TRAINING = "training"
PREEMPTING = "preempting"
SERVING = "serving"
RETURNING = "returning"
PHASES = (TRAINING, PREEMPTING, SERVING, RETURNING)

OWNER_LABELS = {TRAINING: "training", PREEMPTING: "draining",
                SERVING: "serving", RETURNING: "draining"}
# every value the owner label may carry in the cluster
LEGAL_OWNERS = ("training", "serving", "draining", "quarantined")

TRADE_REASON = "MarketTrade"
RETURN_REASON = "MarketReturn"


class _MarketMeta:
    def __init__(self, name: str):
        self.name = name


class _MarketObject:
    """Event anchor: trades have no single node to attach to, so the
    Event's involved object is a synthetic ``CapacityMarket/<slice>``
    (the ``ServingRouter``/``SLOAlert`` pattern)."""

    kind = "CapacityMarket"

    def __init__(self, name: str = "market"):
        self.metadata = _MarketMeta(name)


def marginal_goodput(summary: Dict, slices: int) -> float:
    """Marginal goodput one slice contributes, from a ledger
    :func:`~..obs.goodput.summarize` dict: tokens/s split linearly
    across the job's ``slices`` (the Pollux linear-scaling prior — the
    arbiter only needs a consistent relative price, not a perfect
    scaling model)."""
    tps = summary.get("tokens_per_s") or 0.0
    return tps / max(1, int(slices))


@dataclasses.dataclass
class ManagedSlice:
    """One tradeable training slice: its id and member nodes (the first
    member is the ANCHOR carrying the durable lease/decision
    annotations)."""

    slice_id: str
    nodes: List[str]
    phase: str = TRAINING
    decision_id: int = 0
    since: float = 0.0          # wall seconds the phase was entered
    stamp_pending: bool = False  # durable write failed; retry next tick

    @property
    def anchor(self) -> str:
        return self.nodes[0]

    @property
    def owner(self) -> str:
        return OWNER_LABELS[self.phase]


@dataclasses.dataclass
class MarketConfig:
    preempt_rate: float = 2.0     # exchange rate that preempts training
    return_rate: float = 0.5      # rate below which capacity returns
    sustain_ticks: int = 3        # consecutive ticks past the threshold
    cooldown_seconds: float = 120.0
    queue_high: float = 4.0       # lane-pressure normalization per replica
    slo_name: str = "serving-ttft-p99"
    goodput_norm: float = 0.0     # tokens/s/slice worth pressure 1.0
    budget: Optional[int] = None  # scaled maxUnavailable (None = no check)
    decisions_kept: int = 32

    @classmethod
    def from_dict(cls, d: Dict) -> "MarketConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


class CapacityArbiter:
    """Reconcile-tick market arbiter over a list of
    :class:`ManagedSlice` supplies.

    Signals (all optional — absent signals price as zero pressure /
    unit value):

    - ``slo_engine`` — an SLO engine (``obs/slo.py:SLOEngine``, the
      operator's); its ``last`` evaluation of ``config.slo_name``
      supplies the burn-rate multiple;
    - ``demand`` — anything with ``lane_depths()`` and
      ``admitting_count()`` (a :class:`~..serving.router.RequestRouter`,
      or :class:`~.demand.HTTPLaneDemand` over the router binary's
      ``/lanes``);
    - ``goodput_fn()`` — marginal training goodput per slice
      (:func:`marginal_goodput` over a ledger summary), normalized by
      ``config.goodput_norm`` (0 = already normalized).

    Actuation hooks (all optional — without them a decision still
    journals, stamps the wire contract, and gauges; the dry-run mode):

    - ``preempt(ms)`` — ask training to vacate (the wire labels already
      say so; this is the in-process fast path);
    - ``vacated(ms) -> bool`` — has training left the slice?
    - ``grant(ms)`` — hand the vacated slice to serving;
    - ``revoke(ms) -> bool`` — drain serving off the slice (called every
      tick while returning; True once it is gone);
    - ``returned(ms)`` — capacity is back with training (deliver the
      trainer's :class:`~..train.harness.GrowNotice` here).
    """

    def __init__(self, supply: List[ManagedSlice], client=None,
                 component: str = "libtpu", demand=None, slo_engine=None,
                 goodput_fn: Optional[Callable[[], float]] = None,
                 preempt: Optional[Callable] = None,
                 vacated: Optional[Callable] = None,
                 grant: Optional[Callable] = None,
                 revoke: Optional[Callable] = None,
                 returned: Optional[Callable] = None,
                 recorder=None, metrics=None,
                 clock: Optional[Clock] = None,
                 config: Optional[MarketConfig] = None,
                 timeline=None):
        from ..upgrade.util import KeyFactory
        self.supply = list(supply)
        self._client = client
        self.keys = KeyFactory(component)
        self.demand = demand
        self.slo_engine = slo_engine
        self.goodput_fn = goodput_fn
        self._hooks = {"preempt": preempt, "vacated": vacated,
                       "grant": grant, "revoke": revoke,
                       "returned": returned}
        self._recorder = recorder
        self._metrics = metrics
        self._clock = clock or RealClock()
        # fleet black box (obs/timeline.py): every trade-phase decision
        # is a timeline event (entity trade/<id>, linked to its slice) —
        # a deliberate capacity move is a prime root-cause candidate
        self._timeline = timeline
        self.config = config or MarketConfig()
        self.decisions: List[Dict] = []
        self.trades = 0
        self.returns = 0
        self.last_rate = 0.0
        self.last_pressure = 0.0
        self.last_value = 1.0
        self._high_ticks = 0
        self._low_ticks = 0
        self._last_decision_t: Optional[float] = None
        self._next_decision = 1
        self._resumed = False

    # ------------------------------------------------------------ signals

    def serving_pressure(self) -> float:
        """Demand-side pressure: max of the SLO burn-rate multiple
        (page-severity pairs, like the autoscaler) and the lane-weighted
        router backlog normalized by admitting capacity. 1.0 ≈ "the
        serving tier is exactly at its limit"."""
        burn = 0.0
        if self.slo_engine is not None:
            status = (self.slo_engine.last or {}).get(
                self.config.slo_name) or {}
            for pair in status.get("burn") or []:
                if pair.get("triggered") and pair.get("severity") == "page":
                    factor = float(pair.get("factor") or 1.0)
                    burn = max(burn, float(pair.get("long_rate") or 0.0)
                               / max(factor, 1e-9))
        lane = 0.0
        if self.demand is not None:
            try:
                depths = self.demand.lane_depths()
                admitting = max(1, int(self.demand.admitting_count()))
            except Exception:  # exc: allow — the demand surface is advisory; price with empty lanes when it fails
                depths, admitting = {}, 1
            weighted = sum(LANE_WEIGHTS.get(name, 1.0) * depth
                           for name, depth in depths.items())
            capacity = (admitting * self.config.queue_high
                        * max(LANE_WEIGHTS.values()))
            lane = weighted / capacity if capacity > 0 else 0.0
        return max(burn, lane)

    def training_value(self) -> float:
        """Supply-side marginal value of one training slice; 1.0 when no
        goodput signal is wired (a slice is then worth exactly a
        fully-loaded serving tier)."""
        if self.goodput_fn is None:
            return 1.0
        try:
            raw = float(self.goodput_fn())
        except Exception:  # exc: allow — the goodput hook is external; any failure prices at parity
            return 1.0
        if self.config.goodput_norm > 0:
            return raw / self.config.goodput_norm
        return raw

    def exchange_rate(self) -> float:
        pressure = self.serving_pressure()
        value = self.training_value()
        self.last_pressure, self.last_value = pressure, value
        if value <= 0:
            return float("inf") if pressure > 0 else 0.0
        return pressure / value

    # --------------------------------------------------------------- tick

    def tick(self) -> Optional[Dict]:
        """One reconcile tick; returns the decision made this tick (the
        last one when several slices acted), else None."""
        if not self._resumed:
            self.resume()
        rate = self.exchange_rate()
        self.last_rate = rate
        if rate >= self.config.preempt_rate:
            self._high_ticks += 1
        else:
            self._high_ticks = 0
        if rate <= self.config.return_rate:
            self._low_ticks += 1
        else:
            self._low_ticks = 0
        decision = None
        for ms in self.supply:
            decision = self._step(ms, rate) or decision
            if ms.stamp_pending:
                self._stamp(ms)
        self._update_gauges()
        return decision

    def standby(self) -> None:
        """This candidate is not the leader: forget in-memory trade
        state so the next promotion resumes from the durable
        annotations, not from a stale view."""
        self._resumed = False

    def _cooldown_ok(self) -> bool:
        return (self._last_decision_t is None
                or self._clock.now() - self._last_decision_t
                >= self.config.cooldown_seconds)

    def _step(self, ms: ManagedSlice, rate: float) -> Optional[Dict]:
        if ms.phase == TRAINING:
            if (self._high_ticks >= self.config.sustain_ticks
                    and self._cooldown_ok() and self._tradeable(ms)):
                return self._decide(ms, PREEMPTING, "preempt", rate,
                                    f"serving pressure "
                                    f"{self.last_pressure:.2f} vs marginal "
                                    f"goodput {self.last_value:.2f}: rate "
                                    f"{rate:.2f} >= "
                                    f"{self.config.preempt_rate:g} for "
                                    f"{self._high_ticks} ticks")
        elif ms.phase == PREEMPTING:
            if self._call("vacated", ms, default=True):
                return self._decide(ms, SERVING, "grant", rate,
                                    "training vacated; slice handed to "
                                    "serving")
        elif ms.phase == SERVING:
            if (self._low_ticks >= self.config.sustain_ticks
                    and self._cooldown_ok()):
                return self._decide(ms, RETURNING, "return", rate,
                                    f"trough: rate {rate:.2f} <= "
                                    f"{self.config.return_rate:g} for "
                                    f"{self._low_ticks} ticks")
        elif ms.phase == RETURNING:
            if self._call("revoke", ms, default=True):
                return self._decide(ms, TRAINING, "returned", rate,
                                    "serving drained; capacity back with "
                                    "training")
        return None

    def _call(self, name: str, ms: ManagedSlice, default: bool):
        hook = self._hooks.get(name)
        if hook is None:
            return default
        try:
            return hook(ms)
        except Exception:  # exc: allow — market hooks are tenant callbacks; a raising hook reads as its safe default
            logger.exception("market %s hook raised for slice %s", name,
                             ms.slice_id)
            return False

    def _decide(self, ms: ManagedSlice, phase: str, action: str,
                rate: float, reason: str) -> Dict:
        ms.phase = phase
        ms.decision_id = self._next_decision
        self._next_decision += 1
        ms.since = self._clock.wall()
        decision = {"id": ms.decision_id, "t": ms.since,
                    "action": action, "slice": ms.slice_id,
                    "rate": round(rate, 4) if rate != float("inf")
                    else "inf",
                    "pressure": round(self.last_pressure, 4),
                    "value": round(self.last_value, 4),
                    "reason": reason}
        self.decisions.append(decision)
        del self.decisions[:-self.config.decisions_kept]
        if self._timeline is not None:
            entity = f"trade/{ms.decision_id}"
            self._timeline.link(entity, f"slice/{ms.slice_id}")
            self._timeline.record_event(
                kind="market-trade", entity=entity,
                detail=f"{action} {ms.slice_id}: {reason}")
        self._last_decision_t = self._clock.now()
        self._stamp(ms)
        if action == "preempt":
            self.trades += 1
            self._event("Normal", TRADE_REASON, ms, reason)
            self._call("preempt", ms, default=True)
        elif action == "grant":
            self._call("grant", ms, default=True)
        elif action == "return":
            self._event("Normal", RETURN_REASON, ms, reason)
            self._call("revoke", ms, default=True)
        elif action == "returned":
            self.returns += 1
            self._call("returned", ms, default=True)
        logger.info("market decision #%d: %s slice %s (%s)",
                    decision["id"], action, ms.slice_id, reason)
        return decision

    # ------------------------------------------------------------- guards

    def _tradeable(self, ms: ManagedSlice) -> bool:
        """A slice may only trade while every member is clean (not
        cordoned / quarantined / reclaim-tainted / in the upgrade drain
        window) and the trade fits under the maxUnavailable budget
        including the cordon-required lookahead."""
        if self._client is None:
            return True
        held = 0
        members = set(ms.nodes)
        try:
            for node in self._client.direct().list_nodes():
                name = node.metadata.name
                labels = node.metadata.labels
                state = labels.get(self.keys.state_label, "")
                taken = node.spec.unschedulable or \
                    state == UpgradeState.CORDON_REQUIRED
                if taken and name not in members:
                    held += 1
                if name in members:
                    if (taken or not node.is_ready()
                            or QUARANTINE_LABEL in labels
                            or any(t.key == RECLAIM_TAINT_KEY
                                   for t in node.spec.taints)
                            or state in DRAIN_STATES):
                        return False
        except Exception:  # exc: allow — any view failure defers the trade — the market trades on truth, never a guess
            # the cluster view is unavailable: defer the trade — the
            # market trades on truth, never on a guess
            return False
        budget = self.config.budget
        if budget is not None and held + len(ms.nodes) > budget:
            return False
        return True

    # ----------------------------------------------------- durable stamps

    def _stamp(self, ms: ManagedSlice) -> None:
        """Persist the slice's market state: the owner label on every
        member, the lease + decision rationale on the anchor. A failed
        write marks the slice ``stamp_pending`` and is retried every
        tick — the wire contract converges even through conflict storms,
        and a leader failover resumes from whatever landed."""
        if self._client is None:
            ms.stamp_pending = False
            return
        lease = f"{ms.phase}:{ms.decision_id}@{self._clock.wall():.3f}"
        decision = next((d for d in reversed(self.decisions)
                         if d["slice"] == ms.slice_id), None)
        try:
            for node in ms.nodes:
                labels = {MARKET_OWNER_LABEL: ms.owner}
                if node == ms.anchor:
                    annotations = {MARKET_LEASE_ANNOTATION: lease}
                    if decision is not None:
                        annotations[MARKET_DECISION_ANNOTATION] = \
                            json.dumps(decision, sort_keys=True)
                    self._client.patch_node_metadata(
                        node, labels=labels, annotations=annotations)
                else:
                    self._client.patch_node_metadata(node, labels=labels)
            ms.stamp_pending = False
        except (ApiError, TimeoutError):
            ms.stamp_pending = True
            logger.warning("could not stamp market state %s on slice %s; "
                           "retrying next tick", ms.phase, ms.slice_id,
                           exc_info=True)

    def resume(self) -> None:
        """Rebuild trade state from the durable anchor annotations — the
        leader-failover path: a promoted standby continues every
        in-flight trade exactly where the old leader left it."""
        self._resumed = True
        if self._client is None:
            return
        for ms in self.supply:
            try:
                node = self._client.direct().get_node(ms.anchor)
            except Exception:  # exc: allow — resume keeps defaults on any read failure; the stamp re-asserts and converges
                continue        # keep defaults; stamp will converge
            lease = node.metadata.annotations.get(MARKET_LEASE_ANNOTATION)
            if not lease:
                continue
            phase = lease.split(":", 1)[0]
            if phase not in PHASES:
                continue
            try:
                did = int(lease.split(":", 1)[1].split("@", 1)[0])
            except (IndexError, ValueError):
                did = 0
            if phase != ms.phase:
                logger.info("market resume: slice %s was %s (decision "
                            "#%d) in the cluster; continuing the trade",
                            ms.slice_id, phase, did)
            ms.phase = phase
            ms.decision_id = did
            self._next_decision = max(self._next_decision, did + 1)
            raw = node.metadata.annotations.get(MARKET_DECISION_ANNOTATION)
            if raw and not any(d.get("id") == did for d in self.decisions):
                try:
                    self.decisions.append(json.loads(raw))
                except ValueError:
                    pass

    # -------------------------------------------------------------- views

    def leased_slice_ids(self) -> set:
        """Slices currently lent to serving (the autoscaler's placement
        preference)."""
        return {ms.slice_id for ms in self.supply if ms.phase == SERVING}

    def ownership(self) -> List[Dict]:
        return [{"slice": ms.slice_id, "owner": ms.owner,
                 "phase": ms.phase, "nodes": list(ms.nodes),
                 "decision_id": ms.decision_id,
                 "stamp_pending": ms.stamp_pending}
                for ms in self.supply]

    def payload(self) -> Dict:
        """The ``/market`` envelope body ``status --market`` renders."""
        lanes = None
        if self.demand is not None:
            try:
                lanes = self.demand.lane_stats()
            except Exception:  # exc: allow — the /market payload is best-effort observability
                lanes = None
        return {
            "rate": (self.last_rate if self.last_rate != float("inf")
                     else "inf"),
            "pressure": self.last_pressure,
            "value": self.last_value,
            "trades": self.trades,
            "returns": self.returns,
            "lanes": lanes,
            "ownership": self.ownership(),
            "decisions": list(self.decisions),
        }

    # ------------------------------------------------------------- output

    def _update_gauges(self) -> None:
        if self._metrics is None:
            return
        rate = self.last_rate
        self._metrics.set_gauge(
            "exchange_rate", rate if rate != float("inf") else -1.0)
        self._metrics.set_gauge("serving_pressure", self.last_pressure)
        self._metrics.set_gauge("training_value", self.last_value)
        self._metrics.set_gauge("trades", self.trades)
        self._metrics.set_gauge("returns", self.returns)
        self._metrics.set_gauge(
            "slices_lent",
            sum(1 for ms in self.supply if ms.phase != TRAINING))

    def _event(self, event_type: str, reason: str, ms: ManagedSlice,
               message: str) -> None:
        if self._recorder is None:
            return
        try:
            self._recorder.event(_MarketObject(ms.slice_id), event_type,
                                 reason, message)
        except Exception:  # exc: allow — events are advisory; never fail the decree on the recorder
            logger.warning("could not record %s event", reason,
                           exc_info=True)
