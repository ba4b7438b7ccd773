"""Fleet usage meter: conservation-checked utilization accounting.

Every reconcile tick, every node-second of fleet capacity is attributed
to exactly one bucket of the closed :data:`USAGE_KINDS` catalog — the
Borg-style conservation discipline: capacity that is not serving or
training must show up as *named* waste (maintenance, quarantine, market
transition, fail-static freeze, idle), never silently vanish. The
conservation law holds exactly, per tick::

    sum(counts over all (kind, lane)) == nodes observed     (integers)
    sum(seconds) == nodes * elapsed == capacity seconds

because a node claims exactly one bucket per tick and seconds are
derived as ``count * elapsed`` — there is no float summation to drift.

Classification is purely from state the subsystems already publish:

- the health monitor's quarantine label,
- the upgrade state machine's per-component state label,
- the capacity market's owner label (``training``/``serving``/
  ``draining``) and lease annotation,
- the serving replica registry's replica + lane labels,
- the operator's own workload placements and fail-static DEGRADED gate.

Layering: ``obs`` imports no ``wire`` (nor any subsystem), so this
module never sees a label *key*. Callers (the operator) join the cluster labels and hand over a
:class:`NodeSignals` per node; this module classifies label *values*
only (the ``attribution.WINDOW_PHASES`` precedent).

Double claims (a quarantined node mid-upgrade on a draining slice) are
resolved by a priority sweep, the ``attribution._sweep`` pattern
flattened to one tick: every matching signal posts a *bid* via
:func:`_bid` and the highest :data:`KIND_PRIORITY` wins. Documented
order, highest first::

    degraded-frozen > health-quarantine > upgrade-maintenance
        > market-transition > serving > training > idle

DEGRADED (fail-static) ticks attribute the whole last-known fleet as
``degraded-frozen`` — frozen capacity is an operator-caused outage, and
must never launder into ``idle``.

The per-tick record (sealed into the billing ledger when a billing
engine is attached) carries both the tick delta and the running totals, so
a promoted standby resumes the account from the ledger tail::

    {"kind": "usage", "t": <wall>, "tick": 7, "elapsed_s": 1.0,
     "nodes": 16, "capacity_s": 16.0, "degraded": false,
     "counts": {"serving": {"interactive": 4}, "training": {"-": 12}},
     "cum": {"capacity_s": 112.0, "ticks": 7,
             "seconds": {"serving": {"interactive": 28.0}, ...}}}

``lane`` is a real lane name only for ``serving``; every other kind
uses :data:`LANE_NONE`.

A copy of the JAX package's ``obs/usage.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.clock import Clock, RealClock

# The closed catalog, equal to KIND_PRIORITY's keys; runtime claims of
# an unknown kind raise (the timeline EVENT_KINDS discipline).
USAGE_KINDS = (
    "degraded-frozen",
    "health-quarantine",
    "upgrade-maintenance",
    "market-transition",
    "serving",
    "training",
    "idle",
)

# Priority sweep order, highest wins a contested node-second. Unique
# ranks — the winner is always deterministic.
KIND_PRIORITY = {
    "degraded-frozen": 6,
    "health-quarantine": 5,
    "upgrade-maintenance": 4,
    "market-transition": 3,
    "serving": 2,
    "training": 1,
    "idle": 0,
}

# Partition of the catalog for the efficiency headline: productive
# kinds are the numerator, waste kinds feed the waste-bucket tracker.
PRODUCTIVE_KINDS = ("serving", "training")
WASTE_KINDS = ("degraded-frozen", "health-quarantine",
               "upgrade-maintenance", "market-transition", "idle")

# Upgrade state-label VALUES that mean "inside a maintenance window"
# (the state machine's in-progress set plus the failed terminal, which
# also holds the node out of service). Wire-value keyed, like
# attribution.WINDOW_PHASES — callers join the label key.
MAINTENANCE_STATES = frozenset((
    "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
    "drain-required", "pod-restart-required", "validation-required",
    "uncordon-required", "upgrade-failed"))

# Market owner-label VALUES (arbiter.OWNER_LABELS range).
OWNER_TRAINING = "training"
OWNER_SERVING = "serving"
OWNER_DRAINING = "draining"

# Lane label value for every non-serving kind (and for serving capacity
# that has no registered replica lane yet).
LANE_NONE = "-"

# Metric families this module emits (full names carry the operator
# prefix); each has a HELP_TEXTS entry.
USAGE_COUNTER_FAMILIES = ("usage_seconds_total",)
USAGE_GAUGE_FAMILIES = ("usage_efficiency", "usage_capacity_nodes",
                        "usage_fleet_goodput_fraction")


@dataclasses.dataclass
class NodeSignals:
    """One node's already-published state, joined by the caller.

    All fields are label *values* (or presence booleans) — never keys:

    - ``quarantined``: the health quarantine label is present;
    - ``upgrade_state``: the component state label's value ("" when
      absent / idle);
    - ``market_owner``: the market owner label's value ("" off-market);
    - ``lane`` / ``replica``: the serving registry's lane label value
      and whether a replica-id label is present;
    - ``training``: the caller knows a training workload is placed here
      (operator placements, or the market owner says so).
    """

    node: str
    quarantined: bool = False
    upgrade_state: str = ""
    market_owner: str = ""
    lane: str = ""
    replica: bool = False
    training: bool = False


def _bid(kind: str, lane: str = LANE_NONE) -> Tuple[int, str, str]:
    """One attribution bid: ``(priority, kind, lane)``. Unknown kinds
    raise — the catalog is closed at runtime exactly like the timeline's
    EVENT_KINDS."""
    try:
        return (KIND_PRIORITY[kind], kind, lane)
    except KeyError:
        raise ValueError(f"unknown usage kind {kind!r}; "
                         f"catalog: {USAGE_KINDS}") from None


def classify(sig: NodeSignals, degraded: bool = False) -> Tuple[str, str]:
    """Classify one node for one tick: collect every bid the published
    state supports, highest :data:`KIND_PRIORITY` wins. Exactly one
    ``(kind, lane)`` comes back — conservation by construction."""
    if degraded:
        # fail-static: the view is frozen, nothing below is trustworthy
        prio, kind, lane = _bid("degraded-frozen")
        return kind, lane
    bids = [_bid("idle")]
    if sig.training or sig.market_owner == OWNER_TRAINING:
        bids.append(_bid("training"))
    if sig.replica or sig.market_owner == OWNER_SERVING:
        bids.append(_bid("serving", sig.lane or LANE_NONE))
    if sig.market_owner == OWNER_DRAINING:
        bids.append(_bid("market-transition"))
    if sig.upgrade_state in MAINTENANCE_STATES:
        bids.append(_bid("upgrade-maintenance"))
    if sig.quarantined:
        bids.append(_bid("health-quarantine"))
    prio, kind, lane = max(bids)
    return kind, lane


class UsageMeter:
    """Per-tick fleet attribution with exact conservation.

    Memory is fixed: the running account is bounded by
    ``|USAGE_KINDS| x |lanes|`` cells, waste windows by
    ``max_waste_buckets`` — fleet size only changes the integers, never
    the footprint (the fleetbench 10k-node pin).

    ``billing`` (an engine with the surface of the JAX package's
    ``obs/billing.py:BillingEngine``: ``tail``, ``standby``, ``settle``,
    ``summary``, ``fleet_goodput_fraction``) is optional; with
    it, every tick settles into the durable usage ledger and the meter
    resumes its running totals from the ledger tail on the first
    observation — the leader-failover path.
    """

    def __init__(self, clock: Optional[Clock] = None, metrics=None,
                 billing=None, max_waste_buckets: int = 32):
        self.clock = clock or RealClock()
        self._metrics = metrics
        self.billing = billing
        self._max_waste = int(max_waste_buckets)
        self._last_t: Optional[float] = None
        self.ticks = 0
        # cumulative seconds per (kind, lane); bounded by kinds x lanes
        self.totals: Dict[Tuple[str, str], float] = {}
        self.capacity_s = 0.0
        self.last: Optional[Dict[str, Any]] = None
        self._last_nodes: List[str] = []
        # waste windows: kind -> open bucket; closed ones keep the top N
        self._open_waste: Dict[str, Dict[str, Any]] = {}
        self._closed_waste: List[Dict[str, Any]] = []
        self._resumed = False

    # ------------------------------------------------------------ resume

    def _resume(self) -> None:
        """Continue the account from the ledger tail (once, lazily): a
        promoted standby's first tick spans the gap since the old
        leader's last record, so no capacity second is dropped across a
        failover or restart."""
        self._resumed = True
        if self.billing is None:
            return
        tail = self.billing.tail()
        if not tail:
            return
        self._last_t = float(tail.get("t", 0.0))
        if not self._last_nodes:
            # the ledger stores counts, never node names; a promoted
            # standby that goes DEGRADED before its first healthy tick
            # still must freeze the last-known fleet SIZE, so resume
            # placeholder identities from the tail's node count
            self._last_nodes = [f"~resumed-{i}" for i in
                                range(int(tail.get("nodes", 0)))]
        cum = tail.get("cum") or {}
        self.capacity_s = float(cum.get("capacity_s", 0.0))
        self.ticks = int(cum.get("ticks", 0))
        for kind, lanes in (cum.get("seconds") or {}).items():
            for lane, seconds in lanes.items():
                self.totals[(kind, lane)] = float(seconds)

    def standby(self) -> None:
        """Forget the in-memory account (the capacity arbiter's standby
        discipline): a candidate not holding leadership must re-resume
        from the ledger tail when it next leads — billing off its own
        stale ``_last_t`` would re-charge a span the real leader
        already settled."""
        self._resumed = False
        self._last_t = None
        self.ticks = 0
        self.totals = {}
        self.capacity_s = 0.0
        self.last = None
        self._last_nodes = []
        self._open_waste = {}
        self._closed_waste = []
        if self.billing is not None:
            self.billing.standby()

    # ----------------------------------------------------------- observe

    def observe(self, signals: Sequence[NodeSignals],
                degraded: bool = False,
                lane_tokens: Optional[Dict[str, int]] = None
                ) -> Dict[str, Any]:
        """Attribute one tick. Returns the sealed usage record (also
        kept as ``self.last``); with billing attached the record is
        priced and appended to the durable ledger."""
        if not self._resumed:
            self._resume()
        now = self.clock.wall()
        elapsed = 0.0
        if self._last_t is not None:
            elapsed = max(0.0, now - self._last_t)
        self._last_t = now
        counts: Dict[Tuple[str, str], int] = {}
        for sig in signals:
            kind, lane = classify(sig, degraded=degraded)
            counts[(kind, lane)] = counts.get((kind, lane), 0) + 1
        if not degraded:
            self._last_nodes = [sig.node for sig in signals]
        nodes = len(signals)
        # conservation: every node claimed exactly one bucket
        assert sum(counts.values()) == nodes
        self.ticks += 1
        self.capacity_s += nodes * elapsed
        for key, n in counts.items():
            self.totals[key] = self.totals.get(key, 0.0) + n * elapsed
        self._track_waste(counts, now, elapsed)
        record = {
            "kind": "usage", "t": now, "tick": self.ticks,
            "elapsed_s": elapsed, "nodes": nodes,
            "capacity_s": nodes * elapsed, "degraded": bool(degraded),
            "counts": self._nest({k: float(n) for k, n in counts.items()},
                                 as_int=True),
            "cum": {"capacity_s": self.capacity_s, "ticks": self.ticks,
                    "seconds": self._nest(self.totals)},
        }
        self._emit(counts, elapsed)
        if self.billing is not None:
            record = self.billing.settle(record, lane_tokens=lane_tokens)
        self.last = record
        return record

    def observe_degraded(self) -> Dict[str, Any]:
        """The fail-static tick: the frozen view still *is* capacity.
        Attribute every last-known node as ``degraded-frozen`` — never
        ``idle`` — off the node list remembered from the last healthy
        tick."""
        if not self._resumed:
            self._resume()   # before reading _last_nodes, not after
        signals = [NodeSignals(node=n) for n in self._last_nodes]
        return self.observe(signals, degraded=True)

    # ----------------------------------------------------- waste windows

    def _track_waste(self, counts: Dict[Tuple[str, str], int],
                     now: float, elapsed: float) -> None:
        seen: Dict[str, float] = {}
        for (kind, _lane), n in counts.items():
            if kind in WASTE_KINDS and n > 0:
                seen[kind] = seen.get(kind, 0.0) + n * elapsed
        for kind, node_s in seen.items():
            bucket = self._open_waste.get(kind)
            if bucket is None:
                bucket = {"waste": kind, "start": now - elapsed,
                          "end": now, "node_s": 0.0}
                self._open_waste[kind] = bucket
            bucket["end"] = now
            bucket["node_s"] += node_s
        for kind in list(self._open_waste):
            if kind not in seen:
                self._closed_waste.append(self._open_waste.pop(kind))
        # bounded: keep only the worst closed windows
        self._closed_waste.sort(key=lambda b: (-b["node_s"], b["start"]))
        del self._closed_waste[self._max_waste:]

    def waste_buckets(self, top: int = 5) -> List[Dict[str, Any]]:
        """Worst waste windows (open ones included), largest first."""
        buckets = self._closed_waste + list(self._open_waste.values())
        buckets.sort(key=lambda b: (-b["node_s"], b["start"]))
        return [dict(b) for b in buckets[:max(0, int(top))]]

    # ----------------------------------------------------------- metrics

    def _emit(self, counts: Dict[Tuple[str, str], int],
              elapsed: float) -> None:
        if self._metrics is None:
            return
        for (kind, lane), n in counts.items():
            if n and elapsed > 0:
                self._metrics.inc("usage_seconds_total", by=n * elapsed,
                                  labels={"kind": kind, "lane": lane})
        self._metrics.set_gauge("usage_capacity_nodes",
                                float(len(self._last_nodes)))
        self._metrics.set_gauge("usage_efficiency", self.efficiency())
        if self.billing is not None:
            self._metrics.set_gauge("usage_fleet_goodput_fraction",
                                    self.billing.fleet_goodput_fraction())

    # ---------------------------------------------------------- payloads

    def efficiency(self) -> float:
        """Cumulative productive fraction: seconds attributed to
        :data:`PRODUCTIVE_KINDS` over capacity seconds."""
        if self.capacity_s <= 0:
            return 1.0
        productive = sum(s for (kind, _lane), s in self.totals.items()
                         if kind in PRODUCTIVE_KINDS)
        return productive / self.capacity_s

    def kind_seconds(self) -> Dict[str, float]:
        """Cumulative seconds per kind, lanes folded together."""
        out = {kind: 0.0 for kind in USAGE_KINDS}
        for (kind, _lane), s in self.totals.items():
            out[kind] = out.get(kind, 0.0) + s
        return out

    def lane_seconds(self) -> Dict[str, float]:
        """Cumulative serving seconds per lane."""
        out: Dict[str, float] = {}
        for (kind, lane), s in self.totals.items():
            if kind == "serving":
                out[lane] = out.get(lane, 0.0) + s
        return out

    def payload(self, waste_top: int = 5) -> Dict[str, Any]:
        """The ``/usage`` data envelope body."""
        out = {
            "ticks": self.ticks,
            "capacity_s": self.capacity_s,
            "efficiency": self.efficiency(),
            "kinds": self.kind_seconds(),
            "lanes": self.lane_seconds(),
            "waste": self.waste_buckets(top=waste_top),
            "last": self.last,
        }
        if self.billing is not None:
            out["billing"] = self.billing.summary()
        return out

    # ------------------------------------------------------------ intern

    @staticmethod
    def _nest(flat: Dict[Tuple[str, str], float],
              as_int: bool = False) -> Dict[str, Dict[str, Any]]:
        """``{(kind, lane): v}`` -> ``{kind: {lane: v}}`` for the JSONL
        record (sorted on dump; byte-identical across replays)."""
        out: Dict[str, Dict[str, Any]] = {}
        for (kind, lane), v in flat.items():
            out.setdefault(kind, {})[lane] = int(v) if as_int else v
        return out
