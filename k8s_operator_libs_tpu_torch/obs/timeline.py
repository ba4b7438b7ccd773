"""The fleet black box: one fixed-memory, ordered store of events.

A copy of the JAX package's ``obs/timeline.py``, with the same closed
event catalog and payload, so a status view reads either package's
``/causes`` alike. One :class:`FleetEvent` per state transition, fleet
wide, in order; the router binary records its drain, shed, migration
and requeue edges here through the request recorder
(``obs/reqtrace.py``) and the capacity arbiter its trades
(``market/arbiter.py``).

Beside the events the timeline keeps a small entity graph (node in
slice, request in lane, trade of slice) that the root-cause engine
(``obs/causes.py``) walks backwards from an alert.

Memory and threading: a bounded ring of events (``capacity``, oldest
evicted first, counted in ``dropped``), a per-entity index pruned on
eviction, and no lock: every producer already holds its own (the
request recorder records under its lock), so the store has one writer
at a time. The injected clock stamps wall time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..utils.clock import Clock, RealClock

# The closed event-kind catalog; CAUSE_PRIORS (obs/causes.py) is a
# subset of it.
EVENT_KINDS = (
    "journey-transition",   # node upgrade state machine edge
    "health-verdict",       # fleet-health verdict change on a node
    "alert-pending",        # SLO alert entered pending
    "alert-firing",         # SLO alert entered firing
    "alert-resolved",       # SLO alert resolved
    "market-trade",         # capacity-market arbiter decision phase
    "router-drain",         # serving replica drain edge
    "router-shed",          # request shed at admission
    "router-migration",     # live request splice to a new replica
    "router-requeue",       # crash-requeue of an assigned request
    "breaker-open",         # apiserver circuit breaker opened
    "breaker-close",        # apiserver circuit breaker closed
    "degraded-enter",       # operator entered fail-static DEGRADED mode
    "degraded-exit",        # operator exited DEGRADED mode
    "chaos-fault",          # injected fault window (campaigns only)
)

# Ring sizing: 4096 events ≈ hours of busy-fleet history at chaos-
# campaign event rates while staying a few hundred KB; same order as
# reqtrace's DEFAULT_TRACE_RING.
DEFAULT_TIMELINE_RING = 4096
# Entity-graph bound: parent links beyond this are dropped (counted) —
# a runaway producer cannot grow the graph without bound.
DEFAULT_LINK_CAP = 32768
# events included verbatim in payload() — the full ring stays queryable
# through events_overlapping/events_for; the payload is a tail preview.
PAYLOAD_TAIL = 256


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One black-box record: ``kind`` ∈ EVENT_KINDS happened to
    ``entity`` at ``t`` (optionally spanning until ``until``), with a
    human-readable ``detail`` as the evidence pointer."""

    seq: int
    kind: str
    entity: str        # "node/gke-tpu-7", "slice/slice-3", "request/r1"…
    t: float
    until: Optional[float] = None   # window end for spanning events
    detail: str = ""

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "kind": self.kind, "entity": self.entity,
             "t": self.t, "detail": self.detail}
        if self.until is not None:
            d["until"] = self.until
        return d


class FleetTimeline:
    """Bounded, clock-injected unified event store + entity graph."""

    def __init__(self, clock: Optional[Clock] = None,
                 capacity: int = DEFAULT_TIMELINE_RING,
                 link_cap: int = DEFAULT_LINK_CAP):
        self._clock = clock or RealClock()
        self.capacity = max(1, int(capacity))
        self.link_cap = max(1, int(link_cap))
        self._events: List[FleetEvent] = []
        self._by_entity: Dict[str, List[int]] = {}   # entity -> ring seqs
        self._parents: Dict[str, str] = {}           # child -> parent
        self._seq = 0
        self.dropped = 0          # events evicted from the ring
        self.dropped_links = 0    # parent links refused at link_cap

    # ------------------------------------------------------------ write

    def record_event(self, *, kind: str, entity: str, detail: str = "",
                     t: Optional[float] = None,
                     until: Optional[float] = None) -> FleetEvent:
        """Append one event. ``kind`` must be in the closed catalog: an
        unknown kind is a programming error and raises."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown timeline event kind {kind!r} "
                             f"(closed catalog: obs/timeline.py "
                             f"EVENT_KINDS)")
        ev = FleetEvent(seq=self._seq, kind=kind, entity=entity,
                        t=self._clock.wall() if t is None else float(t),
                        until=None if until is None else float(until),
                        detail=detail)
        self._seq += 1
        self._events.append(ev)
        self._by_entity.setdefault(entity, []).append(ev.seq)
        if len(self._events) > self.capacity:
            old = self._events.pop(0)
            self.dropped += 1
            seqs = self._by_entity.get(old.entity)
            if seqs:
                # eviction is strictly FIFO, so the evicted seq is the
                # entity's oldest — front-pop keeps the index O(1)
                if seqs[0] == old.seq:
                    seqs.pop(0)
                else:  # pragma: no cover — defensive; FIFO should hold
                    with_removed = [s for s in seqs if s != old.seq]
                    self._by_entity[old.entity] = with_removed
                    seqs = with_removed
                if not seqs:
                    self._by_entity.pop(old.entity, None)
        return ev

    def link(self, child: str, parent: str) -> None:
        """Record ``child`` ∈/→ ``parent`` in the entity graph (e.g.
        ``node/n1`` → ``slice/s0``).  Last write wins (a request that
        migrates re-links to its new replica); the map is bounded by
        ``link_cap``."""
        if child == parent:
            return
        if child not in self._parents and \
                len(self._parents) >= self.link_cap:
            self.dropped_links += 1
            return
        self._parents[child] = parent

    # ------------------------------------------------------------- read

    def parent(self, entity: str) -> Optional[str]:
        return self._parents.get(entity)

    def ancestors(self, entity: str, max_depth: int = 8) -> List[str]:
        """The parent chain of ``entity`` (nearest first), cycle- and
        depth-guarded."""
        chain: List[str] = []
        seen = {entity}
        cur = self._parents.get(entity)
        while cur is not None and cur not in seen and \
                len(chain) < max_depth:
            chain.append(cur)
            seen.add(cur)
            cur = self._parents.get(cur)
        return chain

    def events(self) -> Tuple[FleetEvent, ...]:
        return tuple(self._events)

    def events_for(self, entity: str) -> List[FleetEvent]:
        """All ring events on exactly ``entity`` (oldest first), via the
        per-entity index."""
        seqs = self._by_entity.get(entity)
        if not seqs:
            return []
        base = self._events[0].seq if self._events else 0
        return [self._events[s - base] for s in seqs]

    def events_overlapping(self, since: float,
                           until: float) -> List[FleetEvent]:
        """Events whose [t, until-or-t] window intersects
        [since, until], oldest first."""
        out = []
        for ev in self._events:
            end = ev.t if ev.until is None else ev.until
            if end >= since and ev.t <= until:
                out.append(ev)
        return out

    # ---------------------------------------------------------- surface

    def counts_by_kind(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for ev in self._events:
            counts[ev.kind] = counts.get(ev.kind, 0) + 1
        return {k: counts[k] for k in sorted(counts)}

    def payload(self) -> dict:
        """JSON-ready snapshot for the ``/causes`` envelope and status
        surfaces: ring accounting, per-kind counts, and the newest
        PAYLOAD_TAIL events verbatim."""
        return {
            "capacity": self.capacity,
            "recorded": self._seq,
            "retained": len(self._events),
            "dropped": self.dropped,
            "entities": len(self._by_entity),
            "links": len(self._parents),
            "dropped_links": self.dropped_links,
            "counts": self.counts_by_kind(),
            "events": [ev.to_dict()
                       for ev in self._events[-PAYLOAD_TAIL:]],
        }


__all__ = ["EVENT_KINDS", "FleetEvent", "FleetTimeline",
           "DEFAULT_TIMELINE_RING", "DEFAULT_LINK_CAP", "PAYLOAD_TAIL"]
