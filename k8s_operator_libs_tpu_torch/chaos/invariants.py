"""Standing invariants, evaluated continuously over a chaos run.

Each :class:`Invariant` is checked EVERY campaign tick — not just at the
end — so a violation is reported at the tick it first holds, with the
fault trace up to that point (the replayable evidence). The checkers are
deliberately stateful: journey continuity and alert-transition legality
are properties of *sequences* of observations, not snapshots.

The catalog (:data:`INVARIANT_NAMES`):

``budget``            the operator never takes more than the
                      maxUnavailable budget out of service itself:
                      cordoned nodes plus admitted-but-not-yet-cordoned
                      nodes (state label ``cordon-required`` — the same
                      lookahead GetUpgradesAvailable and the health
                      remediator charge) never exceed the budget.
                      Fault-injected NotReady nodes consume budget
                      headroom but are not the operator's doing.
``single-leader``     at most one election candidate believes it is the
                      leader at any tick.
``journey``           per-node journey annotations are monotone
                      (timestamps never regress), deduplicated (no
                      consecutive repeats), move only along legal
                      pipeline edges, and are CONTINUOUS across leader
                      failover — each tick's journey extends the last
                      tick's (trimming allowed only at the entry cap).
``event-dedup``       exactly one Event per dedup key: StuckNode events
                      never exceed the journey's entries into the stuck
                      state; SLOAlertFiring/Resolved events match the
                      observed state-machine transitions one-to-one.
``alert-transitions`` the alert state machine never skips an edge
                      (inactive→firing without pending, etc.).
``attribution``       every unavailability window the workload ledger
                      observes splits into phases that SUM to the
                      window; journey-derived window segments partition
                      their window exactly.
``router-exactly-once``  every request submitted to the serving router
                      is always in exactly one of queued / assigned /
                      completed / shed and is DELIVERED at most once —
                      across drain handoffs, replica kills, and
                      reroutes; a shed request is terminal (never also
                      delivered, never from the interactive lane).
``router-admission``  the router never places a request on a replica
                      whose node is cordoned, quarantined, or
                      reclaim-tainted (checked against cluster truth at
                      the tick the placement was made).
``router-stream-integrity``  per-request token sequence numbers are
                      gapless and duplicate-free across live KV
                      migrations, fallback re-prefills, and failovers —
                      every completed streamed request's spliced stream
                      equals its delivered result, and no replayed
                      token ever differed from what the client already
                      saw.
``request-trace-integrity``  every request timeline the flight
                      recorder closed is a legal walk of
                      ``LEGAL_STAGE_TRANSITIONS`` (obs/reqtrace.py):
                      starts at ``admitted``, gapless stage seqs,
                      monotone timestamps, exactly one terminal stage
                      per rid (the last), stage durations partitioning
                      the measured latency; open timelines carry no
                      terminal; and migration stages appear iff the
                      router's own ledger counted a migration (splice
                      transitions == migration successes, fallback
                      transitions == migration fallbacks).
``usage-conservation``  every tick record the fleet ledger appends
                      attributes EVERY node to exactly one usage kind:
                      per record Σ counts == nodes (integers — no float
                      drift), capacity seconds == nodes × elapsed, every
                      claimed kind is in the closed ``USAGE_KINDS``
                      catalog, DEGRADED ticks attribute the whole fleet
                      as ``degraded-frozen`` (never ``idle`` — a frozen
                      fleet is not an idle fleet), and cumulative
                      capacity never regresses across leader failover
                      (the ledger-tail resume carried the totals over).
``market-conservation``  every slice the capacity arbiter manages is
                      owned by exactly one of training / serving /
                      draining / quarantined each tick, owner labels on
                      a slice's members never disagree once stamped, no
                      node is claimed by two managed slices, and a
                      trade is never initiated that would push cordoned
                      + cordon-required nodes past the maxUnavailable
                      budget (the cordon-required lookahead included).

:data:`FAULT_COVERAGE` maps every fault type to the invariants it
stresses — closed over ``FAULT_TYPES`` in both directions and over
:data:`INVARIANT_NAMES`.

A copy of the JAX package's ``chaos/invariants.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.attribution import attribute_downtime, windows_from_journey
from ..obs.goodput import read_ledger
from ..obs.journey import (MAX_JOURNEY_ENTRIES, parse_journey,
                           parse_journey_full)
from ..upgrade.consts import UpgradeState

INVARIANT_NAMES = (
    "budget",
    "single-leader",
    "journey",
    "event-dedup",
    "alert-transitions",
    "attribution",
    "router-exactly-once",
    "router-admission",
    "market-conservation",
    "router-stream-integrity",
    "request-trace-integrity",
    "usage-conservation",
)

# fault type -> invariants that fault is designed to stress: the keys
# equal FAULT_TYPES and every value is a known invariant (and no
# invariant is orphaned — unstressed checkers rot)
FAULT_COVERAGE: Dict[str, Tuple[str, ...]] = {
    "apiserver-latency": ("budget", "journey", "single-leader"),
    "apiserver-flake": ("budget", "journey", "event-dedup",
                        "router-admission"),
    "conflict-storm": ("budget", "journey"),
    "watch-lag": ("budget", "journey"),
    "driver-crashloop": ("budget", "journey", "event-dedup",
                         "alert-transitions"),
    "node-notready": ("budget", "alert-transitions"),
    "leader-loss": ("single-leader", "journey", "event-dedup"),
    "eviction-storm": ("budget", "journey", "attribution"),
    "spot-reclaim": ("attribution", "event-dedup",
                     "router-exactly-once", "router-admission",
                     "usage-conservation"),
    "replica-kill": ("router-exactly-once", "router-stream-integrity",
                     "request-trace-integrity"),
    "metrics-flake": ("router-admission", "router-exactly-once"),
    "mid-stream-kill": ("router-exactly-once",
                        "router-stream-integrity",
                        "request-trace-integrity"),
    "kv-transfer-flake": ("router-stream-integrity",
                          "router-exactly-once",
                          "request-trace-integrity"),
    "flash-crowd": ("market-conservation", "router-exactly-once",
                    "router-admission", "usage-conservation"),
    # fail-static: during the blackout the operator must take NOTHING
    # new out of service (budget), never corrupt a journey off stale
    # state, keep the serving tier whole, keep event delivery exact —
    # and bill the frozen fleet as degraded-frozen, never idle
    "apiserver-blackout": ("budget", "journey", "event-dedup",
                           "router-exactly-once", "usage-conservation"),
    # crash-restart: a fresh process resuming from durable labels alone
    # must keep journeys continuous, never double-lead, never re-take
    # budget it cannot remember holding — and resume the usage ledger
    # from its tail so no capacity second is dropped or double-counted
    "operator-crash": ("journey", "single-leader", "budget",
                       "usage-conservation"),
}

# Legal pipeline edges (upgrade_state.py processing order + the failure
# and auto-recovery transitions the managers write). The journey checker
# flags anything else — a skipped phase means a write bypassed the
# machine. Pod deletion that succeeds (or finds no pod to delete) goes
# straight to pod-restart-required (upgrade/pod_manager.py), drain only
# after it failed: the JAX package's table lacks that edge, which its
# campaigns never take (they run without pod deletion).
LEGAL_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    UpgradeState.UNKNOWN: (UpgradeState.UPGRADE_REQUIRED, UpgradeState.DONE),
    UpgradeState.UPGRADE_REQUIRED: (UpgradeState.CORDON_REQUIRED,),
    UpgradeState.CORDON_REQUIRED: (UpgradeState.WAIT_FOR_JOBS_REQUIRED,),
    UpgradeState.WAIT_FOR_JOBS_REQUIRED: (
        UpgradeState.POD_DELETION_REQUIRED, UpgradeState.DRAIN_REQUIRED),
    UpgradeState.POD_DELETION_REQUIRED: (
        UpgradeState.POD_RESTART_REQUIRED, UpgradeState.DRAIN_REQUIRED,
        UpgradeState.FAILED),
    UpgradeState.DRAIN_REQUIRED: (
        UpgradeState.POD_RESTART_REQUIRED, UpgradeState.FAILED),
    UpgradeState.POD_RESTART_REQUIRED: (
        UpgradeState.VALIDATION_REQUIRED, UpgradeState.UNCORDON_REQUIRED,
        UpgradeState.DONE, UpgradeState.FAILED),
    UpgradeState.VALIDATION_REQUIRED: (
        UpgradeState.UNCORDON_REQUIRED, UpgradeState.DONE,
        UpgradeState.FAILED),
    UpgradeState.UNCORDON_REQUIRED: (UpgradeState.DONE,),
    UpgradeState.FAILED: (
        UpgradeState.UNCORDON_REQUIRED, UpgradeState.DONE),
    UpgradeState.DONE: (UpgradeState.UPGRADE_REQUIRED,),
}

_ALERT_EDGES = {
    "inactive": ("inactive", "pending"),
    "pending": ("pending", "firing", "inactive"),
    "firing": ("firing", "resolved"),
    "resolved": ("resolved", "pending"),
}

_STUCK_MSG_RE = re.compile(
    r"Node (\S+) stuck in (\S+) .*component (\S+)\)")


@dataclasses.dataclass
class Violation:
    invariant: str
    tick: int
    t: float
    detail: str

    def __str__(self) -> str:
        return (f"[{self.invariant}] tick={self.tick} t={self.t:.1f}s: "
                f"{self.detail}")


@dataclasses.dataclass
class CampaignView:
    """What the checkers see each tick — assembled by the campaign."""

    tick: int
    t: float                                  # modelled seconds from start
    nodes: Dict[str, object]                  # name -> Node (direct reads)
    keys: object                              # the component's KeyFactory
    budget: int                               # scaled maxUnavailable
    fault_notready: set                       # injector-flipped nodes
    leaders: List[str]                        # identities claiming lease
    recorder_events: Sequence[object]         # cluster.recorder.events
    alert_status: Dict[str, List[dict]]       # op identity -> status()
    ledger_path: Optional[str] = None         # simulated workload ledger
    workload_node: Optional[str] = None
    tick_seconds: float = 15.0
    # the serving RequestRouter under test (None when the scenario runs
    # no serving tier); the router invariants read its bookkeeping —
    # requests, completed_counts, assignments_this_tick
    router: Optional[object] = None
    # the CURRENT leader's CapacityArbiter (None when no market runs or
    # no candidate holds the lease this tick); the market-conservation
    # invariant reads its ownership ledger
    market: Optional[object] = None
    # the router's RequestTraceRecorder (None when the scenario runs no
    # serving tier or tracing is off); the request-trace-integrity
    # invariant replays its closed + open timelines
    reqtrace: Optional[object] = None
    # the shared fleet usage ledger (workdir/usage.jsonl — every
    # candidate appends to the same path, like the goodput ledger); the
    # usage-conservation invariant replays each new tick record
    usage_ledger_path: Optional[str] = None


class Invariant:
    name = "invariant"

    def check(self, view: CampaignView) -> List[Violation]:
        raise NotImplementedError

    def _v(self, view: CampaignView, detail: str) -> Violation:
        return Violation(self.name, view.tick, view.t, detail)


class BudgetInvariant(Invariant):
    name = "budget"

    def __init__(self):
        # nodes the operator cordoned/admitted WHILE the injector held
        # them NotReady: the machine's already-unavailable admission
        # bypass (reference GetUpgradesAvailable semantics — cordoning a
        # dead node consumes no NEW availability) makes that legal and
        # free, so the invariant must not charge it, during the fault
        # window or after it heals mid-pipeline. The exemption ends when
        # the node returns to service (schedulable again).
        self._free_admissions: set = set()

    def check(self, view: CampaignView) -> List[Violation]:
        taken = []
        for name, node in view.nodes.items():
            state = node.metadata.labels.get(view.keys.state_label, "")
            held = (node.spec.unschedulable
                    or state == UpgradeState.CORDON_REQUIRED)
            if not held:
                self._free_admissions.discard(name)
                continue
            if name in view.fault_notready:
                self._free_admissions.add(name)
            if name in self._free_admissions:
                continue  # fault-injected NotReady consumed this node's
                # availability first — not the operator's doing
            taken.append(name)
        if len(taken) > view.budget:
            return [self._v(view,
                            f"operator holds {len(taken)} nodes out of "
                            f"service ({sorted(taken)}) > maxUnavailable "
                            f"budget {view.budget}")]
        return []


class SingleLeaderInvariant(Invariant):
    name = "single-leader"

    def check(self, view: CampaignView) -> List[Violation]:
        if len(view.leaders) > 1:
            return [self._v(view, f"dual leadership: {view.leaders}")]
        return []


class JourneyInvariant(Invariant):
    name = "journey"

    def __init__(self):
        self._prev: Dict[str, List[Tuple[str, float]]] = {}
        self._prev_truncated: Dict[str, int] = {}

    def check(self, view: CampaignView) -> List[Violation]:
        out: List[Violation] = []
        for name, node in view.nodes.items():
            entries, truncated = parse_journey_full(
                node.metadata.annotations.get(view.keys.journey_annotation))
            if truncated < self._prev_truncated.get(name, 0):
                out.append(self._v(
                    view, f"{name}: journey truncation marker regressed "
                    f"{self._prev_truncated[name]} -> {truncated}"))
            for (s1, t1), (s2, t2) in zip(entries, entries[1:]):
                if t2 < t1:
                    out.append(self._v(
                        view, f"{name}: journey time regressed "
                        f"{s1}@{t1} -> {s2}@{t2}"))
                if s1 == s2:
                    out.append(self._v(
                        view, f"{name}: journey repeats state {s2} "
                        f"consecutively (idempotent rewrite leaked)"))
                legal = LEGAL_TRANSITIONS.get(s1)
                if legal is not None and s2 not in legal:
                    out.append(self._v(
                        view, f"{name}: illegal transition "
                        f"{s1 or 'unknown'} -> {s2} (legal: "
                        f"{', '.join(legal) or 'none'})"))
            prev = self._prev.get(name)
            newly_truncated = truncated > self._prev_truncated.get(name, 0)
            if prev is not None and not self._extends(
                    prev, entries, trimmed=newly_truncated):
                out.append(self._v(
                    view, f"{name}: journey not continuous — previous "
                    f"{prev[-3:]} is no prefix of current "
                    f"{entries[-3:]} (reset across failover?)"))
            self._prev[name] = entries
            self._prev_truncated[name] = truncated
        return out

    @staticmethod
    def _extends(prev: List[Tuple[str, float]],
                 cur: List[Tuple[str, float]],
                 trimmed: bool = False) -> bool:
        if cur[:len(prev)] == prev:
            return True
        # trimming the oldest entries is legal only when the size guard
        # says it happened: the durable `truncated` marker grew, or the
        # journey sits at the entry cap (pre-marker journeys)
        if trimmed or len(cur) >= MAX_JOURNEY_ENTRIES:
            # some NON-EMPTY tail of prev must prefix cur — a trim drops
            # the head, it never severs all overlap between ticks
            for drop in range(1, len(prev)):
                tail = prev[drop:]
                if cur[:len(tail)] == tail:
                    return True
        return False


class AlertTransitionInvariant(Invariant):
    """Checks edge legality AND counts →firing / →resolved transitions
    (per alert-manager instance) for the event-dedup checker."""

    name = "alert-transitions"

    def __init__(self):
        self._prev: Dict[Tuple[str, str], str] = {}
        self.firing_transitions: Dict[str, int] = {}
        self.resolved_transitions: Dict[str, int] = {}

    def check(self, view: CampaignView) -> List[Violation]:
        out: List[Violation] = []
        for op_id, status in view.alert_status.items():
            for st in status:
                key = (op_id, st["rule"])
                prev = self._prev.get(key, "inactive")
                cur = st["state"]
                if cur not in _ALERT_EDGES.get(prev, ()):
                    out.append(self._v(
                        view, f"alert {st['rule']} ({op_id}) skipped a "
                        f"transition: {prev} -> {cur}"))
                if cur == "firing" and prev != "firing":
                    self.firing_transitions[st["rule"]] = \
                        self.firing_transitions.get(st["rule"], 0) + 1
                if cur == "resolved" and prev != "resolved":
                    self.resolved_transitions[st["rule"]] = \
                        self.resolved_transitions.get(st["rule"], 0) + 1
                self._prev[key] = cur
        return out


class EventDedupInvariant(Invariant):
    name = "event-dedup"

    def __init__(self, alerts: Optional[AlertTransitionInvariant] = None):
        self._alerts = alerts

    def check(self, view: CampaignView) -> List[Violation]:
        out: List[Violation] = []
        stuck_counts: Dict[Tuple[str, str], int] = {}
        fire_counts: Dict[str, int] = {}
        resolve_counts: Dict[str, int] = {}
        for ev in view.recorder_events:
            if ev.reason == "StuckNode":
                m = _STUCK_MSG_RE.search(ev.message)
                if m:
                    key = (m.group(1), m.group(2))
                    stuck_counts[key] = stuck_counts.get(key, 0) + 1
            elif ev.reason == "SLOAlertFiring":
                fire_counts[ev.object_name] = \
                    fire_counts.get(ev.object_name, 0) + 1
            elif ev.reason == "SLOAlertResolved":
                resolve_counts[ev.object_name] = \
                    resolve_counts.get(ev.object_name, 0) + 1
        # one StuckNode event per (node, state ENTRY): events can never
        # outnumber the journey's entries into that state
        for (node_name, state), count in stuck_counts.items():
            node = view.nodes.get(node_name)
            if node is None:
                continue
            entries, truncated = parse_journey_full(
                node.metadata.annotations.get(
                    view.keys.journey_annotation))
            if truncated or len(entries) >= MAX_JOURNEY_ENTRIES:
                continue  # trimmed: entry count no longer evidentiary
            entered = sum(1 for s, _ in entries if s == state)
            if count > entered:
                out.append(self._v(
                    view, f"{count} StuckNode events for {node_name} in "
                    f"{state} but only {entered} journey entr"
                    f"{'y' if entered == 1 else 'ies'} — dedup broken"))
        # one Event per observed alert transition, exactly
        if self._alerts is not None:
            for rule, n in fire_counts.items():
                want = self._alerts.firing_transitions.get(rule, 0)
                if n != want:
                    out.append(self._v(
                        view, f"{n} SLOAlertFiring events for {rule} vs "
                        f"{want} observed pending->firing transitions"))
            for rule, n in resolve_counts.items():
                want = self._alerts.resolved_transitions.get(rule, 0)
                if n != want:
                    out.append(self._v(
                        view, f"{n} SLOAlertResolved events for {rule} "
                        f"vs {want} observed firing->resolved "
                        f"transitions"))
        return out


class AttributionInvariant(Invariant):
    name = "attribution"

    def check(self, view: CampaignView) -> List[Violation]:
        out: List[Violation] = []
        quantum = max(1.0, view.tick_seconds / 2.0)
        # journey-derived windows: the three segments partition exactly
        for name, node in view.nodes.items():
            entries = parse_journey(node.metadata.annotations.get(
                view.keys.journey_annotation))
            for w in windows_from_journey(entries):
                span = (w.end - w.start) if w.end is not None else None
                if span is not None and abs(w.window_s - span) > 1e-6:
                    out.append(self._v(
                        view, f"{name}: journey window segments sum to "
                        f"{w.window_s:.3f}s but the window spans "
                        f"{span:.3f}s"))
        # ledger windows: attributed phases sum to each window
        if view.ledger_path and view.workload_node:
            node = view.nodes.get(view.workload_node)
            if node is not None:
                try:
                    records = read_ledger(view.ledger_path)
                except FileNotFoundError:
                    return out
                entries = parse_journey(node.metadata.annotations.get(
                    view.keys.journey_annotation))
                for rep in attribute_downtime(records, entries):
                    total = sum(rep["phases"].values())
                    if abs(total - rep["total_s"]) > quantum:
                        out.append(self._v(
                            view, f"attributed phases sum to "
                            f"{total:.2f}s but the window is "
                            f"{rep['total_s']:.2f}s "
                            f"({rep['phases']})"))
        return out


class RouterExactlyOnceInvariant(Invariant):
    """No request the router accepted is ever lost or double-served:
    every rid is in exactly one of queued/assigned/completed, an
    assigned rid's replica is alive, and the delivery count per rid
    never exceeds one — across drain handoffs, kills, and reroutes."""

    name = "router-exactly-once"

    def check(self, view: CampaignView) -> List[Violation]:
        router = view.router
        if router is None:
            return []
        out: List[Violation] = []
        for rid, count in router.completed_counts.items():
            if count > 1:
                out.append(self._v(
                    view, f"request {rid} delivered {count} times "
                    f"(double-serve across handoff)"))
        live = {r.id for r in router.pool.replicas.values()
                if not r.failed}
        for rid, req in router.requests.items():
            if req.state not in ("queued", "assigned", "completed",
                                 "shed"):
                out.append(self._v(
                    view, f"request {rid} in unknown state "
                    f"{req.state!r} (lost)"))
            elif req.state == "assigned" and req.replica_id not in live:
                out.append(self._v(
                    view, f"request {rid} assigned to dead replica "
                    f"{req.replica_id} and never re-placed (lost)"))
            elif req.state == "shed":
                # shedding is a terminal, policy-scoped drop: only the
                # sheddable lanes may shed, and a shed request can never
                # also have been delivered
                if getattr(req, "lane", None) == "interactive":
                    out.append(self._v(
                        view, f"request {rid} on the protected "
                        f"interactive lane was shed"))
                if router.completed_counts.get(rid):
                    out.append(self._v(
                        view, f"request {rid} both shed and delivered"))
        return out


class RouterAdmissionInvariant(Invariant):
    """Admission legality against CLUSTER TRUTH: every placement the
    router made this tick targets a node that is schedulable,
    unquarantined, and not reclaim-tainted at check time (the campaign
    reconciles the operator and runs the pod-side drain watch BEFORE the
    router ticks, so a stale router view is no excuse)."""

    name = "router-admission"

    def check(self, view: CampaignView) -> List[Violation]:
        router = view.router
        if router is None:
            return []
        from ..wire import QUARANTINE_LABEL, RECLAIM_TAINT_KEY
        out: List[Violation] = []
        for rid, replica_id, node_name in router.assignments_this_tick:
            node = view.nodes.get(node_name)
            if node is None:
                continue
            if node.spec.unschedulable:
                out.append(self._v(
                    view, f"request {rid} admitted to CORDONED node "
                    f"{node_name} (replica {replica_id})"))
            elif QUARANTINE_LABEL in node.metadata.labels:
                out.append(self._v(
                    view, f"request {rid} admitted to QUARANTINED node "
                    f"{node_name} (replica {replica_id})"))
            elif any(t.key == RECLAIM_TAINT_KEY
                     for t in node.spec.taints):
                out.append(self._v(
                    view, f"request {rid} admitted to reclaim-tainted "
                    f"node {node_name} (replica {replica_id})"))
        return out


class MarketConservationInvariant(Invariant):
    """Capacity-market conservation over the arbiter's ownership ledger
    and the ``tpu.dev/market.owner`` labels in cluster truth:

    - every managed slice's owner is exactly one of
      training/serving/draining/quarantined;
    - no node belongs to two managed slices;
    - once a slice's durable stamp has landed (``stamp_pending`` False),
      its members' owner labels never disagree with each other and
      never carry an unknown value — a split label is a half-applied
      trade two readers would interpret differently;
    - at the tick a trade is INITIATED (a slice enters ``preempting``),
      the nodes it takes out of training plus the operator's held nodes
      (cordoned or admitted ``cordon-required``) fit the maxUnavailable
      budget — the market never overdraws capacity the upgrade pipeline
      already spoke for.

    Stateful: phase transitions are detected against the previous tick,
    so the budget clause prices initiation, not steady state (the
    operator may legitimately cordon more nodes after a trade began —
    the router then drains the lent replica through the normal path)."""

    name = "market-conservation"

    def __init__(self):
        self._prev_phase: Dict[str, str] = {}

    def check(self, view: CampaignView) -> List[Violation]:
        market = view.market
        if market is None:
            return []
        from ..market.arbiter import LEGAL_OWNERS
        from ..wire import MARKET_OWNER_LABEL
        out: List[Violation] = []
        claimed: Dict[str, str] = {}
        for entry in market.ownership():
            slice_id = entry["slice"]
            owner = entry["owner"]
            phase = entry.get("phase", owner)
            nodes = entry["nodes"]
            if owner not in LEGAL_OWNERS:
                out.append(self._v(
                    view, f"slice {slice_id} owned by unknown party "
                    f"{owner!r} (legal: {', '.join(LEGAL_OWNERS)})"))
            for name in nodes:
                if name in claimed:
                    out.append(self._v(
                        view, f"node {name} claimed by managed slices "
                        f"{claimed[name]} AND {slice_id}"))
                claimed[name] = slice_id
            labels = {}
            for name in nodes:
                node = view.nodes.get(name)
                if node is None:
                    continue
                value = node.metadata.labels.get(MARKET_OWNER_LABEL)
                if value:
                    labels[name] = value
                    if value not in LEGAL_OWNERS:
                        out.append(self._v(
                            view, f"node {name} carries unknown market "
                            f"owner label {value!r}"))
            if not entry.get("stamp_pending") and len(set(
                    labels.values())) > 1:
                out.append(self._v(
                    view, f"slice {slice_id} members disagree on the "
                    f"market owner label: {labels} (split trade)"))
            prev = self._prev_phase.get(slice_id)
            if phase == "preempting" and prev != "preempting":
                members = set(nodes)
                held = 0
                for name, node in view.nodes.items():
                    if name in members:
                        continue
                    state = node.metadata.labels.get(
                        view.keys.state_label, "")
                    if (node.spec.unschedulable
                            or state == UpgradeState.CORDON_REQUIRED):
                        held += 1
                if held + len(nodes) > view.budget:
                    out.append(self._v(
                        view, f"trade of slice {slice_id} initiated "
                        f"with {held} nodes already held by the "
                        f"operator + {len(nodes)} traded > "
                        f"maxUnavailable budget {view.budget}"))
            self._prev_phase[slice_id] = phase
        return out


class RouterStreamIntegrityInvariant(Invariant):
    """Per-request token sequence numbers are gapless and duplicate-free
    across live KV migrations, fallback re-prefills, and failovers. Three
    checks, all over the router's append-only stream bookkeeping:

    - the router recorded no splice-verification failure (a replayed
      token after a fallback differing from what the client already saw);
    - every request's stream_log sequence numbers are exactly
      0..len-1 in order (an out-of-order/duplicate append is a gap or a
      double-delivered token at the client);
    - a COMPLETED streamed request's spliced stream equals its delivered
      result's generated tail (the stream and the result are the same
      truth seen two ways).

    Stateful so each violation is reported once, at the tick it first
    appears."""

    name = "router-stream-integrity"

    def __init__(self):
        self._reported_violations = 0
        self._checked_done: set = set()

    def check(self, view: CampaignView) -> List[Violation]:
        router = view.router
        if router is None:
            return []
        out: List[Violation] = []
        fresh = router.stream_violations[self._reported_violations:]
        self._reported_violations = len(router.stream_violations)
        for msg in fresh:
            out.append(self._v(view, f"splice verification failed: "
                                     f"{msg}"))
        for rid, req in router.requests.items():
            if rid in self._checked_done:
                continue
            for i, (seq, replica_id) in enumerate(req.stream_log):
                if seq != i:
                    out.append(self._v(
                        view, f"request {rid}: stream seq {seq} at "
                        f"position {i} via {replica_id} (gap or "
                        f"duplicate token at the client)"))
                    break
            if req.state == "completed":
                self._checked_done.add(rid)
                if req.tokens is None:
                    continue
                tail = [int(t) for t in req.tokens[len(req.prompt):]]
                if req.stream and list(req.stream) != tail:
                    out.append(self._v(
                        view, f"request {rid}: spliced stream "
                        f"({len(req.stream)} tokens) diverged from its "
                        f"delivered result after {req.migrations} "
                        f"migration(s)"))
        return out


class RequestTraceIntegrityInvariant(Invariant):
    """Every timeline the request flight recorder holds is internally
    legal, and the recorder's migration accounting reconciles with the
    router's own ledger. Four checks:

    - every CLOSED timeline passes :func:`obs.reqtrace.validate_timeline`
      — starts at ``admitted``, gapless stage seqs, transitions legal
      per ``LEGAL_STAGE_TRANSITIONS``, monotone timestamps, exactly one
      terminal stage (the last), and stage durations that partition the
      measured latency (the attribution sums-to-the-window law);
    - every OPEN timeline passes the same walk minus the terminal
      requirement (and must not already contain a terminal stage);
    - cumulative splice transitions equal the router's counted
      migrations (migration stages present IFF a migration happened);
    - cumulative fallback transitions equal the router's counted
      migration fallbacks.

    Stateful so each defect is reported once, at the tick it first
    appears: closed timelines are checked once per rid, open timelines
    re-checked each tick but deduplicated per (rid, defect)."""

    name = "request-trace-integrity"

    def __init__(self):
        self._checked_closed: set = set()
        self._reported: set = set()

    def check(self, view: CampaignView) -> List[Violation]:
        recorder = view.reqtrace
        router = view.router
        if recorder is None or router is None:
            return []
        from ..obs.reqtrace import validate_timeline
        out: List[Violation] = []
        for timeline in recorder.timelines():
            rid = timeline.get("rid")
            if rid in self._checked_closed:
                continue
            self._checked_closed.add(rid)
            for msg in validate_timeline(timeline, closed=True):
                out.append(self._v(view, msg))
        for timeline in recorder.open_timelines():
            rid = timeline.get("rid")
            for msg in validate_timeline(timeline, closed=False):
                key = (rid, msg)
                if key in self._reported:
                    continue
                self._reported.add(key)
                out.append(self._v(view, msg))
        migrations = router.migration_successes
        if recorder.splices != migrations:
            key = ("splices", recorder.splices, migrations)
            if key not in self._reported:
                self._reported.add(key)
                out.append(self._v(
                    view, f"recorder saw {recorder.splices} splice "
                    f"transition(s) but the router counted {migrations} "
                    f"migration(s) — migration stages must appear iff a "
                    f"migration was counted"))
        fallbacks = router.migration_fallbacks
        if recorder.fallbacks != fallbacks:
            key = ("fallbacks", recorder.fallbacks, fallbacks)
            if key not in self._reported:
                self._reported.add(key)
                out.append(self._v(
                    view, f"recorder saw {recorder.fallbacks} fallback "
                    f"transition(s) but the router counted {fallbacks} "
                    f"migration fallback(s)"))
        return out


class UsageConservationInvariant(Invariant):
    """The fleet ledger's conservation law, replayed record by record:

    - Σ attributed node counts == the record's node count, EXACTLY
      (integer equality — attribution is a partition, so nothing is
      dropped and nothing is double-claimed);
    - capacity seconds == nodes × elapsed seconds (attribution happens
      in integer node counts; seconds are derived once, so the sum
      law survives in seconds too, with no float drift);
    - every claimed kind is in the closed ``USAGE_KINDS`` catalog;
    - a DEGRADED tick attributes the whole fleet as ``degraded-frozen``
      and claims zero ``idle`` — fail-static capacity is lost to the
      degradation, and billing it as idle would hide the outage cost;
    - cumulative capacity seconds never regress between consecutive
      records — a promoted standby must resume from the ledger tail,
      not restart the totals (failover continuity).

    Stateful: records already replayed are never re-checked, so each
    violation is reported once, at the tick its record appeared."""

    name = "usage-conservation"

    def __init__(self):
        self._seen = 0
        self._prev_cum_capacity = 0.0

    def check(self, view: CampaignView) -> List[Violation]:
        path = view.usage_ledger_path
        if not path:
            return []
        from ..obs.billing import UsageLedger
        from ..obs.usage import USAGE_KINDS
        try:
            records = UsageLedger(path).read()
        except FileNotFoundError:
            return []
        out: List[Violation] = []
        for rec in records[self._seen:]:
            if rec.get("kind") != "usage":
                continue
            tick = rec.get("tick")
            counts = rec.get("counts") or {}
            nodes = int(rec.get("nodes", 0))
            claimed = sum(int(n) for lanes in counts.values()
                          for n in lanes.values())
            if claimed != nodes:
                out.append(self._v(
                    view, f"usage record tick={tick} attributes "
                    f"{claimed} node(s) but the fleet had {nodes} — "
                    f"conservation broken ({counts})"))
            unknown = sorted(k for k in counts if k not in USAGE_KINDS)
            if unknown:
                out.append(self._v(
                    view, f"usage record tick={tick} claims unknown "
                    f"kind(s) {unknown} (catalog: "
                    f"{', '.join(USAGE_KINDS)})"))
            want_capacity = nodes * float(rec.get("elapsed_s", 0.0))
            if abs(float(rec.get("capacity_s", 0.0))
                   - want_capacity) > 1e-6:
                out.append(self._v(
                    view, f"usage record tick={tick} capacity "
                    f"{rec.get('capacity_s')}s != nodes × elapsed "
                    f"({want_capacity}s)"))
            if rec.get("degraded"):
                frozen = sum(int(n) for n in
                             (counts.get("degraded-frozen")
                              or {}).values())
                if frozen != nodes or any(
                        kind != "degraded-frozen" and any(
                            lanes.values())
                        for kind, lanes in counts.items()):
                    out.append(self._v(
                        view, f"DEGRADED usage record tick={tick} must "
                        f"attribute all {nodes} node(s) as "
                        f"degraded-frozen, got {counts} (a frozen "
                        f"fleet is never idle)"))
            cum_capacity = float(
                (rec.get("cum") or {}).get("capacity_s", 0.0))
            if cum_capacity + 1e-6 < self._prev_cum_capacity:
                out.append(self._v(
                    view, f"usage record tick={tick} cumulative "
                    f"capacity regressed {self._prev_cum_capacity}s -> "
                    f"{cum_capacity}s (ledger-tail resume lost across "
                    f"failover)"))
            self._prev_cum_capacity = max(self._prev_cum_capacity,
                                          cum_capacity)
        self._seen = len(records)
        return out


def default_invariants() -> List[Invariant]:
    alerts = AlertTransitionInvariant()
    return [
        BudgetInvariant(),
        SingleLeaderInvariant(),
        JourneyInvariant(),
        alerts,
        EventDedupInvariant(alerts),
        AttributionInvariant(),
        RouterExactlyOnceInvariant(),
        RouterAdmissionInvariant(),
        MarketConservationInvariant(),
        RouterStreamIntegrityInvariant(),
        RequestTraceIntegrityInvariant(),
        UsageConservationInvariant(),
    ]
