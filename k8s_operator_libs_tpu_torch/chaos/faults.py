"""Fault catalog for the seeded chaos harness.

:data:`FAULT_TYPES` is the CLOSED enum of everything the injector knows
how to break. Closed matters: the scenario-spec parsers
(:mod:`.scenario`) and the invariant coverage map (:mod:`.invariants`)
are keyed by these strings, and a test holds both closed over this
tuple in both directions — a fault the parsers can't parse, or one no
invariant claims to stress, fails the tests before it fails a campaign.

The catalog:

``apiserver-latency``  every client call pays a seeded-random delay
``apiserver-flake``    client calls fail with transient 5xx at a rate
``conflict-storm``     write calls fail with 409 conflicts at a rate
``watch-lag``          the informer cache's staleness window widens
``driver-crashloop``   driver pods on target slices go not-ready with
                       restart counts past the failure threshold
``node-notready``      target nodes' Ready condition flips False
``leader-loss``        the current leader's lease traffic is partitioned
                       past its renew deadline (standby takes over)
``eviction-storm``     workload pods on target nodes return 429 to the
                       next N eviction attempts (a PDB storm)
``spot-reclaim``       target nodes get a reclaim taint + deadline
                       annotation (the spot/preemption notice contract
                       the elastic trainer consumes; a reclaimed SERVING
                       slice additionally drains through the router)
``replica-kill``       serving replica processes on target nodes crash
                       (in-flight requests lost at the replica; the
                       router must re-place them without loss or
                       double-serve)
``metrics-flake``      the serving replicas' /metrics endpoints on
                       target nodes stop answering (the router routes on
                       stale backpressure signals; admission legality
                       must hold anyway)
``mid-stream-kill``    serving replicas on target nodes are killed the
                       moment they hold STREAMING requests mid-
                       generation (the in-flight streams must resume on
                       peers from the last acked sequence number —
                       gapless, duplicate-free, never lost)
``kv-transfer-flake``  live-migration KV payload transfers touching
                       target nodes fail at a seeded rate (the router's
                       bounded retry/backoff must absorb the flake or
                       fall back to degraded re-prefill — never a lost
                       or corrupted stream)
``apiserver-blackout`` EVERY client call fails with 5xx for the window —
                       a sustained full apiserver outage (etcd quorum
                       loss, rolling control-plane upgrade gone bad).
                       The operator's resilient client boundary must
                       open its circuit breaker and enter fail-static
                       DEGRADED mode: no new cordons/drains/repairs/
                       trades, no quarantines off stale data, the
                       serving tier untouched; on heal, informers
                       resync and the state machine resumes from the
                       durable labels. Lease traffic and create_event
                       are exempt, like the flake fault: leader-loss
                       composes the lease partition separately (the
                       campaign must not re-implement renew-deadline
                       handling), and events are advisory-but-counted
                       by the event-dedup invariant
``operator-crash``     the current leader operator process (or a
                       targeted identity) is killed instantly and
                       reboots as a FRESH process against the surviving
                       cluster state — all in-memory state lost, only
                       the durable labels/annotations/leases remain
                       (the scheduled-fault twin of the crash-restart
                       explorer's write-boundary kills, chaos/crash)
``flash-crowd``        a seeded open-loop arrival-rate spike against the
                       ServingTier (requests/tick across all QoS lanes
                       for the window) — overload must degrade by
                       policy: best-effort lanes shed first, interactive
                       queue wait stays bounded, and sustained pressure
                       may drive the capacity arbiter to preempt a
                       training slice (the market-conservation
                       invariant holds through the trade)

A copy of the JAX package's ``chaos/faults.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from ..wire import RECLAIM_DEADLINE_ANNOTATION, RECLAIM_TAINT_KEY

# the closed fault-type enum — scenario parsers and the invariant
# coverage map are closed over this tuple in both directions
FAULT_TYPES = (
    "apiserver-latency",
    "apiserver-flake",
    "conflict-storm",
    "watch-lag",
    "driver-crashloop",
    "node-notready",
    "leader-loss",
    "eviction-storm",
    "spot-reclaim",
    "replica-kill",
    "metrics-flake",
    "mid-stream-kill",
    "kv-transfer-flake",
    "flash-crowd",
    "apiserver-blackout",
    "operator-crash",
)

# Spot/preemption reclaim notice wire contract: the cloud (or the chaos
# injector playing it) taints the node and stamps the absolute deadline
# (wall seconds) after which the chips disappear. The workload side
# (train/harness.py elastic mode, the campaign's simulated job) watches
# for the taint and must be checkpointed before the deadline. The KEYS
# live in the wire registry (the port's wire.py); re-exported here
# because they are part of this package's fault contract surface.
RECLAIM_TAINT_EFFECT = "NoSchedule"

__all__ = ["FAULT_TYPES", "FaultEvent", "RECLAIM_DEADLINE_ANNOTATION",
           "RECLAIM_TAINT_EFFECT", "RECLAIM_TAINT_KEY", "fault_entities"]

# fault types that hit the whole control/data plane rather than listed
# nodes — mapped to the fleet-global timeline entities the attribution
# scorer matches against (obs/causes.py ALWAYS_SCOPES)
_GLOBAL_FAULT_ENTITIES = {
    "apiserver-latency": ("apiserver/cluster",),
    "apiserver-flake": ("apiserver/cluster",),
    "conflict-storm": ("apiserver/cluster",),
    "watch-lag": ("apiserver/cluster",),
    "apiserver-blackout": ("apiserver/cluster",),
    "leader-loss": ("operator/leader",),
    "operator-crash": ("operator/leader",),
    "flash-crowd": ("lane/fleet",),
}


def fault_entities(ev: "FaultEvent") -> List[str]:
    """The timeline entities an injected fault acts on — the GROUND
    TRUTH side of the attribution score (chaos/campaign.py): a page
    whose burn window overlaps ``ev`` must rank an event on one of
    these entities (or a descendant) in its top causes."""
    if ev.targets:
        return [f"node/{t}" for t in ev.targets]
    return list(_GLOBAL_FAULT_ENTITIES.get(ev.type, ("operator/self",)))


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault: ``type`` (a :data:`FAULT_TYPES` member) goes
    active at ``at`` (modelled seconds from campaign start) for
    ``duration`` seconds against ``targets`` (node names; empty = the
    parser's default targeting), with type-specific ``params``."""

    type: str
    at: float
    duration: float = 0.0
    targets: List[str] = dataclasses.field(default_factory=list)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def until(self) -> float:
        return self.at + self.duration

    def describe(self) -> str:
        tgt = ",".join(self.targets) if self.targets else "-"
        return (f"{self.type} at={self.at:.0f}s dur={self.duration:.0f}s "
                f"targets={tgt} {self.params or ''}".rstrip())
