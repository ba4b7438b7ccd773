"""Seeded chaos injector: wraps the FakeCluster client boundary + clock.

Two halves:

- :class:`ChaosClient` wraps any :class:`~..core.client.Client`-shaped
  object (the fake cluster's cached client, its direct view, or another
  ChaosClient) and routes EVERY method call through the injector's
  :meth:`ChaosInjector.before_op` gate, where the active fault windows
  tax it with latency, transient 5xx (:class:`~..core.client.ServerError`),
  or 409 conflicts. The wrapper is transparent — the operator, the state
  machine, the health monitor, and the leader elector all run unmodified
  against it.

- :class:`ChaosInjector` owns the seeded RNG, the scheduled
  :class:`~.faults.FaultEvent` list, and the discrete cluster mutations
  (crashloops, NotReady flips, lease partitions, eviction blocks, reclaim
  taints). :meth:`~ChaosInjector.tick` applies every event whose ``at``
  has arrived and heals every event whose window closed, appending each
  action to :attr:`~ChaosInjector.trace` — the replayable tick trace a
  failing campaign run reports next to its seed.

Determinism: all randomness flows through one ``random.Random(seed)``;
the same seed + scenario replays the same fault schedule, latencies, and
flake decisions (the campaign's convergence loop is itself synchronous).

A copy of the JAX package's ``chaos/injector.py`` over the port's client
errors and clock; the port imports nothing of that package.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional, Set

from ..core.client import ConflictError, ServerError
from ..utils.clock import Clock
from .faults import (FAULT_TYPES, RECLAIM_DEADLINE_ANNOTATION,
                     RECLAIM_TAINT_EFFECT, RECLAIM_TAINT_KEY, FaultEvent,
                     fault_entities)

logger = logging.getLogger(__name__)

# lease traffic only fails under a targeted leader-loss partition (a
# generic flake would force the campaign to re-implement renew-deadline
# handling); Events are advisory and swallowed by every recorder, so
# flaking them would silently skew the event-dedup invariant's counts
_LEASE_OPS = {"get_lease", "create_lease", "update_lease"}
_FLAKE_EXEMPT = _LEASE_OPS | {"create_event", "direct"}
_WRITE_PREFIXES = ("patch_", "create_", "delete_", "evict_", "update_")


class ChaosClient:
    """Client wrapper routing every call through the injector's fault
    gate. ``identity`` names the caller for targeted partitions (each
    leader-election candidate gets its own wrapper).

    When the injector carries a ``write_gate`` (the crash-restart
    explorer's hook, chaos/crash), every WRITE that passed the fault
    gate is additionally bracketed by ``gate.before_write`` /
    ``gate.after_write`` with its full payload — the gate classifies the
    write against the durable-site registry and may kill the issuing
    operator immediately before or after the write lands."""

    def __init__(self, injector: "ChaosInjector", inner,
                 identity: str = ""):
        self._injector = injector
        self._inner = inner
        self.identity = identity

    def direct(self) -> "ChaosClient":
        return ChaosClient(self._injector, self._inner.direct(),
                           self.identity)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            self._injector.before_op(name, self.identity)
            gate = self._injector.write_gate
            if (gate is not None and name.startswith(_WRITE_PREFIXES)
                    and name not in _FLAKE_EXEMPT):
                gate.before_write(name, self.identity, args, kwargs)
                out = attr(*args, **kwargs)
                gate.after_write(name, self.identity, args, kwargs)
                return out
            return attr(*args, **kwargs)

        return call


class ChaosInjector:
    def __init__(self, cluster, clock: Clock, seed: int,
                 events: Optional[List[FaultEvent]] = None,
                 namespace: str = "kube-system",
                 driver_labels: Optional[Dict[str, str]] = None,
                 lease_duration_s: float = 45.0):
        for ev in events or []:
            if ev.type not in FAULT_TYPES:
                raise ValueError(f"unknown fault type {ev.type!r}")
        self.cluster = cluster
        self.clock = clock
        self.seed = seed
        self.rng = random.Random(seed)
        self.events = sorted(events or [], key=lambda e: e.at)
        self.namespace = namespace
        self.driver_labels = dict(driver_labels or {})
        self.lease_duration_s = lease_duration_s
        self.trace: List[str] = []
        self._applied: Set[int] = set()
        self._healed: Set[int] = set()
        # identity -> partition end (monotonic seconds)
        self._partitions: Dict[str, float] = {}
        self._base_cache_lag = cluster.cache_lag
        self._broken_pods: Dict[int, List[str]] = {}   # event idx -> pods
        self._t0 = clock.now()
        # crash-restart explorer hook (chaos/crash): object with
        # before_write/after_write, installed by run_scenario
        self.write_gate = None
        # fleet black boxes (obs/timeline.py) by candidate identity:
        # every applied fault is recorded as a chaos-fault event — the
        # labeled ground truth the attribution score is computed against
        self.timelines: Dict[str, object] = {}
        # operator-crash kills due this tick: identity, or None for
        # "whoever currently leads" — the campaign drains these after
        # injector.tick() and reboots the victim as a fresh process
        self._pending_crashes: List[Optional[str]] = []

    # ------------------------------------------------------------- wiring

    def client(self, identity: str = "") -> ChaosClient:
        return ChaosClient(self, self.cluster.client, identity)

    @property
    def t0(self) -> float:
        """Campaign start on the injected clock; ``self.events`` fault
        times are modelled seconds relative to this (the attribution
        scorer rebases them to absolute timeline time)."""
        return self._t0

    def attach_timeline(self, identity: str, timeline) -> None:
        """Attach a candidate operator's FleetTimeline. Faults already
        applied are replayed in, backdated to their injection time — a
        rebooted operator's fresh timeline must still see the fault
        that predates it, or its post-reboot pages would attribute to
        nothing (the labels-survive-a-crash discipline, applied to the
        black box)."""
        self.timelines[identity] = timeline
        for i in sorted(self._applied):
            self._record_fault(timeline, self.events[i])

    def _record_fault(self, timeline, ev: FaultEvent) -> None:
        for entity in fault_entities(ev):
            timeline.record_event(kind="chaos-fault", entity=entity,
                                  t=self._t0 + ev.at,
                                  until=self._t0 + ev.until,
                                  detail=ev.describe())

    def _log(self, msg: str) -> None:
        self.trace.append(f"t={self.clock.now() - self._t0:7.1f}s  {msg}")

    # -------------------------------------------------------- client gate

    def _active(self, fault_type: str) -> List[FaultEvent]:
        now = self.clock.now() - self._t0
        return [e for e in self.events
                if e.type == fault_type and e.at <= now < e.until]

    def before_op(self, op: str, identity: str) -> None:
        """The fault gate every wrapped client call passes through."""
        now = self.clock.now()
        if op in _LEASE_OPS:
            until = self._partitions.get(identity)
            if until is not None and now < until:
                raise ServerError(
                    f"injected partition: {identity} cannot reach the "
                    f"apiserver's lease endpoint")
            return
        # blackout: EVERY call 5xxs (rate 1.0, no RNG draw — replay
        # stays byte-identical). create_event/direct stay exempt like
        # the flake fault; lease traffic returned above (leader-loss
        # composes the lease partition separately — faults.py).
        if op not in ("create_event", "direct") \
                and self._active("apiserver-blackout"):
            raise ServerError(f"injected apiserver blackout on {op}")
        for ev in self._active("apiserver-latency"):
            self.clock.sleep(self.rng.uniform(
                0.0, float(ev.params.get("max_latency_s", 1.0))))
        if op in _FLAKE_EXEMPT:
            return
        for ev in self._active("apiserver-flake"):
            if self.rng.random() < float(ev.params.get("rate", 0.2)):
                raise ServerError(f"injected 5xx on {op}")
        if op.startswith(_WRITE_PREFIXES):
            for ev in self._active("conflict-storm"):
                if self.rng.random() < float(ev.params.get("rate", 0.2)):
                    raise ConflictError(f"injected conflict on {op}")

    # ------------------------------------------------------- helpers

    def notready_nodes(self) -> Set[str]:
        """Nodes currently under an active node-notready fault — the
        budget invariant subtracts these (the operator did not take them
        out of service)."""
        out: Set[str] = set()
        for ev in self._active("node-notready"):
            out.update(ev.targets)
        return out

    def reclaimed_nodes(self) -> Set[str]:
        out: Set[str] = set()
        for ev in self._active("spot-reclaim"):
            out.update(ev.targets)
        return out

    def killed_replica_nodes(self) -> Set[str]:
        """Nodes whose serving replica process is dead right now (active
        replica-kill windows) — the campaign's serving tier kills the
        matching runtimes and may respawn once the window heals."""
        out: Set[str] = set()
        for ev in self._active("replica-kill"):
            out.update(ev.targets)
        return out

    def metrics_flake_nodes(self) -> Set[str]:
        """Nodes whose replica /metrics endpoint is down right now — the
        pool's scrape gate raises for replicas on them."""
        out: Set[str] = set()
        for ev in self._active("metrics-flake"):
            out.update(ev.targets)
        return out

    def mid_stream_kill_nodes(self) -> Set[str]:
        """Nodes under an active mid-stream-kill window: the serving
        tier kills the replica there the moment it holds streaming
        requests mid-generation, and blocks respawn until the window
        heals (the replica-kill twin aimed at in-flight streams)."""
        out: Set[str] = set()
        for ev in self._active("mid-stream-kill"):
            out.update(ev.targets)
        return out

    def kv_transfer_flaky(self, donor_node: str, peer_node: str) -> bool:
        """Should THIS live-migration KV transfer fail? True (at the
        fault's seeded rate) while either endpoint's node sits in an
        active kv-transfer-flake window — the router's transfer gate
        raises on it and its bounded retry/backoff takes over."""
        for ev in self._active("kv-transfer-flake"):
            if donor_node in ev.targets or peer_node in ev.targets:
                if self.rng.random() < float(ev.params.get("rate", 0.5)):
                    return True
        return False

    def blackout_active(self) -> bool:
        """True while an apiserver-blackout window is open — the
        campaign's serving tier and assertions key off it."""
        return bool(self._active("apiserver-blackout"))

    def drain_operator_crashes(self) -> List[Optional[str]]:
        """Operator-crash kills that came due since the last drain:
        each entry is a candidate identity, or None for "the current
        leader". The campaign reboots each victim as a fresh process."""
        out, self._pending_crashes = self._pending_crashes, []
        return out

    def flash_crowd_rate(self) -> int:
        """Extra requests/tick the ServingTier must submit right now —
        the sum of every active flash-crowd window's arrival spike (the
        demand side of the capacity market under stress)."""
        return sum(int(ev.params.get("requests_per_tick", 8))
                   for ev in self._active("flash-crowd"))

    def quiet(self) -> bool:
        """True once every scheduled fault window has closed and every
        heal has run — the campaign requires this before convergence."""
        now = self.clock.now() - self._t0
        return (all(now >= e.until for e in self.events)
                and all(self.clock.now() >= t
                        for t in self._partitions.values()))

    def _set_node_ready(self, name: str, ready: bool) -> None:
        # kubelet's condition write, played directly against the store
        # (the fake has no kubelet; envtest tests hand-set status too)
        try:
            node = self.cluster.get("Node", "", name)
        except KeyError:
            return
        node.status.conditions[0].status = "True" if ready else "False"
        self.cluster.update(node)
        self.cluster.flush_cache()

    def _driver_pods_on(self, node_name: str):
        pods = self.cluster.list("Pod", namespace=self.namespace,
                                 label_selector=self.driver_labels or None)
        return [p for p in pods if p.spec.node_name == node_name]

    # ----------------------------------------------------------- the tick

    def tick(self) -> None:
        """Apply every due fault, heal every expired one. Runs BEFORE the
        operator's reconcile each campaign tick."""
        now = self.clock.now() - self._t0
        for i, ev in enumerate(self.events):
            if i not in self._applied and ev.at <= now:
                self._applied.add(i)
                self._apply(i, ev)
            if (i in self._applied and i not in self._healed
                    and now >= ev.until):
                self._healed.add(i)
                self._heal(i, ev)

    def _apply(self, idx: int, ev: FaultEvent) -> None:
        self._log(f"INJECT {ev.describe()}")
        for timeline in self.timelines.values():
            self._record_fault(timeline, ev)
        if ev.type == "driver-crashloop":
            restarts = int(ev.params.get("restart_count", 12))
            broken: List[str] = []
            for node in ev.targets:
                for pod in self._driver_pods_on(node):
                    self.cluster.set_pod_status(
                        pod.metadata.namespace, pod.metadata.name,
                        ready=False, restart_count=restarts)
                    broken.append(pod.metadata.name)
            self._broken_pods[idx] = broken
        elif ev.type == "node-notready":
            for node in ev.targets:
                self._set_node_ready(node, False)
        elif ev.type == "leader-loss":
            self._partition_leader(ev)
        elif ev.type == "eviction-storm":
            times = int(ev.params.get("count", 3))
            selector = ev.params.get("selector")
            pods = self.cluster.list("Pod", namespace=None,
                                     label_selector=selector)
            for pod in pods:
                if pod.spec.node_name in ev.targets:
                    self.cluster.block_eviction(pod.metadata.namespace,
                                                pod.metadata.name,
                                                times=times)
        elif ev.type == "spot-reclaim":
            deadline = self.clock.wall() + float(
                ev.params.get("deadline_s", 120.0))
            for node in ev.targets:
                try:
                    self.cluster.client.direct().patch_node_taints(
                        node, [{"key": RECLAIM_TAINT_KEY,
                                "value": f"{deadline:.0f}",
                                "effect": RECLAIM_TAINT_EFFECT}])
                    self.cluster.client.direct().patch_node_metadata(
                        node, annotations={
                            RECLAIM_DEADLINE_ANNOTATION: f"{deadline:.3f}"})
                except KeyError:
                    pass
        elif ev.type == "watch-lag":
            self.cluster.cache_lag = float(ev.params.get("lag_s", 5.0))
        elif ev.type == "operator-crash":
            self._pending_crashes.append(ev.params.get("identity"))
        # latency/flake/conflict/blackout windows act purely through
        # before_op;
        # replica-kill / metrics-flake act through the serving tier's
        # killed_replica_nodes() / metrics_flake_nodes() polls (no
        # cluster object models a replica process)

    def _heal(self, idx: int, ev: FaultEvent) -> None:
        self._log(f"HEAL   {ev.describe()}")
        if ev.type == "driver-crashloop":
            # a pod the repair loop already restarted is healthy under a
            # NEW name/uid; only the original, still-broken pod recovers
            # on its own (the transient-crashloop / flap-damping case)
            for name in self._broken_pods.pop(idx, []):
                try:
                    pod = self.cluster.get("Pod", self.namespace, name)
                except KeyError:
                    continue
                if not all(cs.ready for cs in pod.status.container_statuses):
                    self.cluster.set_pod_status(self.namespace, name,
                                                ready=True, restart_count=0)
        elif ev.type == "node-notready":
            for node in ev.targets:
                self._set_node_ready(node, True)
        elif ev.type == "spot-reclaim":
            # the reclaim window closes: capacity returns (or the notice
            # was cancelled) — taint and deadline annotation lift
            for node in ev.targets:
                try:
                    self.cluster.client.direct().patch_node_taints(
                        node, [{"$patch": "delete",
                                "key": RECLAIM_TAINT_KEY}])
                    self.cluster.client.direct().patch_node_metadata(
                        node, annotations={
                            RECLAIM_DEADLINE_ANNOTATION: None})
                except KeyError:
                    pass
        elif ev.type == "watch-lag":
            self.cluster.cache_lag = self._base_cache_lag
        # latency/flake/conflict/leader-loss windows expire on their own

    def _partition_leader(self, ev: FaultEvent) -> None:
        """Cut the CURRENT lease holder off from the lease endpoint for
        longer than its renew deadline: the holder demotes (client-go
        renew-deadline semantics, LeaderElector.tick_safely), then a
        standby acquires after the full lease duration — a real
        mid-reconcile failover, no shortcuts through the elector."""
        holder = ev.params.get("identity")
        if holder is None:
            try:
                lease = self.cluster.get(
                    "Lease", ev.params.get("lease_namespace",
                                           self.namespace),
                    ev.params.get("lease_name", "tpu-operator"))
                holder = lease.spec.holder_identity
            except KeyError:
                holder = None
        if not holder:
            self._log("leader-loss: no lease holder yet; skipped")
            return
        duration = ev.duration or (self.lease_duration_s * 1.5)
        self._partitions[holder] = self.clock.now() + duration
        self._log(f"leader-loss: partitioned {holder} for "
                  f"{duration:.0f}s")
