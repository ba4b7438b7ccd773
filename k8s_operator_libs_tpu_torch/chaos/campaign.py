"""Chaos campaign runner: seeded scenarios to convergence, invariants on.

One :func:`run_scenario` call is the whole story: build the fleet from
the scenario's :class:`~.scenario.FleetSpec`, stand up TWO operator
candidates behind real :class:`~..core.leaderelection.LeaderElector`\\ s
(so leader-loss faults drive a genuine failover through the lease
protocol, not a test shortcut), wrap every client in the seeded
:class:`~.injector.ChaosInjector`, and tick the world on a FakeClock —
injecting faults, reconciling under the current leader, replaying the
DaemonSet controller, stepping a simulated checkpoint-resume workload,
and evaluating every standing :mod:`invariant <.invariants>` — until the
fleet converges back to healthy or the tick budget runs out.

A failing run returns its seed + the injector's tick trace (the exact
fault schedule), and :func:`shrink_failure` greedily drops faults that
are not needed to reproduce — the smallest scenario that still fails is
what goes in the bug report.

``python -m k8s_operator_libs_tpu_torch.chaos --seeds N`` runs N seeded
random scenarios.

A port of the JAX package's ``chaos/campaign.py`` on GPU nodes: each
slice of the scenario's fleet is one NVLink clique (GB200 nodes under
one ``nvidia.com/gpu.clique``, upgraded as one group by
``GPUNodeGrouper``), each solo node a clique-less H100 node, the driver
the NVIDIA driver DaemonSet and each candidate a ``GPUOperator``. The
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import tempfile
from typing import Callable, Dict, List, Optional

import random

from ..api.v1alpha1 import (DrainSpec, DriverUpgradePolicySpec,
                            scaled_int_or_percent)
from ..core.client import ServerError
from ..core.fakecluster import FakeCluster
from ..core.leaderelection import LeaderElector
from ..core.resilience import ResilientClient
from ..health.classifier import ClassifierConfig
from ..health.monitor import HealthOptions
from ..health.remediation import RemediationPolicy
from ..market import (SERVING, TRAINING, CapacityArbiter, ManagedSlice,
                      MarketConfig)
from ..obs.billing import BillingEngine, UsageLedger
from ..obs.causes import CauseAnalyzer
from ..obs.goodput import GoodputLedger
from ..obs.usage import UsageMeter
from ..obs.metrics import MetricsHub
from ..obs.profile import TickProfiler, counting_client
from ..obs.slo import SLOOptions
from ..obs.timeline import FleetEvent, FleetTimeline
from ..obs.trace import Tracer
from ..serving.pool import DRAIN_STATES, Replica, ReplicaPool
from ..obs.reqtrace import RequestTraceRecorder
from ..serving.router import LANES, RequestRouter
from ..serving.sim import SimReplicaRuntime, sim_tokens
from ..gpu.operator import GPUOperator, ManagedComponent
from ..gpu.topology import (CLIQUE_LABEL, COUNT_LABEL, NVLINK_DOMAIN_GPUS,
                            PRODUCT_LABEL)
from ..upgrade.consts import UpgradeState
from ..upgrade.util import KeyFactory
from ..utils.clock import FakeClock
from ..wire import MARKET_OWNER_LABEL, QUARANTINE_LABEL
from .faults import RECLAIM_TAINT_KEY, fault_entities
from .injector import ChaosInjector
from .invariants import (CampaignView, Invariant, Violation,
                         default_invariants)
from .scenario import Scenario

logger = logging.getLogger(__name__)

NS = "gpu-operator"
COMPONENT = "gpu"
DRIVER_DS = "nvidia-driver-daemonset"
LEASE_NAME = "tpu-operator"
LEASE_NS = NS
LEASE_DURATION_S = 45.0
LEASE_RETRY_S = 10.0
DRIVER_LABELS = {"app": DRIVER_DS}
# a slice is a clique of CLIQUE_NODES GB200 nodes: GPUs per node such
# that the product's NVLink domain holds exactly that many nodes, so the
# state machine admits a clique only when all of them are visible (the
# reference's 4x4 slice of four hosts)
CLIQUE_PRODUCT = "NVIDIA-GB200"
CLIQUE_NODES = 4
CLIQUE_GPUS = NVLINK_DOMAIN_GPUS[CLIQUE_PRODUCT] // CLIQUE_NODES
SOLO_PRODUCT, SOLO_GPUS = "NVIDIA-H100-80GB-HBM3", 8


class OperatorKilled(BaseException):
    """Control-flow signal: the operator process identified by
    ``identity`` died RIGHT HERE (an operator-crash fault, or the
    crash-restart explorer killing at a durable-write boundary).

    A ``BaseException`` on purpose: the operator spine's per-component /
    per-slice / per-handler ``except Exception`` isolation must NOT
    absorb a process death — the kill propagates to the campaign loop,
    which discards the instance and reboots a fresh one against the
    surviving cluster state."""

    def __init__(self, identity: str, reason: str = "killed"):
        super().__init__(f"{identity}: {reason}")
        self.identity = identity
        self.reason = reason


@dataclasses.dataclass
class CampaignResult:
    scenario: str
    seed: int
    converged: bool
    ticks: int
    modelled_s: float
    violations: List[Violation]
    trace: List[str]
    failovers: int = 0
    # operator processes killed and rebooted fresh during the run
    # (operator-crash faults + crash-gate kills, chaos/crash)
    crashes: int = 0
    # serving-tier summary: submitted/completed/rerouted request counts,
    # drain handoffs, and how many replica generations were spawned
    router_stats: Optional[Dict[str, int]] = None
    # per-candidate flight-recorder payloads when run with profile=True
    # (None otherwise) — the profiler-determinism test compares these
    # across reruns of the same seed
    profile_payloads: Optional[Dict[str, dict]] = None
    # the serving tier's request flight recorder payload when run with
    # reqtrace=True (None otherwise) — the timeline-determinism test
    # compares these across reruns of the same seed
    reqtrace_payload: Optional[dict] = None
    # per-incarnation CauseReport lists (identity#incarnation ->
    # reports), frozen at kill time like final_alert_status — the
    # attribution-determinism test compares these across same-seed
    # reruns byte for byte
    cause_reports: Optional[Dict[str, list]] = None
    # the root-cause engine scored against injected-fault ground truth:
    # recall (fault-overlapped pages must rank the faulted entity in
    # their top 3) and precision (quiet-period pages must not blame
    # chaos-fault) — the campaign CLI (chaos/__main__.py) gates on this
    attribution: Optional[dict] = None
    # fleet-ledger summary: settled usage record count and a sha256
    # over the ledger bytes — the usage-determinism test compares these
    # across same-seed reruns (byte-identical ledgers)
    usage_digest: Optional[str] = None
    usage_records: int = 0

    @property
    def failed(self) -> bool:
        return bool(self.violations) or not self.converged

    def report(self) -> str:
        status = "PASS" if not self.failed else "FAIL"
        lines = [f"{status} {self.scenario} seed={self.seed} "
                 f"ticks={self.ticks} modelled={self.modelled_s:.0f}s "
                 f"failovers={self.failovers} crashes={self.crashes} "
                 f"violations={len(self.violations)}"]
        if self.attribution is not None:
            a = self.attribution
            lines.append(
                f"  attribution: pages={a['pages']} "
                f"fault-overlapped={a['fault_pages']} "
                f"recall={a['recall']:.2f} quiet={a['quiet_pages']} "
                f"precision={'ok' if a['precision_ok'] else 'VIOLATED'}")
            lines += [f"    MISS {m}" for m in a["misses"]]
        if self.failed:
            if not self.converged:
                lines.append("  did NOT converge")
            lines += [f"  {v}" for v in self.violations[:10]]
            lines.append(f"  replay: python -m k8s_operator_libs_tpu_torch"
                         f".chaos --seeds 1 --base-seed {self.seed}")
            lines += [f"  {t}" for t in self.trace]
        return "\n".join(lines)


def build_fleet(cluster: FakeCluster, fleet) -> List[str]:
    """Cliques + solo nodes + the managed driver DaemonSet, one pod per
    node at revision v1. Slice ``s`` is the clique ``u.pool-<s>`` of
    ``fleet.hosts_per_slice`` GB200 nodes (GPU Feature Discovery's
    labels); a solo node is an H100 node of 8 GPUs in no clique."""
    ds = cluster.add_daemonset(DRIVER_DS, namespace=NS,
                               labels=dict(DRIVER_LABELS),
                               revision_hash="v1")
    nodes: List[str] = []
    for s in range(fleet.slices):
        labels = {PRODUCT_LABEL: CLIQUE_PRODUCT,
                  COUNT_LABEL: str(CLIQUE_GPUS),
                  CLIQUE_LABEL: f"u.pool-{s}"}
        for host in fleet.slice_hosts(s):
            cluster.add_node(host, labels=labels)
            cluster.add_pod(f"drv-{host}", host, namespace=NS, owner_ds=ds,
                            revision_hash="v1")
            nodes.append(host)
    for i in range(fleet.solo_nodes):
        name = f"solo-{i}"
        cluster.add_node(name, labels={PRODUCT_LABEL: SOLO_PRODUCT,
                                       COUNT_LABEL: str(SOLO_GPUS)})
        cluster.add_pod(f"drv-{name}", name, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
        nodes.append(name)
    return nodes


def _make_operator(client, recorder, clock, max_unavailable: str,
                   tracer=None, shard_workers: int = 0,
                   resilience=None, usage=None) -> GPUOperator:
    return GPUOperator(
        client,
        components=[ManagedComponent(
            name=COMPONENT, namespace=NS,
            driver_labels=dict(DRIVER_LABELS),
            policy=DriverUpgradePolicySpec(
                auto_upgrade=True, max_parallel_upgrades=0,
                max_unavailable=max_unavailable,
                drain=DrainSpec(enable=True, force=True,
                                timeout_second=120)))],
        recorder=recorder, clock=clock, synchronous=True,
        metrics=MetricsHub(),
        health=HealthOptions(
            classifier=ClassifierConfig(damping_seconds=30.0,
                                        persist_seconds=60.0),
            policy=RemediationPolicy(recovery_seconds=45.0,
                                     backoff_base_seconds=60.0,
                                     max_unavailable=max_unavailable)),
        slo=SLOOptions.from_dict({}), tracer=tracer,
        # sharded reconcile under chaos runs the shard machinery
        # DETERMINISTICALLY (serial shard order, shared budget
        # accountant) so seed replay stays byte-identical; the real
        # interleavings are not explored here
        shard_workers=shard_workers, shard_parallel=False,
        # every campaign tick double-checks the incremental BuildState
        # against a full rebuild — divergence fails the component's
        # reconcile, which the convergence gate turns into a red run
        verify_incremental=True,
        # the resilient client boundary (retry/rate-limit/breaker) and
        # its fail-static degraded mode run in EVERY campaign — an
        # apiserver-blackout window must flip the operator degraded,
        # and ordinary flake windows exercise the read retries
        resilience=resilience,
        # the fleet usage meter rides the reconcile tick; the
        # usage-conservation invariant replays its ledger records
        usage=usage)


class SimJob:
    """The campaign's simulated checkpoint-resume workload, pinned to one
    node: it drain-saves and exits (``preempted=True``) when its node is
    cordoned, carries a spot-reclaim taint, OR is traded away by the
    capacity market (its ``tpu.dev/market.owner`` label leaves
    ``training``), and resumes — continuing the SAME ledger file — once
    the node returns. Its ledger is what the attribution invariant sums
    against the node's journey."""

    def __init__(self, path: str, node_name: str, clock):
        self.path = path
        self.node_name = node_name
        self.clock = clock
        self.ledger: Optional[GoodputLedger] = None
        self.running = False
        self.fresh = False
        self.step = 0

    def tick(self, cluster: FakeCluster) -> None:
        try:
            node = cluster.client.direct().get_node(self.node_name)
        except KeyError:
            return
        preempt = (node.spec.unschedulable
                   or any(t.key == RECLAIM_TAINT_KEY
                          for t in node.spec.taints)
                   or node.metadata.labels.get(
                       MARKET_OWNER_LABEL, "training") != "training")
        if self.running and preempt:
            with self.ledger.phase("drain_save"):
                self.clock.sleep(1.0)
            self.ledger.run_ended(self.step, preempted=True)
            self.ledger.close()
            self.ledger = None
            self.running = False
        elif not self.running and not preempt:
            self.ledger = GoodputLedger(self.path, clock=self.clock)
            self.ledger.run_started(self.step)
            with self.ledger.phase("ckpt_restore"):
                self.clock.sleep(1.0)
            self.running = True
            self.fresh = True
        elif self.running:
            self.step += 1
            if self.fresh:
                self.ledger.first_step(self.step, 1.0, 64)
                self.fresh = False
            else:
                self.ledger.steps(self.step, 1, 1.0, 64)

    def close(self) -> None:
        if self.ledger is not None:
            self.ledger.close()
            self.ledger = None


class ServingTier:
    """The campaign's router-tier workload: one deterministic
    :class:`~..serving.sim.SimReplicaRuntime` replica per slice (pinned
    to the slice's first host), fronted by a real
    :class:`~..serving.router.RequestRouter` whose cluster reads go
    through the CHAOS-INJECTED client (flakes, latency, conflicts hit
    the router exactly like the operator). Each tick it:

    - kills / respawns replicas from the injector's active
      ``replica-kill`` windows (a respawn is a NEW generation on the
      same node, never a resurrected runtime);
    - runs the POD-SIDE drain watch against the DIRECT client (the
      pod's own kubelet-level knowledge: a cordon/quarantine/reclaim on
      its node drains the replica even while the router's apiserver view
      is flaking — the backstop that keeps admission legality strict);
    - submits seeded requests while the scenario is active, ticks the
      router, steps every live runtime.

    Its router is handed to the invariant pass via
    :attr:`CampaignView.router` — the two router invariants check it
    every tick, and :meth:`verify_results` pins token-determinism at
    the end.
    """

    MAX_REQUESTS = 400
    # separate budget for flash-crowd arrivals so a long spike is
    # bounded work (the campaign must converge once windows close)
    MAX_CROWD = 600
    SHED_HIGH = 48

    def __init__(self, cluster: FakeCluster, clock, injector: ChaosInjector,
                 fleet, seed: int, reqtrace: bool = False):
        self.cluster = cluster
        self.injector = injector
        self.rng = random.Random((seed << 8) ^ 0x5EED)
        self.metrics = MetricsHub()
        self.pool = ReplicaPool(client=injector.client("router"),
                                component=COMPONENT, metrics=self.metrics,
                                clock=clock)
        self.pool.scrape_gate = self._scrape_gate
        # the request flight recorder (obs/reqtrace.py) rides the same
        # injected clock and mints ids from a counter — pure accounting,
        # so a reqtrace=False run of the same seed is byte-identical
        # (a test pins it, like run_scenario(profile=...))
        # It feeds the router-side fleet black box (obs/timeline.py):
        # drain/shed/migration/requeue edges become timeline events,
        # exactly like the router binary (router.py) wires them.
        self.timeline = FleetTimeline(clock=clock) if reqtrace else None
        recorder = RequestTraceRecorder(clock=clock,
                                        metrics=self.metrics,
                                        timeline=self.timeline) \
            if reqtrace else None
        self.router = RequestRouter(self.pool, metrics=self.metrics,
                                    clock=clock,
                                    shed_high=self.SHED_HIGH,
                                    reqtrace=recorder)
        # live-migration transfer gate: the kv-transfer-flake fault
        # fails payload transfers touching its target nodes, driving
        # the router's bounded retry/backoff and the degraded fallback
        self.router.transfer_gate = self._transfer_gate
        self.slice_nodes = [fleet.slice_hosts(s)[0]
                            for s in range(fleet.slices)]
        self.current: Dict[str, str] = {}
        self._gen = 0
        self.submitted = 0
        self.crowd_submitted = 0
        # market-granted burst replica (on the traded training node) and
        # the CURRENT leader's arbiter (run_scenario refreshes it each
        # tick — the tier re-grants a killed burst replica only while
        # the ledger still says the slice is lent)
        self.burst: Optional[str] = None
        self.arbiter: Optional[CapacityArbiter] = None
        for node in self.slice_nodes:
            self._spawn(node)

    def _scrape_gate(self, replica) -> None:
        if replica.node_name in self.injector.metrics_flake_nodes():
            raise ServerError("injected metrics-endpoint flake on "
                              + replica.node_name)

    def _transfer_gate(self, donor, peer) -> None:
        if self.injector.kv_transfer_flaky(donor.node_name,
                                           peer.node_name):
            raise ServerError(f"injected kv-transfer flake "
                              f"{donor.node_name} -> {peer.node_name}")

    def _spawn(self, node: str) -> None:
        self._gen += 1
        replica = Replica(f"replica-{node}-g{self._gen}", node,
                          SimReplicaRuntime(max_slots=4))
        self.pool.register(replica)
        self.current[node] = replica.id

    def _node_clean(self, node: str) -> bool:
        """The pod-side view: direct (uninjected) read, like the kubelet
        that would be delivering the SIGTERM."""
        try:
            obj = self.cluster.client.direct().get_node(node)
        except Exception:  # exc: allow — pod-side view: any read failure counts as not-clean (conservative)
            return False
        return (not obj.spec.unschedulable and obj.is_ready()
                and QUARANTINE_LABEL not in obj.metadata.labels
                and not any(t.key == RECLAIM_TAINT_KEY
                            for t in obj.spec.taints)
                and obj.metadata.labels.get(
                    self.pool.keys.state_label, "")
                not in DRAIN_STATES)

    def tick(self, active: bool) -> None:
        killed = self.injector.killed_replica_nodes()
        # mid-stream-kill waits for the replica to hold streaming
        # requests mid-generation before pulling the plug — the router
        # must resume the in-flight streams on peers from the last
        # acked sequence number (never lost, never duplicated)
        ms_kill = self.injector.mid_stream_kill_nodes()
        down = killed | ms_kill
        for node in self.slice_nodes:
            replica = self.pool.replicas.get(self.current.get(node, ""))
            if node in killed and replica is not None \
                    and replica.runtime.alive():
                replica.runtime.fail()
            if node in ms_kill and replica is not None \
                    and replica.runtime.alive() \
                    and getattr(replica.runtime, "busy", False):
                replica.runtime.fail()
            if node not in down and (
                    replica is None or replica.failed
                    or replica.drained) and self._node_clean(node):
                if replica is not None:
                    self.pool.deregister(replica.id)
                self._spawn(node)
        # the kill windows hit the market's burst replica like any other
        burst = self.pool.replicas.get(self.burst) if self.burst else None
        if burst is not None and burst.runtime.alive():
            if burst.node_name in killed or (
                    burst.node_name in ms_kill
                    and getattr(burst.runtime, "busy", False)):
                burst.runtime.fail()
        # while the ledger still lends the slice, a dead burst replica
        # respawns as a new generation once its node heals
        if self.arbiter is not None:
            for ms in self.arbiter.supply:
                if ms.phase != SERVING:
                    continue
                replica = (self.pool.replicas.get(self.burst)
                           if self.burst else None)
                if (replica is None or replica.failed) \
                        and ms.anchor not in down \
                        and self._node_clean(ms.anchor):
                    if replica is not None:
                        self.pool.deregister(replica.id)
                    self.grant_burst(ms)
        # pod-side drain backstop BEFORE the router ticks
        for replica in list(self.pool.replicas.values()):
            if replica.failed or replica.draining:
                continue
            if not self._node_clean(replica.node_name):
                self.router.drain_replica(replica, "pod-term")
        if active and self.submitted < self.MAX_REQUESTS \
                and self.pool.admitting():
            for _ in range(self.rng.randint(1, 2)):
                prompt = [self.rng.randrange(32000)
                          for _ in range(self.rng.randint(2, 6))]
                self.router.submit(prompt, self.rng.randint(2, 8),
                                   session=f"s{self.rng.randrange(8)}",
                                   lane=self.rng.choice(LANES))
                self.submitted += 1
        # flash crowd: the seeded open-loop arrival spike (bounded by
        # MAX_CROWD so the campaign always converges once windows close)
        crowd = self.injector.flash_crowd_rate()
        if crowd and self.pool.admitting():
            take = min(crowd, self.MAX_CROWD - self.crowd_submitted)
            for _ in range(max(0, take)):
                prompt = [self.rng.randrange(32000)
                          for _ in range(self.rng.randint(2, 6))]
                self.router.submit(prompt, self.rng.randint(2, 8),
                                   lane=self.rng.choice(LANES))
                self.crowd_submitted += 1
        self.router.tick()
        for replica in self.pool.replicas.values():
            if not replica.failed:
                replica.runtime.step()

    # ------------------------------------------------------ market hooks

    def grant_burst(self, ms) -> None:
        """Market ``grant`` hook: the traded training slice hosts a
        serving burst replica (a NEW generation each grant)."""
        self._gen += 1
        replica = Replica(f"replica-{ms.anchor}-m{self._gen}", ms.anchor,
                          SimReplicaRuntime(max_slots=4))
        self.pool.register(replica)
        self.burst = replica.id

    def revoke_burst(self, ms) -> bool:
        """Market ``revoke`` hook: drain the burst replica through the
        router (zero loss — in-flight work live-migrates to peers);
        True once the slice is clear of serving."""
        replica = (self.pool.replicas.get(self.burst)
                   if self.burst else None)
        if replica is None:
            self.burst = None
            return True
        if replica.failed:
            self.pool.deregister(replica.id)
            self.burst = None
            return True
        if not replica.draining:
            self.router.drain_replica(replica, "market-return")
        if replica.drained:
            self.pool.deregister(replica.id)
            self.burst = None
            return True
        return False

    def market_settled(self) -> bool:
        """Convergence gate: no burst replica left and every managed
        slice back with training."""
        if self.burst is not None:
            return False
        return self.arbiter is None or all(
            ms.phase == TRAINING for ms in self.arbiter.supply)

    def healthy(self) -> bool:
        """Convergence gate: every slice hosts a live, admitting replica
        again and no accepted request is still outstanding."""
        if self.router.outstanding:
            return False
        admitting = {r.node_name for r in self.pool.admitting()}
        return all(node in admitting for node in self.slice_nodes)

    def verify_results(self) -> List[str]:
        """Token determinism across replicas/handoffs/migrations: every
        completed request's tokens equal the sim model's deterministic
        decode, and its spliced client stream equals the result's
        generated tail."""
        out = []
        for rid, req in self.router.requests.items():
            if req.state != "completed":
                continue
            if req.tokens != sim_tokens(req.prompt, req.max_new):
                out.append(f"request {rid} tokens diverged after "
                           f"{req.handoffs} handoff(s)")
            tail = list(req.tokens[len(req.prompt):])
            if req.stream and list(req.stream) != tail:
                out.append(f"request {rid} spliced stream diverged "
                           f"from its result after {req.migrations} "
                           f"migration(s)")
        return out


def run_scenario(scenario: Scenario, seed: int,
                 workdir: Optional[str] = None,
                 invariants: Optional[List[Invariant]] = None,
                 hooks: Optional[List[Callable]] = None,
                 stop_on_violation: bool = True,
                 profile: bool = False,
                 reqtrace: bool = True,
                 cached_reads: bool = False,
                 shard_workers: int = 0,
                 write_gate=None) -> CampaignResult:
    """Run one scenario under one seed to convergence (or violation /
    tick exhaustion). ``hooks`` run each tick after the reconcile and
    before the invariant pass — tests inject rogue out-of-band writes
    there to prove the checkers catch them.

    ``profile=True`` runs each candidate with the full flight recorder
    (Tracer + TickProfiler + CountingClient between operator and chaos
    client) — pure accounting, so every invariant outcome, journey
    annotation, and router stat must be IDENTICAL to a profile=False run
    of the same seed; a test pins exactly that.

    ``reqtrace=True`` (the default — it is fixed-memory accounting on
    the injected clock) attaches the request flight recorder
    (obs/reqtrace.py) to the serving tier's router, so the
    request-trace-integrity invariant checks every recorded stage
    timeline each tick. Like ``profile``, it is provably free:
    ``router_stats``, sim tokens, and every invariant outcome must be
    IDENTICAL to a reqtrace=False run of the same seed, and same-seed
    reruns must replay identical timelines — tests pin both.

    ``cached_reads=True`` gives each candidate the informer read
    path: a pumped (synchronous, deterministic) CachedClient stacked on
    its chaos client, so list/watch traffic passes the fault gate while
    operator reads come from the informer stores, and BuildState runs
    incrementally from drained deltas with the equivalence oracle ON.
    ``shard_workers`` additionally runs the sharded reconcile in its
    deterministic serial mode.

    Every candidate runs behind a :class:`ResilientClient` (seeded
    backoff, breaker, fail-static degraded mode) stacked between its
    chaos client and its informer cache — blackout windows flip the
    leader degraded, ordinary flake windows exercise the read retries.

    ``write_gate`` installs the crash-restart explorer's hook on the
    injector (chaos/crash): it observes every durable write cluster-wide
    and may raise :class:`OperatorKilled` at a registered write
    boundary; the campaign then reboots the victim as a FRESH process
    (new operator, elector, arbiter, informer cache — only durable
    cluster state survives), exactly like an ``operator-crash`` fault."""
    clock = FakeClock(10_000.0)
    cluster = FakeCluster(clock=clock, cache_lag=0.5)
    fleet_nodes = build_fleet(cluster, scenario.fleet)
    keys = KeyFactory(COMPONENT)
    injector = ChaosInjector(cluster, clock, seed, scenario.faults,
                             namespace=NS, driver_labels=DRIVER_LABELS,
                             lease_duration_s=LEASE_DURATION_S)
    if write_gate is not None:
        if hasattr(write_gate, "reset"):
            write_gate.reset()
        injector.write_gate = write_gate
    identities = ("op-a", "op-b")
    profilers: Dict[str, TickProfiler] = {}

    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="chaos-campaign-")
        workdir = tmp.name
    # every candidate (and every reboot incarnation) meters the SAME
    # durable usage ledger, exactly like the goodput file: only the
    # leader settles ticks into it, standbys forget their in-memory
    # account, and a promotion/reboot resumes from the ledger tail
    usage_path = os.path.join(workdir, "usage.jsonl")
    goodput_path = os.path.join(workdir, "goodput.jsonl")

    def make_candidate(identity: str):
        client = injector.client(identity)
        tracer = None
        if profile:
            profilers[identity] = TickProfiler()
            tracer = Tracer(sink=profilers[identity], clock=clock)
            client = counting_client(client, tracer=tracer, clock=clock)
        # the resilient boundary sits ABOVE counting/chaos (every retry
        # is individually counted and individually taxed) and BELOW the
        # informer cache (list/watch traffic passes the breaker gate);
        # per-identity seed keeps backoff jitter replay-deterministic
        res = ResilientClient(
            client, clock=clock,
            seed=(seed << 4) ^ identities.index(identity))
        client = res
        elector_client = client  # lease ops pass through untouched
        if cached_reads:
            from ..core.cachedclient import CachedClient
            # pumped informers per candidate over ITS chaos client: the
            # fault gate taxes the list/watch traffic, reads are local.
            # Leases bypass the cache by design, so the elector sees the
            # exact same fault surface either way.
            client = CachedClient(client, namespaces=[NS], pumped=True,
                                  clock=clock).start(sync_timeout=120.0)
        elector = LeaderElector(elector_client, LEASE_NAME, LEASE_NS,
                                identity,
                                lease_duration_s=LEASE_DURATION_S,
                                retry_period_s=LEASE_RETRY_S, clock=clock)
        meter = UsageMeter(
            clock=clock,
            billing=BillingEngine(UsageLedger(usage_path), clock=clock,
                                  goodput_path=goodput_path))
        op = _make_operator(client, cluster.recorder, clock,
                            scenario.max_unavailable, tracer=tracer,
                            shard_workers=shard_workers, resilience=res,
                            usage=meter)
        # every candidate's fleet black box sees every injected fault —
        # the labeled ground truth its cause reports are scored against
        # (a reboot gets already-applied faults replayed in, backdated)
        injector.attach_timeline(identity, op.timeline)
        return elector, op

    candidates: Dict[str, tuple] = {
        identity: make_candidate(identity) for identity in identities}

    # the training job runs on the LAST host of slice 0; the serving
    # replicas sit on each slice's FIRST host — the capacity market
    # trades the training node between the two without ever putting both
    # workloads on one host
    job = SimJob(goodput_path, scenario.fleet.slice_hosts(0)[-1], clock)
    tier = ServingTier(cluster, clock, injector, scenario.fleet, seed,
                       reqtrace=reqtrace)
    if tier.timeline is not None:
        # the router-side black box sees the injected faults too, like
        # the operator candidates' timelines
        injector.attach_timeline("router", tier.timeline)
    checks = invariants if invariants is not None else default_invariants()
    budget = scaled_int_or_percent(scenario.max_unavailable,
                                   len(fleet_nodes), round_up=True)
    # one capacity arbiter per candidate, like the operators: only the
    # leader ticks, standbys resume mid-trade from the durable
    # tpu.dev/market.* annotations after a failover
    def make_arbiter(identity: str) -> CapacityArbiter:
        return CapacityArbiter(
            [ManagedSlice("market-train", [job.node_name])],
            client=injector.client(identity), component=COMPONENT,
            demand=tier.router, goodput_fn=lambda: 1.0,
            vacated=lambda ms: not job.running,
            grant=tier.grant_burst, revoke=tier.revoke_burst,
            recorder=cluster.recorder, clock=clock,
            # trade decisions land in the candidate's own black box —
            # the arbiter only ticks under the current leader, so the
            # leader's timeline carries the market-trade events
            timeline=candidates[identity][1].timeline,
            config=MarketConfig(preempt_rate=1.5, return_rate=0.4,
                                sustain_ticks=3, cooldown_seconds=60.0,
                                budget=budget))

    arbiters: Dict[str, CapacityArbiter] = {
        identity: make_arbiter(identity) for identity in identities}
    violations: List[Violation] = []
    bumped = scenario.upgrade_at is None
    prev_leader: Optional[str] = None
    failovers = 0
    crashes = 0
    converged = False
    tick = 0
    # identities whose process is DEAD and awaiting reboot (an
    # operator-crash fault or a crash-gate kill; a reboot can itself
    # fail while a blackout window blocks the informer warm-up — the
    # identity then stays dead and is retried next tick)
    dead: set = set()
    # process incarnation per identity: alert-manager state (like the
    # tsdb it derives from) is per-PROCESS soft state — a rebooted
    # operator legally restarts its alert machines from inactive, so
    # the alert-transition invariant must track each incarnation as a
    # distinct instance (exactly like a restarted Prometheus re-deriving
    # `for:` durations from scratch)
    incarnations: Dict[str, int] = {identity: 0
                                    for identity in identities}
    # a dying incarnation's FINAL alert status, frozen: its last
    # transitions (and the Events they emitted) must still be observed
    # exactly once by the alert/event-dedup invariants
    final_alert_status: Dict[str, list] = {}
    # likewise its final cause reports: every firing edge an
    # incarnation attributed must still be scored (and replay
    # byte-identically), crashes included
    final_cause_reports: Dict[str, list] = {}

    def kill(identity: str, reason: str) -> None:
        nonlocal crashes
        crashes += 1
        _, dying = candidates[identity]
        if dying.alert_manager is not None:
            final_alert_status[
                f"{identity}#{incarnations[identity]}"] = \
                dying.alert_manager.status()
        if dying.cause_analyzer is not None:
            final_cause_reports[
                f"{identity}#{incarnations[identity]}"] = \
                list(dying.cause_analyzer.reports)
        incarnations[identity] += 1
        dead.add(identity)
        injector.trace.append(
            f"t={clock.now() - 10_000.0:7.1f}s  CRASH {identity} "
            f"({reason}) — in-memory state gone; rebooting fresh")

    def reboot(identity: str) -> bool:
        try:
            candidates[identity] = make_candidate(identity)
            arbiters[identity] = make_arbiter(identity)
            # a fresh arbiter must resume from the durable annotations,
            # never re-decide trades it cannot remember
            arbiters[identity].standby()
            dead.discard(identity)
            injector.trace.append(
                f"t={clock.now() - 10_000.0:7.1f}s  REBOOT {identity} "
                f"as a fresh process")
            return True
        except Exception as exc:  # exc: allow — chaos reboot injection retries next tick; the campaign must not die
            injector.trace.append(
                f"t={clock.now() - 10_000.0:7.1f}s  REBOOT {identity} "
                f"failed ({exc}); retrying next tick")
            return False

    try:
        for tick in range(scenario.max_ticks):
            now = clock.now() - 10_000.0
            injector.tick()
            for target in injector.drain_operator_crashes():
                victim = target or prev_leader or identities[0]
                if victim in candidates and victim not in dead:
                    kill(victim, "operator-crash fault")
            for identity in sorted(dead):
                reboot(identity)
            if not bumped and now >= scenario.upgrade_at:
                cluster.bump_daemonset_revision(DRIVER_DS, NS, "v2")
                injector.trace.append(
                    f"t={now:7.1f}s  UPGRADE daemonset revision -> v2")
                bumped = True
            leaders = []
            for identity in identities:
                if identity in dead:
                    continue
                elector, _op = candidates[identity]
                if elector.tick_safely():
                    leaders.append(identity)
            if len(leaders) == 1 and leaders[0] != prev_leader:
                if prev_leader is not None:
                    failovers += 1
                    injector.trace.append(
                        f"t={now:7.1f}s  FAILOVER {prev_leader} -> "
                        f"{leaders[0]}")
                prev_leader = leaders[0]
            for identity in identities:
                if identity in dead:
                    continue
                elector, op = candidates[identity]
                if elector.is_leader:
                    try:
                        op.reconcile()
                    except OperatorKilled as killed:
                        kill(identity, killed.reason)
            cluster.reconcile_daemonsets()
            job.tick(cluster)
            # the router tier stops taking traffic once every fault
            # window closed AND the rollout fired — outstanding work then
            # drains, which the convergence gate requires
            tier.tick(active=not (bumped and injector.quiet()))
            # a write-gate kill requested from OUTSIDE an operator's own
            # call stack (e.g. at a router-stamped durable write) lands
            # on the current leader at the next campaign checkpoint
            gate = injector.write_gate
            if gate is not None and getattr(gate, "kill_leader_pending",
                                            False):
                gate.kill_leader_pending = False
                victim = prev_leader or identities[0]
                if victim not in dead:
                    kill(victim, getattr(gate, "last_reason",
                                         "crash-gate"))
            # the capacity market ticks under the CURRENT leader only —
            # and NEVER while that leader is degraded (fail-static: no
            # new trades off a stale view); standbys forget in-memory
            # trade state so a promotion resumes from the durable
            # annotations mid-trade
            leader_arbiter = (arbiters.get(leaders[0])
                             if len(leaders) == 1
                             and leaders[0] not in dead else None)
            leader_degraded = (len(leaders) == 1
                              and leaders[0] not in dead
                              and candidates[leaders[0]][1].degraded)
            for identity, arb in arbiters.items():
                if identity in dead:
                    continue
                if arb is leader_arbiter and not leader_degraded:
                    tier.arbiter = arb
                    try:
                        arb.tick()
                    except OperatorKilled as killed:
                        kill(identity, killed.reason)
                elif arb is not leader_arbiter:
                    arb.standby()
                    # the usage account follows the same standby
                    # discipline: a non-leader forgets its in-memory
                    # totals and re-resumes from the ledger tail if it
                    # ever leads again — never re-billing a span the
                    # real leader already settled
                    usage = candidates[identity][1].usage
                    if usage is not None:
                        usage.standby()
            for hook in hooks or []:
                hook(cluster=cluster, clock=clock, keys=keys, tick=tick,
                     router=tier.router)
            nodes = {n.metadata.name: n
                     for n in cluster.client.direct().list_nodes()}
            view = CampaignView(
                tick=tick, t=now, nodes=nodes, keys=keys, budget=budget,
                fault_notready=injector.notready_nodes(),
                leaders=leaders,
                recorder_events=list(cluster.recorder.events),
                alert_status={**final_alert_status,
                              **{f"{identity}#{incarnations[identity]}":
                                 (op.alert_manager.status()
                                  if op.alert_manager else [])
                                 for identity, (_, op)
                                 in candidates.items()
                                 if identity not in dead}},
                ledger_path=job.path, workload_node=job.node_name,
                tick_seconds=scenario.tick_seconds,
                router=tier.router, market=leader_arbiter,
                reqtrace=tier.router.reqtrace,
                usage_ledger_path=usage_path)
            for inv in checks:
                violations.extend(inv.check(view))
            if violations and stop_on_violation:
                break
            # convergence may not be declared while the rollout trigger
            # or any fault window is still ahead — a healthy t=0 fleet is
            # not a survived scenario
            if bumped and injector.quiet() and not dead \
                    and not any(op.degraded
                                for _, op in candidates.values()) \
                    and tier.healthy() and tier.market_settled() \
                    and _converged(
                        cluster, keys, nodes,
                        bumped=scenario.upgrade_at is not None, job=job):
                converged = True
                break
            clock.advance(scenario.tick_seconds)
        # end-of-run determinism sweep: any completed request whose
        # tokens differ from the sim decode was corrupted by a handoff
        for msg in tier.verify_results():
            violations.append(Violation("router-exactly-once", tick,
                                        clock.now() - 10_000.0, msg))
    finally:
        job.close()
        # fleet-ledger digest BEFORE the tempdir goes away: the
        # usage-determinism test pins same-seed reruns byte-identical
        try:
            with open(usage_path, "rb") as fh:
                payload = fh.read()
            usage_digest = hashlib.sha256(payload).hexdigest()
            usage_records = payload.count(b"\n")
        except OSError:
            usage_digest, usage_records = None, 0
        if tmp is not None:
            tmp.cleanup()
    cause_reports = {
        **final_cause_reports,
        **{f"{identity}#{incarnations[identity]}":
           list(op.cause_analyzer.reports)
           for identity, (_, op) in candidates.items()
           if identity not in dead and op.cause_analyzer is not None}}
    return CampaignResult(
        scenario=scenario.name, seed=seed, converged=converged,
        ticks=tick + 1, modelled_s=clock.now() - 10_000.0,
        violations=violations, trace=list(injector.trace),
        failovers=failovers, crashes=crashes,
        router_stats={
            "submitted": tier.submitted + tier.crowd_submitted,
            "completed": sum(
                1 for r in tier.router.requests.values()
                if r.state == "completed"),
            "shed": sum(tier.router._lane_shed.values()),
            "rerouted": tier.router._rerouted,
            "drains": len(tier.router.drains),
            "generations": tier._gen,
            "migrations": tier.router.migration_successes,
            "migration_fallbacks": tier.router.migration_fallbacks,
            "market_trades": sum(a.trades for a in arbiters.values()),
            "market_returns": sum(a.returns for a in arbiters.values()),
        },
        profile_payloads={identity: p.payload()
                          for identity, p in profilers.items()} or None,
        reqtrace_payload=(tier.router.reqtrace.payload()
                          if tier.router.reqtrace is not None else None),
        cause_reports=cause_reports,
        attribution=_score_attribution(cause_reports, injector),
        usage_digest=usage_digest, usage_records=usage_records)


def _converged(cluster: FakeCluster, keys: KeyFactory,
               nodes: Dict[str, object], bumped: bool,
               job: SimJob) -> bool:
    """Back to healthy: every node schedulable, Ready, unquarantined and
    untainted, every upgrade state terminal, every driver pod ready (and
    at the new revision when a rollout ran), the workload running."""
    from ..health import consts as hconsts
    for node in nodes.values():
        if node.spec.unschedulable or not node.is_ready():
            return False
        if hconsts.QUARANTINE_LABEL in node.metadata.labels:
            return False
        if any(t.key == RECLAIM_TAINT_KEY for t in node.spec.taints):
            return False
        state = node.metadata.labels.get(keys.state_label, "")
        if state not in ("", UpgradeState.DONE):
            return False
    pods = cluster.client.direct().list_pods(
        namespace=NS, label_selector=DRIVER_LABELS)
    if len(pods) != len(nodes):
        return False
    for pod in pods:
        if not all(cs.ready for cs in pod.status.container_statuses):
            return False
        if bumped and pod.metadata.labels.get(
                "controller-revision-hash") != "v2":
            return False
    return job.running


def _score_attribution(cause_reports: Dict[str, list],
                       injector: ChaosInjector) -> dict:
    """Score the cause engine against injected-fault ground truth.

    RECALL: every PAGE report whose burn window overlaps an injected
    fault window must rank an event on one of that fault's entities
    (:func:`~.faults.fault_entities`) among its top-3 causes.
    PRECISION: a page with NO overlapping fault must not rank
    ``chaos-fault`` in its top 3.  "Overlaps" is decided by the cause
    engine's own overlap arithmetic (a synthetic chaos-fault event over
    the fault window), so ground truth and engine can never disagree
    about edge-grazing windows.  Everything runs on the injected clock
    over deterministic inputs, so the stats replay byte-identically."""
    windows = [(injector.t0 + ev.at, injector.t0 + ev.until, ev)
               for ev in injector.events]
    pages = fault_pages = hits = quiet = 0
    misses: List[str] = []
    precision_ok = True
    for key in sorted(cause_reports):
        for report in cause_reports[key]:
            if report["severity"] != "page":
                continue
            pages += 1
            fired_at = report["fired_at"]
            since = fired_at - report["window_s"]
            overlapping = [
                ev for start, end, ev in windows
                if CauseAnalyzer._overlap(
                    FleetEvent(seq=0, kind="chaos-fault", entity="",
                               t=start, until=end),
                    since, fired_at) > 0.0]
            top = {c["entity"] for c in report["causes"][:3]}
            if overlapping:
                fault_pages += 1
                if any(set(fault_entities(ev)) & top
                       for ev in overlapping):
                    hits += 1
                else:
                    misses.append(
                        f"{key} {report['id']}: top-3 causes "
                        f"{sorted(top)} name no faulted entity of "
                        + "; ".join(ev.describe() for ev in overlapping))
            else:
                quiet += 1
                blamed = [c["entity"] for c in report["causes"][:3]
                          if c["kind"] == "chaos-fault"]
                if blamed:
                    precision_ok = False
                    misses.append(
                        f"{key} {report['id']}: quiet-period page "
                        f"blames chaos-fault on {blamed}")
    return {
        "pages": pages,
        "fault_pages": fault_pages,
        "recall_hits": hits,
        "recall": round(hits / fault_pages, 6) if fault_pages else 1.0,
        "quiet_pages": quiet,
        "precision_ok": precision_ok,
        "misses": misses,
    }


def shrink_failure(scenario: Scenario, seed: int,
                   **kwargs) -> Scenario:
    """Greedy delta-debugging: drop one fault at a time; keep the drop
    whenever the scenario still fails. Returns the minimal scenario that
    reproduces (possibly the original). Reruns are cheap — everything is
    a FakeClock simulation."""
    current = scenario
    shrunk = True
    while shrunk and len(current.faults) > 1:
        shrunk = False
        for i in range(len(current.faults)):
            candidate = dataclasses.replace(
                current,
                faults=current.faults[:i] + current.faults[i + 1:])
            if run_scenario(candidate, seed, **kwargs).failed:
                current = candidate
                shrunk = True
                break
    return current


def run_campaign(seeds: int, base_seed: int = 0,
                 scenario_fn=None, **kwargs) -> List[CampaignResult]:
    """N seeded scenarios (``scenario_fn(seed) -> Scenario``, default
    :func:`~.scenario.random_scenario`); every result returned, failures
    already shrunk. Extra kwargs (``cached_reads``, ``shard_workers``,
    ``profile``) pass through to every :func:`run_scenario` — including
    the shrink reruns, so a reproducer shrinks under the exact
    configuration that failed."""
    from .scenario import random_scenario
    scenario_fn = scenario_fn or random_scenario
    results: List[CampaignResult] = []
    for i in range(seeds):
        seed = base_seed + i
        scenario = scenario_fn(seed)
        result = run_scenario(scenario, seed, **kwargs)
        if result.failed:
            minimal = shrink_failure(scenario, seed, **kwargs)
            result.trace.append(
                "shrunk reproducer:\n" + minimal.describe())
        results.append(result)
    return results
