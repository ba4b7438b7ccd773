"""The seven real-component harnesses the explorer runs over the port
(the twin of the JAX package's ``tools/race/harnesses.py``).

Each harness is a plain function ``harness(sched)`` that builds REAL
components of the port (no mocks of the code under test: the fakes are
the cluster and the clock, as in the chaos campaign), drives them from
several shim threads, and asserts the component's contract at the end.
Under the cooperative scheduler every lock, event and clock operation is
a preemption point, so the explorer steers different interleavings
through the production code; the lockset checker rides along and
convicts unguarded shared state even on passing schedules.

| harness             | real concurrency under test                      |
|---------------------|--------------------------------------------------|
| drain_parallel      | upgrade/drain_manager.py per-node drain workers  |
| evict_workers       | upgrade/pod_manager.py per-node eviction workers |
| leader_renew_demote | core/leaderelection.py renew loop vs release,    |
|                     | plus a standby racing the takeover               |
| informer_reader     | core/cachedclient.py informer apply vs readers   |
| uploader_mirror     | train/uploader.py mirror loop vs writer +        |
|                     | wait_idle                                        |
| router_tick_proxy   | router.py drain-watch ticker vs /generate proxy  |
|                     | threads (socket-free post_json)                  |
| sharded_reconcile   | upgrade/sharding.py per-clique shard workers +   |
|                     | shared BudgetAccountant + concurrent barrier     |
|                     | pumps into one pumped informer store             |

The components are imported here, at module level, so that a module's
own primitives (a module-level lock) are made by the stdlib backend and
never by one schedule's scheduler.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import urllib.error

from ..api.v1alpha1 import (DrainSpec, DriverUpgradePolicySpec,
                            PodDeletionSpec)
from ..core.cachedclient import CachedClient, _Informer
from ..core.fakecluster import FakeCluster
from ..core.leaderelection import LeaderElector
from ..core.objects import Node, ObjectMeta
from ..gpu.topology import (CLIQUE_LABEL, COUNT_LABEL, NVLINK_DOMAIN_GPUS,
                            PRODUCT_LABEL, GPUNodeGrouper)
from ..router import RouterFront
from ..serving.pool import Replica, ReplicaPool
from ..serving.sim import SimReplicaRuntime, sim_tokens
from ..train.uploader import CheckpointUploader, _finalized_steps
from ..upgrade.consts import UpgradeState
from ..upgrade.drain_manager import DrainConfiguration, DrainManager
from ..upgrade.node_state_provider import NodeUpgradeStateProvider
from ..upgrade.pod_manager import PodManager, PodManagerConfig
from ..upgrade.upgrade_state import ClusterUpgradeStateManager
from ..upgrade.util import KeyFactory
from ..utils import threads

KEYS = KeyFactory("gpu")
NS = "gpu-operator"
DRIVER_DS = "nvidia-driver-daemonset"
# an NVLink clique of two GB200 nodes: GPUs per node such that the
# product's domain holds exactly two, as the reference's 4x2 v5e slice
# holds two hosts
CLIQUE_PRODUCT = "NVIDIA-GB200"
CLIQUE_NODES = 2
CLIQUE_GPUS = NVLINK_DOMAIN_GPUS[CLIQUE_PRODUCT] // CLIQUE_NODES


def _state_of(cluster, name: str) -> str:
    node = cluster.client.direct().get_node(name)
    return node.metadata.labels.get(KEYS.state_label, "")


# ------------------------------------------------------------------- drain

def drain_parallel(sched) -> None:
    """Three DrainManager worker threads cordon+drain concurrently; the
    dedup set must claim each node exactly once, every node must land
    in pod-restart-required, and the in-flight set must drain to
    empty."""
    cluster = FakeCluster(clock=sched.clock, cache_lag=0.05)
    names = [f"node{i}" for i in range(3)]
    for n in names:
        cluster.add_node(n)
        cluster.add_pod(f"w-{n}", n, labels={"app": "workload"})
    provider = NodeUpgradeStateProvider(cluster.client, KEYS,
                                        cluster.recorder, sched.clock)
    dm = DrainManager(cluster.client, provider, KEYS, cluster.recorder,
                      sched.clock, synchronous=False)
    nodes = [cluster.client.direct().get_node(n) for n in names]
    spec = DrainSpec(enable=True, force=True, timeout_second=300)
    dm.schedule_nodes_drain(DrainConfiguration(spec=spec, nodes=nodes))
    # a second schedule while drains are in flight must dedup, not
    # double-drain (the reconcile-reenters-mid-drain shape)
    dm.schedule_nodes_drain(DrainConfiguration(spec=spec, nodes=nodes))
    dm.wait_idle(timeout=600.0)
    assert len(dm.draining_nodes) == 0, "draining set not drained"
    for n in names:
        node = cluster.client.direct().get_node(n)
        assert node.spec.unschedulable, f"{n} not cordoned"
        assert _state_of(cluster, n) == UpgradeState.POD_RESTART_REQUIRED, \
            f"{n} in {_state_of(cluster, n)!r}"
    assert cluster.client.direct().list_pods(
        label_selector={"app": "workload"}) == []


# ---------------------------------------------------------------- eviction

def evict_workers(sched) -> None:
    """Per-node eviction workers: the filtered workload pods are gone,
    every node advances, the in-progress set empties."""
    cluster = FakeCluster(clock=sched.clock, cache_lag=0.05)
    names = [f"node{i}" for i in range(3)]
    for n in names:
        cluster.add_node(n)
        cluster.add_pod(f"w-{n}", n, labels={"app": "workload"})
    provider = NodeUpgradeStateProvider(cluster.client, KEYS,
                                        cluster.recorder, sched.clock)
    pm = PodManager(cluster.client, provider, KEYS,
                    pod_deletion_filter=lambda p: (p.metadata.labels or {})
                    .get("app") == "workload",
                    recorder=cluster.recorder, clock=sched.clock,
                    synchronous=False)
    nodes = [cluster.client.direct().get_node(n) for n in names]
    config = PodManagerConfig(
        nodes=nodes,
        deletion_spec=PodDeletionSpec(force=True, timeout_second=300))
    pm.schedule_pod_eviction(config)
    pm.schedule_pod_eviction(config)   # reentrancy: dedup via StringSet
    pm.wait_idle(timeout=600.0)
    assert len(pm._in_progress) == 0
    for n in names:
        assert _state_of(cluster, n) == UpgradeState.POD_RESTART_REQUIRED, \
            f"{n} in {_state_of(cluster, n)!r}"
    assert cluster.client.direct().list_pods(
        label_selector={"app": "workload"}) == []


# ---------------------------------------------------------------- elector

def leader_renew_demote(sched) -> None:
    """The background renew loop vs a voluntary release, with a standby
    candidate racing the takeover: never two leaders at an observation
    point, release() always demotes, and the standby eventually wins
    after the lease expires."""
    cluster = FakeCluster(clock=sched.clock)
    a = LeaderElector(cluster.client, "gpu-operator", NS, "op-a",
                      lease_duration_s=3.0, retry_period_s=0.5,
                      clock=sched.clock)
    b = LeaderElector(cluster.client, "gpu-operator", NS, "op-b",
                      lease_duration_s=3.0, retry_period_s=0.5,
                      clock=sched.clock)
    stop = threads.make_event("harness-stop")
    a.run_background(stop)

    observations = []

    def standby():
        # b is ticked by THIS task only (one driver per elector, as in
        # production); a is observed through the lock-free is_leader read
        for _ in range(12):
            b.tick_safely()
            observations.append((a.is_leader, b.is_leader))
            sched.clock.sleep(0.5)
        sched.clock.sleep(3.5)    # outlive the lease even if A's release
        b.tick_safely()           # CAS lost to a concurrent renew PUT

    s = threads.spawn("standby", standby)
    # EITHER candidate may win the create race; release a regardless
    # WHILE its renew thread may be mid-PUT: release must demote before
    # the record clears, so observers never see two leaders
    sched.clock.sleep(1.2)
    a.release()
    assert not a.is_leader, "release() must demote immediately"
    assert a._bg_thread is None, "release() must join the renew thread"
    s.join()
    stop.set()
    for was_a, was_b in observations:
        assert not (was_a and was_b), "two leaders observed"
    # a released and stopped renewing; whichever way the initial race
    # went, b holds the lease by its final tick
    assert b.is_leader, "standby never took over the released lease"


# ---------------------------------------------------------------- informer

def informer_reader(sched) -> None:
    """The informer's list-then-watch apply loop vs concurrent readers:
    reads must never see a half-applied object (the writer flips two
    labels together), a successful sync is visible, and stop/join
    leaves nothing running."""
    def node(version: int):
        return Node(metadata=ObjectMeta(
            name="n0", namespace="",
            labels={"a": str(version), "b": str(version)},
            resource_version=str(version)))

    def list_fn():
        return [node(1)], "1"

    windows = {"served": 0}

    def watch_fn(timeout_seconds=None, **kw):
        def gen():
            windows["served"] += 1
            if windows["served"] <= 2:
                for v in (2, 3):
                    sched.clock.sleep(0.05)
                    yield ("MODIFIED",
                           node(v + (windows["served"] - 1) * 2))
            else:
                sched.clock.sleep(timeout_seconds or 1.0)  # idle window
        return gen()

    inf = _Informer("Node", list_fn, watch_fn, watch_window_seconds=1.0,
                    clock=sched.clock)
    inf.start()
    assert inf.wait_synced(30.0), "informer never synced"

    def reader():
        for _ in range(8):
            snap = inf.snapshot()
            for obj in snap:
                labels = obj.metadata.labels
                assert labels["a"] == labels["b"], \
                    f"torn read: {labels}"   # two fields applied together
            got = inf.get("", "n0")
            assert got.metadata.labels["a"] == got.metadata.labels["b"]
            sched.clock.sleep(0.03)

    r1 = threads.spawn("reader-1", reader)
    r2 = threads.spawn("reader-2", reader)
    r1.join()
    r2.join()
    final = inf.get("", "n0")
    assert int(final.metadata.resource_version) >= 1
    inf.stop()
    inf.join(timeout=30.0)


# ---------------------------------------------------------------- uploader

def uploader_mirror(sched) -> None:
    """CheckpointUploader mirror loop vs a writer finalizing steps vs
    wait_idle: a True wait_idle means every finalized local step is
    durable, and stop() joins the mirror thread."""
    workdir = tempfile.mkdtemp(prefix="race-uploader-")
    local = os.path.join(workdir, "local")
    durable = os.path.join(workdir, "durable")
    os.makedirs(local)
    try:
        up = CheckpointUploader(local, durable, poll_seconds=0.2,
                                clock=sched.clock).start()

        def writer():
            for step in ("1", "2", "3"):
                staging = os.path.join(local, f"{step}.tmp")
                os.makedirs(staging)
                with open(os.path.join(staging, "w.bin"), "w") as f:
                    f.write("x" * 16)
                os.rename(staging, os.path.join(local, step))  # finalize
                sched.clock.sleep(0.15)

        w = threads.spawn("ckpt-writer", writer)
        w.join()
        ok = up.wait_idle(timeout=60.0)
        assert ok, "wait_idle timed out with a live mirror"
        missing = set(_finalized_steps(local)) - set(
            _finalized_steps(durable))
        assert not missing, f"wait_idle returned with {missing} not durable"
        up.stop()
        assert up._thread is not None and not up._thread.is_alive()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------------------------ router

def router_tick_proxy(sched) -> None:
    """router.py's RouterFront: concurrent /generate proxy threads vs
    the drain-watch ticker, with a mid-run cordon forcing a drain and a
    reroute. Every request must be served exactly once with the sim
    model's deterministic tokens, and the outstanding counters must
    return to zero."""
    cluster = FakeCluster(clock=sched.clock)
    cluster.add_node("n0")
    cluster.add_node("n1")
    pool = ReplicaPool(client=cluster.client, component="gpu",
                       clock=sched.clock)
    runtimes = {}
    for rid, node in (("r0", "n0"), ("r1", "n1")):
        rt = SimReplicaRuntime(max_slots=8)
        runtimes[f"sim://{rid}"] = rt
        pool.register(Replica(rid, node, rt, url=f"sim://{rid}"))

    def post_json(url, payload, timeout):
        base = url.rsplit("/", 1)[0]
        rt = runtimes[base]
        if not rt.alive() or rt._draining:
            raise urllib.error.HTTPError(url, 503, "draining", None, None)
        sched.clock.sleep(0.05)        # modelled service latency
        if not rt.alive() or rt._draining:
            # admission raced the drain: refuse, like a real replica
            # whose batcher stopped admitting between accept and serve
            raise urllib.error.HTTPError(url, 503, "draining", None, None)
        return {"tokens": sim_tokens(payload["tokens"],
                                     payload["max_new"])}

    front = RouterFront(pool, clock=sched.clock, post_json=post_json)
    stop = threads.make_event("harness-ticker-stop")

    def ticker():
        while not stop.is_set():
            front.tick()
            stop.wait(0.1)

    results = {}

    def proxy(i):
        prompt = [10 + i, 20 + i, 30 + i]
        code, body = front.generate(prompt, 4, session=f"s{i % 2}")
        results[i] = (code, body, prompt)

    t = threads.spawn("ticker", ticker)
    proxies = [threads.spawn(f"proxy-{i}", proxy, args=(i,))
               for i in range(4)]

    def cordoner():
        sched.clock.sleep(0.08)
        cluster.client.direct().patch_node_unschedulable("n0", True)

    c = threads.spawn("cordoner", cordoner)
    for h in proxies:
        h.join()
    c.join()
    stop.set()
    t.join()
    for i, (code, body, prompt) in sorted(results.items()):
        assert code == 200, f"request {i} failed: {code} {body}"
        assert body["tokens"] == sim_tokens(prompt, 4), \
            f"request {i} tokens diverged"
    with front.lock:
        leaked = {k: v for k, v in front._outstanding.items() if v}
    assert not leaked, f"outstanding never settled: {leaked}"
    assert front._completed == len(results)
    # the cordon was observed: r0 drained (unless every request finished
    # before the cordon landed; the ticker still must have seen it)
    r0 = pool.replicas["r0"]
    assert r0.draining or not runtimes["sim://r0"]._draining


# ------------------------------------------------------- sharded reconcile

def sharded_reconcile(sched) -> None:
    """Parallel per-clique shard workers driving the REAL state machine
    over a pumped CachedClient: concurrent barrier pumps into one
    informer store, concurrent admission against the single
    BudgetAccountant, dirty-set drain between ticks. Asserted every
    tick: the maxUnavailable budget is never overrun and a clique only
    ever leaves service whole (both nodes or neither); at the end the
    fleet converges to upgrade-done@v2 and the informer store equals
    the apiserver's."""
    cluster = FakeCluster(clock=sched.clock, cache_lag=0.05)
    ds = cluster.add_daemonset(DRIVER_DS, namespace=NS,
                               labels={"app": DRIVER_DS},
                               revision_hash="v1")
    names = []
    for s in range(2):
        labels = {PRODUCT_LABEL: CLIQUE_PRODUCT,
                  COUNT_LABEL: str(CLIQUE_GPUS),
                  CLIQUE_LABEL: f"u.pool-{s}"}
        for h in range(CLIQUE_NODES):
            name = f"pool-{s}-h{h}"
            cluster.add_node(name, labels=labels)
            cluster.add_pod(f"drv-{name}", name, namespace=NS,
                            owner_ds=ds, revision_hash="v1")
            names.append(name)
    client = CachedClient(cluster.client.direct(), namespaces=[NS],
                          pumped=True, clock=sched.clock).start()
    mgr = ClusterUpgradeStateManager(
        client, KEYS, cluster.recorder, sched.clock,
        grouper=GPUNodeGrouper(), synchronous=True,
        shard_workers=3, shard_parallel=True)
    mgr.verify_incremental = True
    policy = DriverUpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=0, max_unavailable="50%",
        drain=DrainSpec(enable=True, force=True, timeout_second=60))
    cluster.bump_daemonset_revision(DRIVER_DS, NS, "v2")
    budget = 2  # 50% of 4 nodes

    def out_of_service():
        out = set()
        for n in names:
            node = cluster.client.direct().get_node(n)
            label = node.metadata.labels.get(KEYS.state_label, "")
            if (node.spec.unschedulable
                    or label == UpgradeState.CORDON_REQUIRED):
                out.add(n)
        return out

    for _ in range(24):
        client.pump()
        deltas = client.drain_deltas()
        state = mgr.build_state(NS, {"app": DRIVER_DS}, deltas=deltas)
        mgr.apply_state(state, policy)
        cluster.reconcile_daemonsets()
        down = out_of_service()
        assert len(down) <= budget, \
            f"budget overrun: {sorted(down)} > {budget}"
        # clique atomicity: a clique leaves service whole or not at all;
        # a cordoned node's sibling must be cordoned too once the clique
        # is past admission (cordon-required members may still be
        # mid-cordon this tick)
        for n in down:
            node = cluster.client.direct().get_node(n)
            if not node.spec.unschedulable:
                continue
            pool = n.rsplit("-", 1)[0]
            siblings = [m for m in names
                        if m.startswith(pool + "-") and m != n]
            for m in siblings:
                sib = cluster.client.direct().get_node(m)
                sib_label = sib.metadata.labels.get(KEYS.state_label, "")
                assert (sib.spec.unschedulable
                        or sib_label == UpgradeState.CORDON_REQUIRED), \
                    f"clique split across the budget: {n} down, {m} up " \
                    f"({sib_label!r})"
        sched.clock.sleep(15.0)
        pods = cluster.client.direct().list_pods(
            namespace=NS, label_selector={"app": DRIVER_DS})
        # converged = every node done AND every pod at v2 (at tick 0 the
        # fleet is legitimately "done": the new ControllerRevision is
        # not watch-visible yet)
        if (all(_state_of(cluster, n) == UpgradeState.DONE for n in names)
                and len(pods) == len(names)
                and all(p.metadata.labels.get("controller-revision-hash")
                        == "v2" for p in pods)):
            break
    for n in names:
        assert _state_of(cluster, n) == UpgradeState.DONE, \
            f"{n} in {_state_of(cluster, n)!r}"
        assert not cluster.client.direct().get_node(n).spec.unschedulable
    pods = cluster.client.direct().list_pods(namespace=NS,
                                             label_selector={"app": DRIVER_DS})
    assert all(p.metadata.labels.get("controller-revision-hash") == "v2"
               for p in pods), "fleet not at v2"
    # the informer store converged to the apiserver's
    client.pump()
    cached = {n.metadata.name: n.metadata.resource_version
              for n in client.list_nodes()}
    truth = {n.metadata.name: n.metadata.resource_version
             for n in cluster.client.direct().list_nodes()}
    assert cached == truth, "informer store diverged from apiserver"


HARNESSES = {
    "drain_parallel": drain_parallel,
    "evict_workers": evict_workers,
    "leader_renew_demote": leader_renew_demote,
    "informer_reader": informer_reader,
    "uploader_mirror": uploader_mirror,
    "router_tick_proxy": router_tick_proxy,
    "sharded_reconcile": sharded_reconcile,
}

_PKG = "k8s_operator_libs_tpu_torch"

# files the lockset checker watches per harness (the component itself;
# None = the default spine)
LOCKSET_FILES = {
    "drain_parallel": [f"{_PKG}/upgrade/drain_manager.py",
                       f"{_PKG}/upgrade/util.py"],
    "evict_workers": [f"{_PKG}/upgrade/pod_manager.py",
                      f"{_PKG}/upgrade/util.py"],
    "leader_renew_demote": [f"{_PKG}/core/leaderelection.py"],
    "informer_reader": [f"{_PKG}/core/cachedclient.py"],
    "uploader_mirror": [f"{_PKG}/train/uploader.py"],
    "router_tick_proxy": [f"{_PKG}/router.py",
                          f"{_PKG}/serving/pool.py"],
    "sharded_reconcile": [f"{_PKG}/upgrade/sharding.py",
                          f"{_PKG}/core/cachedclient.py"],
}
