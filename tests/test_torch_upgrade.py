"""The port's driver-upgrade state machine held against the JAX package's,
tick by tick.

One harness builds the same seeded cluster in both packages'
``FakeCluster``s, each on its own ``FakeClock`` (the two advanced
together), and drives both packages' ``ClusterUpgradeStateManager``
through ``build_state`` + ``apply_state`` with the same interventions
(pods completing, crashlooping or recovering, evictions blocked by a
budget). At every tick it requires exact equality of the state
fingerprint, every node's labels, annotations (the journey included),
``unschedulable`` and resource version, the pods present with their
phases and revisions, and the events recorded. The scenarios are those
of ``tests/test_upgrade_state.py`` and ``tests/test_managers.py``, plus
the sharded reconcile in its deterministic mode and the incremental
``build_state(deltas=...)`` through each package's ``CachedClient`` with
the equivalence oracle on.
"""

import dataclasses
import importlib
from typing import Callable

import pytest

NS = "gpu-operator"
LABELS = {"app": "nvidia-driver-daemonset"}
DS = "nvidia-driver-daemonset"


class Stack:
    """One package's upgrade stack on a cluster of its own."""

    def __init__(self, side: str):
        root = {"reference": "k8s_operator_libs_tpu",
                "port": "k8s_operator_libs_tpu_torch"}[side]

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.side = side
        self.api = mod("api.v1alpha1")
        self.us = mod("upgrade.upgrade_state")
        self.groups = mod("upgrade.groups")
        self.cachedclient = mod("core.cachedclient")
        self.S = mod("upgrade.consts").UpgradeState
        self.keys = mod("upgrade.util").KeyFactory("gpu")
        self.clock = mod("utils.clock").FakeClock(1000.0)
        self.cluster = mod("core.fakecluster").FakeCluster(
            clock=self.clock, cache_lag=0.5)
        self.flags = {}
        self.mgr = None
        self.informer = None
        self._uids = {}

    def uid(self, uid):
        """Object uids come from a process-wide counter in each package,
        so they are compared by order of first appearance."""
        if not uid:
            return uid
        return self._uids.setdefault(uid, f"uid#{len(self._uids)}")

    @property
    def direct(self):
        return self.cluster.client.direct()

    def state_of(self, node):
        return self.direct.get_node(node).metadata.labels.get(
            self.keys.state_label, "")

    def pool_grouper(self):
        """Groups nodes by their ``pool`` label (a node without one is
        its own group), as a subclass of this package's NodeGrouper."""
        class PoolGrouper(self.groups.NodeGrouper):
            def group_key(self, node):
                return node.metadata.labels.get("pool", node.metadata.name)
        return PoolGrouper()

    def snapshot(self, fingerprint, error):
        nodes = [(n.metadata.name, n.metadata.resource_version,
                  sorted(n.metadata.labels.items()),
                  sorted(n.metadata.annotations.items()),
                  n.spec.unschedulable)
                 for n in self.direct.list_nodes()]
        pods = [(p.metadata.namespace, p.metadata.name, p.spec.node_name,
                 p.metadata.resource_version, p.status.phase,
                 sorted(p.metadata.labels.items()))
                for p in self.direct.list_pods()]
        events = [(e.object_kind, e.object_name, e.event_type, e.reason,
                   e.message) for e in self.cluster.recorder.drain()]
        if fingerprint is not None:
            fingerprint = {bucket: [e[:-1] + (self.uid(e[-1]),)
                                    for e in entries]
                           for bucket, entries in sorted(fingerprint.items())}
        return {"fingerprint": fingerprint, "error": error, "nodes": nodes,
                "pods": pods, "events": events}


@dataclasses.dataclass
class Scenario:
    setup: Callable                       # (stack) -> None
    policy: Callable                      # (stack) -> DriverUpgradePolicySpec
    ticks: int
    dt: float = 5.0
    manager_kw: Callable = lambda s: {}   # (stack) -> manager kwargs
    configure: Callable = lambda s, m: None
    hook: Callable = lambda s, t: None    # (stack, tick), before the tick
    check: Callable = lambda s: None      # (stack), after the tick
    expect: Callable = lambda s: None     # (stack), after the run
    cached: bool = False
    reconcile_ds: bool = True


def tick(s: Stack, sc: Scenario):
    fingerprint = error = None
    try:
        if sc.cached:
            s.informer.pump()
            state = s.mgr.build_state(NS, LABELS,
                                      deltas=s.informer.drain_deltas())
        else:
            state = s.mgr.build_state(NS, LABELS)
        fingerprint = s.us.state_fingerprint(state)
        s.mgr.apply_state(state, sc.policy(s))
    except Exception as exc:  # compared across the packages below
        error = (type(exc).__name__, str(exc))
        s.flags.setdefault("errors", []).append(error[0])
    if sc.reconcile_ds:
        s.cluster.reconcile_daemonsets()
    snap = s.snapshot(fingerprint, error)
    s.clock.sleep(sc.dt)
    return snap


def start(side: str, sc: Scenario) -> Stack:
    s = Stack(side)
    sc.setup(s)
    client = s.cluster.client
    if sc.cached:
        s.informer = s.cachedclient.CachedClient(
            s.cluster.client.direct(), namespaces=[NS], pumped=True,
            clock=s.clock).start()
        client = s.informer
    s.mgr = s.us.ClusterUpgradeStateManager(
        client, s.keys, s.cluster.recorder, s.clock, synchronous=True,
        **sc.manager_kw(s))
    s.mgr.verify_incremental = sc.cached
    sc.configure(s, s.mgr)
    return s


def run_parity(sc: Scenario):
    """Both packages tick by tick; returns the port's stack."""
    ref, port = start("reference", sc), start("port", sc)
    assert ref.snapshot(None, None) == port.snapshot(None, None)
    for t in range(sc.ticks):
        snaps = []
        for s in (ref, port):
            sc.hook(s, t)
            snaps.append(tick(s, sc))
            sc.check(s)
        want, got = snaps
        for key in want:
            assert got[key] == want[key], (f"tick {t}: {key} differs\n"
                                           f"reference {want[key]}\n"
                                           f"port      {got[key]}")
    for s in (ref, port):
        sc.expect(s)
    return port


# ------------------------------------------------------------- fleet setup

def fleet(n, ds_rev="v2", pod_rev="v1", prefix="node", pools=None,
          workloads=False):
    """One driver DaemonSet at ``ds_rev`` and ``n`` nodes each running a
    driver pod at ``pod_rev``; ``pools`` labels node i with pool i //
    pools; ``workloads`` adds a job=batch pod requesting a GPU on each."""
    def setup(s):
        ds = s.cluster.add_daemonset(DS, namespace=NS, labels=LABELS,
                                     revision_hash=ds_rev)
        for i in range(n):
            name = f"{prefix}{i}"
            labels = {"pool": f"pool-{i // pools}"} if pools else {}
            s.cluster.add_node(name, labels=labels)
            s.cluster.add_pod(f"driver-{name}", name, namespace=NS,
                              owner_ds=ds, revision_hash=pod_rev)
            if workloads:
                s.cluster.add_pod(f"job-{name}", name,
                                  labels={"job": "batch", "gpu": "true"})
    return setup


def then(*setups):
    def setup(s):
        for f in setups:
            f(s)
    return setup


def all_done(names):
    def expect(s):
        assert [s.state_of(n) for n in names] == [s.S.DONE] * len(names)
        drivers = s.direct.list_pods(namespace=NS, label_selector=LABELS)
        assert {p.metadata.labels["controller-revision-hash"]
                for p in drivers} == {"v2"}
    return expect


def in_progress_at_most(k):
    def check(s):
        busy = [n.metadata.name for n in s.direct.list_nodes()
                if n.metadata.labels.get(s.keys.state_label)
                in s.S.IN_PROGRESS]
        s.flags["most"] = max(s.flags.get("most", 0), len(busy))
        assert len(busy) <= k, busy
    return check


def policy(**kw):
    def make(s):
        api = s.api
        args = dict(auto_upgrade=True, max_parallel_upgrades=0,
                    max_unavailable="100%")
        for key, value in kw.items():
            if key == "drain":
                value = api.DrainSpec(**value)
            elif key == "wait_for_completion":
                value = api.WaitForCompletionSpec(**value)
            elif key == "pod_deletion":
                value = api.PodDeletionSpec(**value)
            args[key] = value
        return api.DriverUpgradePolicySpec(**args)
    return make


DRAIN = {"enable": True, "force": True, "timeout_second": 300}
NODES = [f"node{i}" for i in range(8)]


# --------------------------------------------------------------- scenarios

def _walk_hook(s, t):
    # the job finishes once its node has waited for it two ticks
    if s.state_of("node0") == s.S.WAIT_FOR_JOBS_REQUIRED:
        s.flags["waited"] = s.flags.get("waited", 0) + 1
        if s.flags["waited"] == 2:
            s.cluster.set_pod_status("default", "job-node0",
                                     phase="Succeeded")


def _walk_expect(s):
    all_done(["node0"])(s)
    journey = s.direct.get_node("node0").metadata.annotations[
        s.keys.journey_annotation]
    for state in (s.S.UPGRADE_REQUIRED, s.S.CORDON_REQUIRED,
                  s.S.WAIT_FOR_JOBS_REQUIRED, s.S.POD_DELETION_REQUIRED,
                  s.S.DRAIN_REQUIRED, s.S.POD_RESTART_REQUIRED,
                  s.S.UNCORDON_REQUIRED, s.S.DONE):
        assert f'"{state}"' in journey, (state, journey)


def _precordon(s):
    s.cluster.client.patch_node_unschedulable("node0", True)
    s.cluster.flush_cache()


def _precordoned_expect(s):
    all_done(NODES[:4])(s)
    assert s.direct.get_node("node0").spec.unschedulable
    assert not any(s.direct.get_node(n).spec.unschedulable
                   for n in NODES[1:4])


def _skip(s):
    s.cluster.client.patch_node_metadata(
        "node1", labels={s.keys.skip_node_label: "true"})
    s.cluster.flush_cache()


def _skip_expect(s):
    assert s.state_of("node1") == s.S.UPGRADE_REQUIRED
    assert [s.state_of(n) for n in ("node0", "node2")] == [s.S.DONE] * 2


def _orphans(s):
    for name, anno in (("lone0", {}),
                       ("lone1", {s.keys.upgrade_requested_annotation:
                                  "true"})):
        s.cluster.add_node(name, annotations=anno)
        s.cluster.add_pod(f"orphan-{name}", name, namespace=NS,
                          labels=LABELS, revision_hash="v0")


def _orphans_expect(s):
    assert s.state_of("lone0") == s.S.DONE
    assert [p.metadata.name for p in s.direct.list_pods(namespace=NS)
            if p.spec.node_name == "lone0"] == ["orphan-lone0"]
    # the requested orphan is deleted with a plain delete, never recreated
    assert not [p for p in s.direct.list_pods(namespace=NS)
                if p.spec.node_name == "lone1"]


def _crashloop_hook(s, t):
    """node0's new driver pod crashloops past the restart threshold, then
    recovers two ticks after its node was marked failed."""
    state = s.state_of("node0")
    pods = [p for p in s.direct.list_pods(namespace=NS, label_selector=LABELS)
            if p.spec.node_name == "node0"]
    fresh = [p for p in pods
             if p.metadata.labels["controller-revision-hash"] == "v2"]
    if (state == s.S.POD_RESTART_REQUIRED and fresh
            and not s.flags.get("broken")):
        s.cluster.set_pod_status(NS, fresh[0].metadata.name, ready=False,
                                 restart_count=11)
        s.flags["broken"] = True
    if state == s.S.FAILED:
        s.flags["failed"] = s.flags.get("failed", 0) + 1
        if s.flags["failed"] == 2:
            s.cluster.set_pod_status(NS, fresh[0].metadata.name, ready=True,
                                     restart_count=0)


def _crashloop_expect(s):
    all_done(NODES[:2])(s)
    assert s.flags["failed"] >= 2
    journey = s.direct.get_node("node0").metadata.annotations[
        s.keys.journey_annotation]
    assert f'"{s.S.FAILED}"' in journey


def _validators(s):
    # DaemonSet pods, so the drain leaves them be
    ds = s.cluster.add_daemonset("validator", labels={"role": "validator"})
    for i in range(2):
        s.cluster.add_pod(f"validator-node{i}", f"node{i}", owner_ds=ds,
                          ready=False)


def _validation_hook(s, t):
    # node0's validator turns ready after two ticks in validation;
    # node1's never does and times out (600 s)
    if s.state_of("node0") == s.S.VALIDATION_REQUIRED:
        s.flags["v0"] = s.flags.get("v0", 0) + 1
        if s.flags["v0"] == 2:
            s.cluster.set_pod_status("default", "validator-node0",
                                     ready=True)


def _validation_expect(s):
    assert s.state_of("node0") == s.S.DONE
    journey = s.direct.get_node("node1").metadata.annotations[
        s.keys.journey_annotation]
    assert f'"{s.S.VALIDATION_REQUIRED}"' in journey
    assert f'"{s.S.FAILED}"' in journey


def _blocked(s):
    for i in range(2):
        s.cluster.add_pod(f"web-node{i}", f"node{i}")
    s.cluster.block_eviction("default", "web-node0", times=3)
    s.cluster.block_eviction("default", "web-node1", times=10_000)


def _blocked_expect(s):
    # node1's drain times out: failed, then recovered through a driver
    # restart, with its pod never evicted
    all_done(NODES[:2])(s)
    journey = s.direct.get_node("node1").metadata.annotations[
        s.keys.journey_annotation]
    assert f'"{s.S.FAILED}"' in journey
    assert [p.metadata.name for p in s.direct.list_pods(namespace="default")
            ] == ["web-node1"]


def _deletion_pods(s):
    s.cluster.add_pod("done-node0", "node0", labels={"gpu": "true"},
                      phase="Succeeded")
    s.cluster.add_pod("cpu-node1", "node1", labels={"gpu": "false"})


def _deletion_expect(s):
    all_done(NODES[:3])(s)
    left = sorted(p.metadata.name
                  for p in s.direct.list_pods(namespace="default"))
    assert left == ["cpu-node1", "done-node0"]


def _stragglers(s):
    ds = s.cluster.add_daemonset(DS, namespace=NS, labels=LABELS,
                                 revision_hash="v2")
    for i, rev in enumerate(("v2", "v1", "v1")):
        s.cluster.add_node(f"node{i}", labels={"pool": "pair"})
        s.cluster.add_pod(f"driver-node{i}", f"node{i}", namespace=NS,
                          owner_ds=ds, revision_hash=rev)


def _safe_load(s):
    s.cluster.client.patch_node_metadata(
        "node0", annotations={s.keys.safe_load_annotation: "true"})
    s.cluster.flush_cache()


def _safe_load_expect(s):
    assert s.state_of("node0") == s.S.DONE
    anno = s.direct.get_node("node0").metadata.annotations
    assert s.keys.safe_load_annotation not in anno


def _requested(s):
    s.cluster.client.patch_node_metadata(
        "node1", annotations={s.keys.upgrade_requested_annotation: "true"})
    s.cluster.flush_cache()


def _requested_expect(s):
    # both drivers are current: only the requested node walks the pipeline
    assert [s.state_of(n) for n in NODES[:2]] == [s.S.DONE] * 2
    journeys = [s.direct.get_node(n).metadata.annotations[
        s.keys.journey_annotation] for n in NODES[:2]]
    assert f'"{s.S.CORDON_REQUIRED}"' not in journeys[0]
    assert f'"{s.S.CORDON_REQUIRED}"' in journeys[1]


def _lost_pod_hook(s, t):
    # a driver pod vanishes with nobody recreating it: build_state refuses
    # to act (DaemonSet with unscheduled pods) until the controller runs
    if t == 2:
        s.direct.delete_pod(NS, "driver-node1")
    if t >= 5:
        s.cluster.reconcile_daemonsets()


def _lost_pod_expect(s):
    all_done(NODES[:2])(s)
    assert set(s.flags["errors"]) == {"BuildStateError"}


def _sharded(cached):
    return Scenario(
        setup=fleet(6, pools=2), ticks=40, dt=15.0, cached=cached,
        policy=policy(max_unavailable="34%",
                      drain={"enable": True, "force": True,
                             "timeout_second": 60}),
        manager_kw=lambda s: {"grouper": s.pool_grouper(),
                              "shard_workers": 4, "shard_parallel": False},
        expect=all_done(NODES[:6]))


SCENARIOS = {
    "full-walk": Scenario(
        setup=fleet(1, workloads=True), ticks=16,
        policy=policy(max_parallel_upgrades=1, max_unavailable="25%",
                      wait_for_completion={"pod_selector": "job=batch"},
                      drain=DRAIN),
        hook=_walk_hook, expect=_walk_expect),
    "max-parallel-2": Scenario(
        setup=fleet(6), ticks=24, policy=policy(max_parallel_upgrades=2,
                                                drain=DRAIN),
        check=in_progress_at_most(2), expect=all_done(NODES[:6])),
    "max-unavailable-25pct": Scenario(
        setup=fleet(8), ticks=30, policy=policy(max_unavailable="25%",
                                                drain=DRAIN),
        check=in_progress_at_most(2), expect=all_done(NODES)),
    "precordoned-node": Scenario(
        setup=then(fleet(4), _precordon), ticks=30,
        policy=policy(max_parallel_upgrades=1, drain=DRAIN),
        expect=_precordoned_expect),
    "skip-label": Scenario(
        setup=then(fleet(3), _skip), ticks=12, policy=policy(drain=DRAIN),
        expect=_skip_expect),
    "orphaned-pods": Scenario(
        setup=_orphans, ticks=10, policy=policy(drain=DRAIN),
        expect=_orphans_expect),
    "pod-restart-failure-and-recovery": Scenario(
        setup=fleet(2), ticks=24, policy=policy(max_parallel_upgrades=1),
        hook=_crashloop_hook, expect=_crashloop_expect),
    "validation": Scenario(
        setup=then(fleet(2), _validators), ticks=16, dt=120.0,
        policy=policy(drain=DRAIN),
        configure=lambda s, m: m.with_validation_enabled("role=validator"),
        hook=_validation_hook, expect=_validation_expect),
    "pdb-blocked-eviction": Scenario(
        setup=then(fleet(2), _blocked), ticks=12,
        policy=policy(drain={"enable": True, "force": True,
                             "timeout_second": 30}),
        expect=_blocked_expect),
    "wait-for-jobs-timeout": Scenario(
        setup=fleet(2, workloads=True), ticks=16, dt=30.0,
        policy=policy(wait_for_completion={"pod_selector": "job=batch",
                                           "timeout_second": 60}),
        expect=all_done(NODES[:2])),
    "pod-deletion-filter": Scenario(
        setup=then(fleet(3, workloads=True), _deletion_pods), ticks=14,
        policy=policy(pod_deletion={"force": True, "timeout_second": 60},
                      drain={"enable": False}),
        configure=lambda s, m: m.with_pod_deletion_enabled(
            lambda p: p.metadata.labels.get("gpu") == "true"),
        expect=_deletion_expect),
    "group-admits-stragglers": Scenario(
        setup=_stragglers, ticks=14, policy=policy(drain=DRAIN),
        manager_kw=lambda s: {"grouper": s.pool_grouper()},
        expect=all_done(NODES[:3])),
    "safe-load": Scenario(
        setup=then(fleet(1, pod_rev="v2"), _safe_load), ticks=12,
        policy=policy(drain=DRAIN), expect=_safe_load_expect),
    "upgrade-requested": Scenario(
        setup=then(fleet(2, pod_rev="v2"), _requested), ticks=12,
        policy=policy(drain=DRAIN),
        expect=_requested_expect),
    "lost-driver-pod": Scenario(
        setup=fleet(2), ticks=14, reconcile_ds=False,
        policy=policy(drain=DRAIN),
        hook=_lost_pod_hook, expect=_lost_pod_expect),
    "sharded-deterministic": _sharded(cached=False),
    "incremental-cached": dataclasses.replace(
        _sharded(cached=True),
        manager_kw=lambda s: {"grouper": s.pool_grouper()}),
    "sharded-incremental-cached": _sharded(cached=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_equals_the_reference_tick_by_tick(name):
    run_parity(SCENARIOS[name])


def test_throttle_scenarios_reach_their_bound():
    """The throttle scenarios really run at their limit (otherwise the
    parity above would hold on an idle fleet)."""
    for name, most in (("max-parallel-2", 2), ("max-unavailable-25pct", 2)):
        port = run_parity(SCENARIOS[name])
        assert port.flags["most"] == most, name


def test_incremental_build_state_rebuilds_only_once():
    port = run_parity(SCENARIOS["incremental-cached"])
    assert port.mgr._inc is not None and port.mgr._inc.rebuilds == 1
