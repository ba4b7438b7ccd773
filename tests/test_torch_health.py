"""The port's fleet health (``health/``) held against the JAX package's.

Two parts. First, the reference's own unit tests (``tests/test_health.py``:
probes, classifier, remediator primitives, the metrics' exposition) run
on the port through :mod:`torch_twin`, with this file's port fixtures;
the one test built on TPU slice labels is replaced by its GPU twin
(a clique) below. Second, seeded scenarios run through both packages
side by side and are compared with ``==``: the probes over random
snapshots, the classifier over random firing schedules, and the whole
``FleetHealthMonitor`` over a random fault schedule on a fleet of single
nodes and one group (a GB200 clique in the port, an 18-host v5p slice in
the reference: the by-design name map of ``tests/test_torch_operator.py``).
Group keys sort by name and the remediator acts in that order, so the
single nodes are named to sort after both ``clique/...`` and
``slice/...``: the two packages then act in the same order.
The wire keys the health subsystem writes are held equal to the
reference's, since an operator of either package reads the other's
nodes.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_health.py",
    exclude={"test_slice_rollup_worst_member_wins":
             "built on TPU slice labels; its GPU twin is "
             "test_clique_rollup_worst_member_wins below"}))

from k8s_operator_libs_tpu_torch.core.fakecluster import (  # noqa: E402
    FakeCluster as PortCluster)
from k8s_operator_libs_tpu_torch.upgrade.util import (  # noqa: E402
    KeyFactory as PortKeys)
from k8s_operator_libs_tpu_torch.utils.clock import (  # noqa: E402
    FakeClock as PortClock)

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}
NS = "kube-system"
GROUP_HOSTS = 18


@pytest.fixture
def clock():
    return PortClock()


@pytest.fixture
def cluster(clock):
    return PortCluster(clock=clock, cache_lag=0.5)


@pytest.fixture
def keys():
    return PortKeys("gpu")


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def test_clique_rollup_worst_member_wins():
    """``test_slice_rollup_worst_member_wins`` on a GB200 clique: the
    clique's verdict is its worst member's, a node outside any clique is
    its own group."""
    from k8s_operator_libs_tpu_torch.core.objects import Node, ObjectMeta
    from k8s_operator_libs_tpu_torch.gpu.topology import (CLIQUE_LABEL,
                                                          COUNT_LABEL,
                                                          PRODUCT_LABEL,
                                                          GPUNodeGrouper)
    from k8s_operator_libs_tpu_torch.health.classifier import (
        HealthClassifier, NodeHealth)
    from k8s_operator_libs_tpu_torch.health.consts import HealthVerdict
    labels = {PRODUCT_LABEL: "NVIDIA-GB200", COUNT_LABEL: "4",
              CLIQUE_LABEL: "u.a"}
    nodes = [Node(metadata=ObjectMeta(name=f"h{i}", labels=dict(labels)))
             for i in range(4)] + [Node(metadata=ObjectMeta(name="solo"))]
    health = {f"h{i}": NodeHealth(node=f"h{i}",
                                  verdict=HealthVerdict.HEALTHY)
              for i in range(4)}
    health["h2"] = NodeHealth(node="h2",
                              verdict=HealthVerdict.UNHEALTHY_PERSISTENT)
    health["solo"] = NodeHealth(node="solo", verdict=HealthVerdict.DEGRADED)
    groups = {s.key: s for s in HealthClassifier.rollup(
        health, nodes, GPUNodeGrouper())}
    assert groups["clique/u.a"].verdict == HealthVerdict.UNHEALTHY_PERSISTENT
    assert groups["clique/u.a"].node_names == ["h0", "h1", "h2", "h3"]
    assert groups["solo"].verdict == HealthVerdict.DEGRADED


def test_wire_keys_equal_the_reference():
    """Every key of the reference's ``wire.py`` is in the port's with the
    same value, and ``health.consts`` exports the same names and values."""
    ref, port = mod("reference", "wire"), mod("port", "wire")
    keys = [k for k in vars(ref) if k.isupper()]
    assert keys and all(getattr(port, k) == getattr(ref, k) for k in keys)
    assert sorted(k for k in vars(port) if k.isupper()) == sorted(keys)
    rc, pc = mod("reference", "health.consts"), mod("port", "health.consts")
    assert pc.__all__ == rc.__all__
    for name in rc.__all__:
        if name != "HealthVerdict":
            assert getattr(pc, name) == getattr(rc, name), name
    assert pc.HealthVerdict.ALL == rc.HealthVerdict.ALL


# ------------------------------------------------ seeded, side by side

def random_snapshot(side, gen, clock, n=12):
    """Nodes with random heartbeats, error counters and conditions, each
    with a driver pod of random readiness, restarts and phase."""
    objects = mod(side, "core.objects")
    hc = mod(side, "health.consts")
    probes = mod(side, "health.probes")
    nodes, by_node = [], {}
    for i in range(n):
        annos = {}
        if gen.random() < 0.7:
            annos[hc.HEARTBEAT_ANNOTATION] = str(
                clock.now() - float(gen.integers(0, 400)))
        if gen.random() < 0.2:
            annos[hc.HEARTBEAT_ANNOTATION] = "garbage"
        for key in (hc.ICI_LINK_ERRORS_ANNOTATION,
                    hc.HBM_ECC_ERRORS_ANNOTATION):
            if gen.random() < 0.6:
                annos[key] = str(int(gen.integers(0, 200)))
        node = objects.Node(metadata=objects.ObjectMeta(
            name=f"n{i}", annotations=annos))
        node.status.conditions[0].status = ("False" if gen.random() < 0.15
                                            else "True")
        if gen.random() < 0.15:
            node.status.conditions.append(objects.NodeCondition(
                type="MemoryPressure", status="True"))
        nodes.append(node)
        pod = objects.Pod(metadata=objects.ObjectMeta(
            name=f"drv-n{i}", uid=f"u{i}-{int(gen.integers(0, 2))}"))
        pod.spec.node_name = f"n{i}"
        pod.status.phase = "Failed" if gen.random() < 0.1 else "Running"
        pod.status.container_statuses = [objects.ContainerStatus(
            ready=bool(gen.random() < 0.6),
            restart_count=int(gen.integers(0, 10)))]
        by_node[f"n{i}"] = [pod]
    return probes.Snapshot(nodes=nodes, pods_by_node=by_node, clock=clock)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probes_fire_the_same_signals(seed):
    """The default probes over 12 ticks of random snapshots: the same
    signals (node, probe, message, persistence hint) in the same order."""
    seen = {}
    for side in ROOTS:
        gen = np.random.default_rng(seed)
        clock = mod(side, "utils.clock").FakeClock(1000.0)
        probes = mod(side, "health.probes")
        sources = probes.default_probes()
        out = []
        for _ in range(12):
            signals, errors = probes.run_probes(
                sources, random_snapshot(side, gen, clock))
            out.append(([dataclasses.asdict(s) for s in signals], errors))
            clock.advance(float(gen.integers(1, 60)))
        seen[side] = out
    assert seen["port"] == seen["reference"]
    assert any(signals for signals, _ in seen["port"])


def group_node(side, name, group):
    objects = mod(side, "core.objects")
    if side == "reference":
        t = mod(side, "tpu.topology")
        labels = {t.GKE_ACCELERATOR_LABEL: "tpu-v5p-slice",
                  t.GKE_TOPOLOGY_LABEL: "2x6x6", t.GKE_NODEPOOL_LABEL: group}
    else:
        t = mod(side, "gpu.topology")
        labels = {t.PRODUCT_LABEL: "NVIDIA-GB200", t.COUNT_LABEL: "4",
                  t.CLIQUE_LABEL: f"u.{group}"}
    return objects.Node(metadata=objects.ObjectMeta(name=name,
                                                    labels=labels))


def grouper(side):
    if side == "reference":
        return mod(side, "tpu.topology").TPUSliceGrouper()
    return mod(side, "gpu.topology").GPUNodeGrouper()


def port_words(side, obj):
    """The reference's group keys in the port's words (the name map)."""
    if isinstance(obj, dict):
        return {port_words(side, k): port_words(side, v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [port_words(side, v) for v in obj]
    if isinstance(obj, str) and side == "reference":
        return obj.replace("slice/pool", "clique/u.pool")
    return obj


@pytest.mark.parametrize("seed", [0, 1])
def test_classifier_verdicts_and_rollup_agree(seed):
    """Damping, escalation, persistence hints and the healthy streak over
    40 ticks of random firing on 18 grouped and 6 single nodes: every
    node's and every group's verdict, reasons and streak agree."""
    seen = {}
    for side in ROOTS:
        gen = np.random.default_rng(seed)
        clock = mod(side, "utils.clock").FakeClock(1000.0)
        cls_mod = mod(side, "health.classifier")
        probes = mod(side, "health.probes")
        objects = mod(side, "core.objects")
        nodes = [group_node(side, f"g{i}", "pool-a")
                 for i in range(GROUP_HOSTS)]
        nodes += [objects.Node(metadata=objects.ObjectMeta(name=f"z{i}"))
                  for i in range(6)]
        classifier = cls_mod.HealthClassifier(
            clock=clock, config=cls_mod.ClassifierConfig(
                damping_seconds=30.0, persist_seconds=90.0))
        out = []
        for _ in range(40):
            firing = [n.metadata.name for n in nodes
                      if gen.random() < 0.12]
            signals = [probes.Signal("probe", name, "msg",
                                     persistent_hint=bool(
                                         gen.random() < 0.1))
                       for name in firing]
            health = classifier.classify(signals, nodes)
            groups = cls_mod.HealthClassifier.rollup(health, nodes,
                                                     grouper(side))
            out.append(port_words(side, (
                {k: dataclasses.asdict(v) for k, v in health.items()},
                [dataclasses.asdict(g) for g in groups])))
            clock.advance(float(gen.integers(5, 40)))
        seen[side] = out
    assert seen["port"] == seen["reference"]


def fault_fleet(side, seed):
    clock = mod(side, "utils.clock").FakeClock(1000.0)
    cluster = mod(side, "core.fakecluster").FakeCluster(clock=clock,
                                                         cache_lag=0.5)
    ds = cluster.add_daemonset("drv", namespace=NS, labels={"app": "drv"},
                               revision_hash="v1")
    names = []
    for i in range(GROUP_HOSTS):
        node = group_node(side, f"g{i}", "pool-a")
        cluster.add_node(node.metadata.name, labels=node.metadata.labels)
        names.append(node.metadata.name)
    for i in range(4):
        cluster.add_node(f"z{i}")
        names.append(f"z{i}")
    for name in names:
        cluster.add_pod(f"drv-{name}", name, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
    hm = mod(side, "health.monitor")
    cm = mod(side, "health.classifier")
    rm = mod(side, "health.remediation")
    monitor = hm.FleetHealthMonitor(
        cluster.client, mod(side, "upgrade.util").KeyFactory("drv"),
        namespace=NS, driver_labels={"app": "drv"}, grouper=grouper(side),
        recorder=cluster.recorder, clock=clock,
        options=hm.HealthOptions(
            classifier=cm.ClassifierConfig(damping_seconds=20.0,
                                           persist_seconds=60.0),
            policy=rm.RemediationPolicy(recovery_seconds=30.0,
                                        backoff_base_seconds=60.0,
                                        max_unavailable="50%")))
    return clock, cluster, monitor, names


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_reports_and_writes_agree_under_random_faults(seed):
    """The whole monitor (probe, classify, quarantine, repair injection,
    lift) on both packages' fake clusters under one seeded schedule of
    crash-loops, stale heartbeats and error-counter jumps: every report
    and every node's labels, annotations, taints and cordon agree at
    every tick, and the schedule does quarantine and lift."""
    seen = {}
    for side in ROOTS:
        gen = np.random.default_rng(seed)
        clock, cluster, monitor, names = fault_fleet(side, seed)
        hc = mod(side, "health.consts")
        direct = cluster.client.direct()
        # the setup's topology labels differ by design; left out
        topology = set(group_node(side, "x", "x").metadata.labels)
        out = []
        for t in range(60):
            for name in names:
                r = gen.random()
                if r < 0.02:
                    cluster.set_pod_status(NS, f"drv-{name}", ready=False,
                                           restart_count=12)
                elif r < 0.06:
                    cluster.set_pod_status(NS, f"drv-{name}", ready=True,
                                           restart_count=0)
                elif r < 0.07:
                    direct.patch_node_metadata(name, annotations={
                        hc.HBM_ECC_ERRORS_ANNOTATION:
                            str(int(gen.integers(0, 300)))})
                elif r < 0.09:
                    direct.patch_node_metadata(name, annotations={
                        hc.HEARTBEAT_ANNOTATION:
                            str(clock.wall() - float(gen.integers(0, 400)))})
            cluster.flush_cache()
            report = monitor.tick()
            nodes = [(n.metadata.name,
                      sorted((k, v) for k, v in n.metadata.labels.items()
                             if k not in topology),
                      sorted(n.metadata.annotations.items()),
                      sorted((x.key, x.effect) for x in n.spec.taints),
                      n.spec.unschedulable)
                     for n in direct.list_nodes()]
            rep = dataclasses.asdict(report)
            out.append(port_words(side, (rep, nodes, [
                (e.reason, e.message) for e in cluster.recorder.drain()])))
            clock.advance(15.0)
        seen[side] = out
    for t, (want, got) in enumerate(zip(seen["reference"], seen["port"])):
        assert got == want, f"tick {t}"
    reports = [rep for rep, _, _ in seen["port"]]
    assert any(r["actions"]["quarantined_slices"] for r in reports)
    assert any(r["actions"]["lifted_slices"] for r in reports)
