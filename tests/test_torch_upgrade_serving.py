"""The port's twin of the reference's serving e2e
(``tests/test_serve_upgrade_e2e.py::test_n_replica_rolling_upgrade_zero_loss``):
a rolling NVIDIA driver upgrade, driven by the port's
``ClusterUpgradeStateManager`` on the port's ``FakeCluster`` with the GPU
grouper and deletion filter, walks three GPU nodes that each host a live
port replica (tiny fp32 Llama, weights carried from JAX by
``convert.py``) behind the port's router.

The same schedule runs a second time with the JAX package's state
machine and ``FakeCluster`` in the port's place (the serving tier stays
the port's, over a client that raises the port's ``ApiError``). Each
node's journey of states must be the same in both runs, and equal to
:data:`ROLLING_ORDER`, the order ``chip_smoke.py`` phase 3f holds the
card's run to. Every request completes once, gapless, with the tokens of
the JAX package's solo ``generate``.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models.generate import generate as jgenerate
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
import k8s_operator_libs_tpu_torch.serving as tserving
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.gpu import (COUNT_LABEL, GPU_RESOURCE,
                                             PRODUCT_LABEL, GPUNodeGrouper,
                                             gpu_workload_deletion_filter)
from k8s_operator_libs_tpu_torch.gpu.device_plugin import DRIVER_LABELS
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from test_torch_serving import PortClient

JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)
GEOMETRY = dict(max_slots=2, capacity_per_slot=64, block_size=8)
NS = "gpu-operator"
DS = "nvidia-driver-daemonset"
HOSTS = ("gpu-a", "gpu-b", "gpu-c")
H100 = "NVIDIA-H100-80GB-HBM3"
COMPONENT = "gpu"

# every node's journey through a rolling driver upgrade with
# wait-for-completion on the serve pods, pod deletion and drain enabled:
# once its serve pod has completed, the deletion filter finds no pod
# holding a GPU, so the node goes from pod deletion straight to the
# driver restart and the drain is skipped (pod_manager.go:187-191)
ROLLING_ORDER = ["upgrade-required", "cordon-required",
                 "wait-for-jobs-required", "pod-deletion-required",
                 "pod-restart-required", "uncordon-required", "upgrade-done"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    tree = jax.device_get(init_params(jax.random.PRNGKey(0), JCFG))
    return tree, convert.to_torch(tree, device="cpu")


def add_serve_pod(cluster, objects, i, host):
    """The serve pod the wait-for-jobs gate watches; it holds one GPU."""
    pod = objects.Pod(metadata=objects.ObjectMeta(
        name=f"serve-{i}", namespace="default", labels={"job": "serve"}))
    pod.spec.node_name = host
    pod.spec.resource_requests = {GPU_RESOURCE: 1}
    pod.status.phase = "Running"
    pod.status.container_statuses = [objects.ContainerStatus(ready=True)]
    pod.status.conditions = [objects.PodCondition(type="Ready",
                                                  status="True")]
    cluster.create(pod)
    cluster.flush_cache()


def rolling_upgrade(side, params):
    """One rolling upgrade under live serving with ``side``'s state
    machine and cluster; returns what the checks read."""
    root = {"reference": "k8s_operator_libs_tpu",
            "port": "k8s_operator_libs_tpu_torch"}[side]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    api, objects = mod("api.v1alpha1"), mod("core.objects")
    S = mod("upgrade.consts").UpgradeState
    keys = mod("upgrade.util").KeyFactory(COMPONENT)
    clock = mod("utils.clock").FakeClock()
    cluster = mod("core.fakecluster").FakeCluster(clock=clock, cache_lag=0.5)
    ds = cluster.add_daemonset(DS, namespace=NS, labels=DRIVER_LABELS,
                               revision_hash="v1")
    for i, host in enumerate(HOSTS):
        cluster.add_node(host, labels={PRODUCT_LABEL: H100,
                                       COUNT_LABEL: "8"})
        cluster.add_pod(f"driver-{host}", host, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
        add_serve_pod(cluster, objects, i, host)
    mgr = mod("upgrade.upgrade_state").ClusterUpgradeStateManager(
        cluster.client, keys, cluster.recorder, clock,
        grouper=GPUNodeGrouper(), synchronous=True)
    mgr.with_pod_deletion_enabled(gpu_workload_deletion_filter)
    policy = api.DriverUpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=1, max_unavailable=1,
        wait_for_completion=api.WaitForCompletionSpec(
            pod_selector="job=serve"),
        pod_deletion=api.PodDeletionSpec(force=True, timeout_second=60),
        drain=api.DrainSpec(enable=True, force=True, timeout_second=60))

    client = cluster.client if side == "port" else PortClient(cluster.client)
    pool = tserving.ReplicaPool(client=client, component=COMPONENT,
                                clock=clock)
    router = tserving.RequestRouter(pool, clock=clock)
    gen = {host: 1 for host in HOSTS}

    def spawn(host):
        replica = tserving.Replica(
            f"{host}-g{gen[host]}", host,
            tserving.BatcherRuntime(params, TCFG, clock=clock, **GEOMETRY))
        gen[host] += 1
        return pool.register(replica)

    for host in HOSTS:
        spawn(host)

    rng = np.random.default_rng(21)
    expected = {}

    def submit(n, session=None):
        for _ in range(n):
            prompt = rng.integers(0, TCFG.vocab_size,
                                  size=int(rng.integers(4, 12))
                                  ).astype(np.int32)
            max_new = int(rng.integers(2, 7))
            expected[router.submit(prompt, max_new, session=session)] = (
                prompt, max_new)

    submit(9)
    cluster.bump_daemonset_revision(DS, NS, "v2")
    # the first drain's migrations are refused by every peer, so the
    # re-prefill fallback is taken, not only the live splice
    for replica in pool.replicas.values():
        replica.runtime.reject_adoptions = 50

    exited = set()
    min_admitting, most_busy = len(HOSTS), 0
    for it in range(600):
        mgr.apply_state(mgr.build_state(NS, DRIVER_LABELS), policy)
        cluster.reconcile_daemonsets()
        router.tick()
        if router.migration_fallbacks >= 1:
            for replica in pool.replicas.values():
                replica.runtime.reject_adoptions = 0
        nodes = {n.metadata.name: n
                 for n in cluster.client.direct().list_nodes()}
        assert router.check_invariants(nodes) == []
        min_admitting = min(min_admitting, len(pool.admitting()))
        most_busy = max(most_busy, sum(
            n.metadata.labels.get(keys.state_label) in S.IN_PROGRESS
            for n in nodes.values()))
        if it % 4 == 1 and len(expected) < 36:
            submit(1, session=f"s{it % 8}")
        for replica in list(pool.replicas.values()):
            if not replica.failed:
                replica.runtime.step()
            if (replica.draining and replica.drained
                    and replica.id not in exited):
                cluster.set_pod_status(
                    "default", f"serve-{HOSTS.index(replica.node_name)}",
                    phase="Succeeded")
                exited.add(replica.id)
            if replica.id in exited:
                node = nodes[replica.node_name]
                if (node.metadata.labels.get(keys.state_label) == S.DONE
                        and not node.spec.unschedulable):
                    pool.deregister(replica.id)
                    i = HOSTS.index(replica.node_name)
                    try:
                        cluster.set_pod_status("default", f"serve-{i}",
                                               phase="Running")
                    except KeyError:
                        add_serve_pod(cluster, objects, i, replica.node_name)
                    spawn(replica.node_name)
        if (all(n.metadata.labels.get(keys.state_label) == S.DONE
                and not n.spec.unschedulable for n in nodes.values())
                and router.outstanding == 0):
            router.tick()
            break
    else:
        raise AssertionError(f"{side}: the rolling upgrade never converged")

    direct = cluster.client.direct()
    journeys = {h: [s for s, _t in json.loads(
        direct.get_node(h).metadata.annotations[keys.journey_annotation])]
        for h in HOSTS}
    return {"router": router, "pool": pool, "expected": expected,
            "journeys": journeys, "iterations": it,
            "min_admitting": min_admitting, "most_busy": most_busy,
            "drivers": sorted(p.metadata.labels["controller-revision-hash"]
                              for p in direct.list_pods(namespace=NS))}


@pytest.fixture(scope="module")
def runs(weights):
    return {side: rolling_upgrade(side, weights[1])
            for side in ("reference", "port")}


def test_node_journeys_equal_the_reference_state_machines(runs):
    port, ref = runs["port"], runs["reference"]
    assert port["journeys"] == ref["journeys"]
    assert port["iterations"] == ref["iterations"]
    for host in HOSTS:
        assert port["journeys"][host] == ROLLING_ORDER, host


def test_rolling_upgrade_loses_nothing_and_ends_at_v2(runs):
    out = runs["port"]
    router, pool = out["router"], out["pool"]
    assert sorted(router.completed_counts) == sorted(out["expected"])
    assert all(c == 1 for c in router.completed_counts.values())
    assert router.check_invariants() == []
    assert out["min_admitting"] >= len(HOSTS) - 1
    assert out["most_busy"] == 1
    assert {node for (_r, node, _reason, _s) in router.drains} == set(HOSTS)
    for replica_id, node, reason, schedulable_at_drain in router.drains:
        assert reason == "upgrade:cordon-required", (replica_id, reason)
        assert schedulable_at_drain, replica_id
    assert router.migration_successes >= 1
    assert router.migration_fallbacks >= 1
    fallen_back = [r for r in router.requests.values()
                   if r.priority == "degraded"]
    assert fallen_back and all(r.state == "completed" for r in fallen_back)
    assert router.stream_violations == []
    for rid, (prompt, _n) in out["expected"].items():
        req = router.requests[rid]
        assert [seq for seq, _r in req.stream_log] == \
            list(range(len(req.stream)))
        if req.stream:
            assert req.stream == req.tokens[len(prompt):]
    assert out["drivers"] == ["v2"] * len(HOSTS)
    assert len(pool.admitting()) == len(HOSTS)


def test_rolling_upgrade_tokens_equal_the_jax_solo_decode(runs, weights):
    tree = weights[0]
    router = runs["port"]["router"]
    for rid, (prompt, max_new) in runs["port"]["expected"].items():
        want = np.asarray(jgenerate(tree, jnp.asarray(prompt[None]), JCFG,
                                    max_new_tokens=max_new))[0]
        assert router.result(rid) == want.tolist(), rid
        assert runs["reference"]["router"].result(rid) == want.tolist(), rid
