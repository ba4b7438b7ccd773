"""The port's GPU twins of the JAX package's ``tpu/`` layer
(``k8s_operator_libs_tpu_torch/gpu/``): GFD node facts and the grouper,
plugged into the JAX package's ``ClusterUpgradeStateManager`` on
``FakeCluster`` with the GPU deletion filter; the GPU scheduler's
placement contract; and its env turned into one rank per GPU by the
port's ``cluster_env`` over a gloo group."""

import subprocess
import sys

import pytest

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.api.v1alpha1 import (DrainSpec,
                                                DriverUpgradePolicySpec,
                                                PodDeletionSpec)
from k8s_operator_libs_tpu.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu.upgrade.upgrade_state import (
    ClusterUpgradeStateManager)
from k8s_operator_libs_tpu_torch.gpu import (CLIQUE_LABEL, COUNT_LABEL,
                                             GPU_RESOURCE, PRODUCT_LABEL,
                                             GPUNodeGrouper, GPUScheduler,
                                             GPUWorkload, gpu_info_for_node,
                                             gpu_workload_deletion_filter)
from k8s_operator_libs_tpu_torch.gpu.device_plugin import DRIVER_LABELS
from k8s_operator_libs_tpu_torch.gpu.scheduler import WORKLOAD_LABEL
from k8s_operator_libs_tpu_torch.gpu.topology import (
    validate_clique_membership)
from k8s_operator_libs_tpu_torch.parallel import launch

NS = "gpu-operator"
H100 = "NVIDIA-H100-80GB-HBM3"
GB200 = "NVIDIA-GB200"
NVL72_NODES = 18                      # 72 GPUs, 4 per compute tray


def gpu_labels(product=H100, count=8, clique=None):
    labels = {PRODUCT_LABEL: product, COUNT_LABEL: str(count)}
    if clique:
        labels[CLIQUE_LABEL] = clique
    return labels


def add_gpu_node(cluster, name, ds=None, **labels):
    cluster.add_node(name, labels=gpu_labels(**labels))
    if ds is not None:
        cluster.add_pod(f"driver-{name}", name, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
    return name


def upgrade(cluster, keys, clock, policy, nodes, ticks=80, deletion=True,
            check=None):
    """The canonical consumer loop with the GPU grouper (and the GPU
    deletion filter) until every node is upgrade-done; ``check(states)``
    runs on every tick's {node: (state, unschedulable)}."""
    mgr = ClusterUpgradeStateManager(cluster.client, keys, cluster.recorder,
                                     clock, grouper=GPUNodeGrouper(),
                                     synchronous=True)
    if deletion:
        mgr.with_pod_deletion_enabled(gpu_workload_deletion_filter)
    for _ in range(ticks):
        mgr.apply_state(mgr.build_state(NS, DRIVER_LABELS), policy)
        cluster.reconcile_daemonsets()
        states = {}
        for name in nodes:
            n = cluster.client.direct().get_node(name)
            states[name] = (n.metadata.labels.get(keys.state_label, ""),
                            n.spec.unschedulable)
        if check is not None:
            check(states)
        if all(s == UpgradeState.DONE for s, _ in states.values()):
            return states
    raise AssertionError(f"the fleet never converged: {states}")


# ---------------------------------------------------------------- topology

def test_node_facts_and_group_keys(cluster):
    g = GPUNodeGrouper()
    h100 = cluster.add_node("h0", labels=gpu_labels())
    info = gpu_info_for_node(h100)
    assert (info.product, info.gpus, info.multi_node) == (H100, 8, False)
    assert g.group_key(h100) == "h0"
    assert g.expected_group_size(h100) is None
    rack = [cluster.add_node(f"t{i}", labels=gpu_labels(GB200, 4, "u.7"))
            for i in range(2)]
    info = gpu_info_for_node(rack[0])
    assert (info.clique, info.clique_nodes) == ("u.7", NVL72_NODES)
    assert g.group_key(rack[0]) == g.group_key(rack[1]) == "clique/u.7"
    assert g.expected_group_size(rack[1]) == NVL72_NODES
    # a clique of a product whose domain is unknown: observed members only
    other = cluster.add_node("o0", labels=gpu_labels("NVIDIA-X", 8, "v.1"))
    assert g.group_key(other) == "clique/v.1"
    assert g.expected_group_size(other) is None
    cpu = cluster.add_node("cpu0")
    assert gpu_info_for_node(cpu) is None and g.group_key(cpu) == "cpu0"
    bad = cluster.add_node("bad", labels=gpu_labels(count="eight"))
    with pytest.raises(ValueError, match="invalid nvidia.com/gpu.count"):
        gpu_info_for_node(bad)


def test_validate_clique_membership_rejects_partial_view(cluster):
    nodes = [cluster.add_node(f"t{i}", labels=gpu_labels(GB200, 4, "u.1"))
             for i in range(NVL72_NODES - 1)]
    nodes.append(cluster.add_node("h0", labels=gpu_labels()))
    with pytest.raises(ValueError, match="partial clique view"):
        validate_clique_membership(nodes)
    nodes.append(cluster.add_node("t17", labels=gpu_labels(GB200, 4, "u.1")))
    infos = validate_clique_membership(nodes)
    assert list(infos) == ["u.1"]


# ------------------------------------------------- the upgrade state machine

def test_h100_nodes_upgrade_one_by_one_deleting_only_gpu_pods(cluster, keys,
                                                               clock):
    """Four H100 nodes, each its own group, with a job placed by the GPU
    scheduler on all of them and a pod without GPUs beside it: the
    driver rolls node by node within max_parallel_upgrades 1, the
    deletion filter deletes exactly the pods that request GPUs, and every
    node ends done, schedulable, at the new driver."""
    ds = cluster.add_daemonset("nvidia-driver-daemonset", namespace=NS,
                               labels=DRIVER_LABELS, revision_hash="v1")
    nodes = [add_gpu_node(cluster, f"h{i}", ds) for i in range(4)]
    for name in nodes:
        cluster.add_pod(f"log-{name}", name, namespace="default")
    assert GPUScheduler(cluster.client).place(
        GPUWorkload(name="train", product=H100, gpus_per_node=8,
                    num_nodes=4)) is not None
    cluster.bump_daemonset_revision("nvidia-driver-daemonset", NS, "v2")
    policy = DriverUpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=1, max_unavailable="100%",
        pod_deletion=PodDeletionSpec(force=True, timeout_second=60),
        drain=DrainSpec(enable=False))
    most = [0]

    def throttle(states):
        busy = sum(s in UpgradeState.IN_PROGRESS for s, _ in states.values())
        most[0] = max(most[0], busy)
        assert busy <= 1, states

    states = upgrade(cluster, keys, clock, policy, nodes, check=throttle)
    assert most[0] == 1
    assert not any(unsched for _, unsched in states.values())
    pods = cluster.client.direct().list_pods()
    assert not [p for p in pods if gpu_workload_deletion_filter(p)]
    assert sorted(p.metadata.name for p in pods
                  if p.metadata.namespace == "default") == \
        [f"log-{n}" for n in nodes]
    drivers = cluster.client.direct().list_pods(namespace=NS)
    assert sorted(p.metadata.labels["controller-revision-hash"]
                  for p in drivers) == ["v2"] * 4


def test_a_clique_upgrades_atomically_and_waits_for_its_whole_view(
        cluster, keys, clock):
    """A GB200 NVL72 clique (18 nodes of 4 GPUs) whose last node's driver
    pod is not yet seen holds at upgrade-required; once it is, the clique
    cordons together, and no node of it is back in service while another
    is still being upgraded. An H100 node beside it upgrades alone."""
    ds = cluster.add_daemonset("nvidia-driver-daemonset", namespace=NS,
                               labels=DRIVER_LABELS, revision_hash="v1")
    rack = [add_gpu_node(cluster, f"t{i:02d}", ds, product=GB200, count=4,
                         clique="u.3") for i in range(NVL72_NODES - 1)]
    rack.append(add_gpu_node(cluster, "t17", product=GB200, count=4,
                             clique="u.3"))
    solo = add_gpu_node(cluster, "h0", ds)
    cluster.bump_daemonset_revision("nvidia-driver-daemonset", NS, "v2")
    # no throttle: only the clique's incomplete view may hold it
    policy = DriverUpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=0, max_unavailable="100%",
        drain=DrainSpec(enable=True, force=True, timeout_second=60))
    mgr = ClusterUpgradeStateManager(cluster.client, keys, cluster.recorder,
                                     clock, grouper=GPUNodeGrouper(),
                                     synchronous=True)
    for _ in range(5):
        mgr.apply_state(mgr.build_state(NS, DRIVER_LABELS), policy)
        cluster.reconcile_daemonsets()
    for name in rack[:-1]:
        node = cluster.client.direct().get_node(name)
        assert node.metadata.labels.get(keys.state_label) == \
            UpgradeState.UPGRADE_REQUIRED, name
        assert not node.spec.unschedulable
    cluster.add_pod("driver-t17", "t17", namespace=NS, owner_ds=ds,
                    revision_hash="v1")

    def atomic(states):
        inside = [states[n] for n in rack]
        if any(s in (UpgradeState.DRAIN_REQUIRED,
                     UpgradeState.POD_RESTART_REQUIRED) for s, _ in inside):
            assert all(unsched for _, unsched in inside), inside

    states = upgrade(cluster, keys, clock, policy, rack + [solo],
                     deletion=False, check=atomic)
    assert not any(unsched for _, unsched in states.values())


# ----------------------------------------------------------------- scheduler

def h100_fleet(cluster, n, count=8):
    return [add_gpu_node(cluster, f"h{i}", count=count) for i in range(n)]


def test_scheduler_places_one_pod_per_node_requesting_every_gpu(cluster):
    h100_fleet(cluster, 3)
    sched = GPUScheduler(cluster.client)
    placement = sched.place(GPUWorkload(name="train", product=H100,
                                        gpus_per_node=8, num_nodes=2))
    assert placement.node_names == ["h0", "h1"]
    assert placement.pods == ["train-0", "train-1"]
    pod = cluster.client.direct().get_pod("default", "train-1")
    assert pod.spec.resource_requests == {GPU_RESOURCE: 8}
    assert pod.spec.env == {"TPU_WORKER_ID": "1",
                            "TPU_WORKER_HOSTNAMES": "train-0.train,"
                                                    "train-1.train",
                            "JAX_COORDINATOR_ADDRESS": "train-0.train:8476",
                            "LOCAL_WORLD_SIZE": "8"}
    assert (pod.spec.hostname, pod.spec.subdomain) == ("train-1", "train")
    assert pod.metadata.labels[WORKLOAD_LABEL] == "train"
    assert gpu_workload_deletion_filter(pod)
    svc = cluster.get("Service", "default", "train")
    assert svc.spec.cluster_ip == "None"
    assert svc.spec.selector == {WORKLOAD_LABEL: "train"}
    # one node is left: a second two-node job does not fit, a one-node one
    # does, and one of another product or GPU count finds nothing
    assert sched.place(GPUWorkload(name="b", product=H100, gpus_per_node=8,
                                   num_nodes=2)) is None
    assert sched.place(GPUWorkload(name="c", product=H100, gpus_per_node=4,
                                   num_nodes=1)) is None
    assert sched.place(GPUWorkload(name="d", product=H100, gpus_per_node=8)
                       ).node_names == ["h2"]


def test_scheduler_multislice_env(cluster):
    h100_fleet(cluster, 4, count=2)
    GPUScheduler(cluster.client).place(GPUWorkload(
        name="ms", product=H100, gpus_per_node=2, num_nodes=2, num_slices=2))
    env = cluster.client.direct().get_pod("default", "ms-1-0").spec.env
    assert env["TPU_WORKER_HOSTNAMES"] == "ms-1-0.ms,ms-1-1.ms"
    assert env["JAX_COORDINATOR_ADDRESS"] == "ms-0-0.ms:8476"
    assert (env["MEGASCALE_NUM_SLICES"], env["MEGASCALE_SLICE_ID"]) == \
        ("2", "1")
    from k8s_operator_libs_tpu_torch.parallel.distributed import cluster_env
    assert cluster_env(dict(env, LOCAL_RANK="1"))["rank"] == \
        (1 * 2 + 0) * 2 + 1


def test_scheduler_skips_cordoned_busy_and_unready_nodes(cluster):
    h100_fleet(cluster, 4)
    cluster.client.patch_node_unschedulable("h0", True)
    cluster.add_node("h9", labels=gpu_labels(), ready=False)
    cluster.add_pod("other", "h1")
    busy = cluster.get("Pod", "default", "other")
    busy.spec.resource_requests = {GPU_RESOURCE: 1}
    cluster.update(busy)
    cluster.add_pod("done", "h2", phase="Succeeded")
    done = cluster.get("Pod", "default", "done")
    done.spec.resource_requests = {GPU_RESOURCE: 8}
    cluster.update(done)
    cluster.flush_cache()
    sched = GPUScheduler(cluster.client)
    assert [n.metadata.name for n in sched.eligible_nodes(H100, 8)] == \
        ["h2", "h3"]
    assert sched.place(GPUWorkload(name="t", product=H100, gpus_per_node=8,
                                   num_nodes=3)) is None
    assert cluster.client.direct().list_pods(
        label_selector={WORKLOAD_LABEL: "t"}) == []


def test_scheduler_lists_pods_once_per_pass(cluster, monkeypatch):
    h100_fleet(cluster, 6)
    direct = cluster.client.direct()
    counts = {"cluster_wide": 0}
    real = direct.list_pods

    def counting(namespace=None, label_selector=None, **kw):
        if namespace is None and label_selector is None:
            counts["cluster_wide"] += 1
        return real(namespace=namespace, label_selector=label_selector, **kw)

    monkeypatch.setattr(direct, "list_pods", counting)
    sched = GPUScheduler(cluster.client)
    assert len(sched.eligible_nodes(H100, 8)) == 6
    assert counts["cluster_wide"] == 1
    counts["cluster_wide"] = 0
    assert sched.place(GPUWorkload(name="t", product=H100, gpus_per_node=8,
                                   num_nodes=3)) is not None
    assert counts["cluster_wide"] == 1
    # every node cordoned (a rolling upgrade): no pod LIST at all
    for i in range(6):
        cluster.client.patch_node_unschedulable(f"h{i}", True)
    cluster.flush_cache()
    counts["cluster_wide"] = 0
    assert sched.eligible_nodes(H100, 8) == []
    assert counts["cluster_wide"] == 0


def test_scheduler_adopts_a_full_set_and_cleans_a_partial_one(cluster):
    h100_fleet(cluster, 12)
    sched = GPUScheduler(cluster.client)
    wl = GPUWorkload(name="t", product=H100, gpus_per_node=8, num_nodes=11)
    first = sched.place(wl)
    assert first.pods[-2:] == ["t-9", "t-10"]
    again = sched.place(wl)            # an operator restart resubmits it
    assert (again.pods, again.node_names) == (first.pods, first.node_names)
    cluster.client.delete_pod("default", "t-3")
    cluster.flush_cache()
    assert sched.place(wl) is None     # debris: cleaned, not adopted
    assert cluster.client.direct().list_pods(
        label_selector={WORKLOAD_LABEL: "t"}) == []
    assert sched.place(wl).pods == first.pods


def test_scheduler_rolls_back_a_failed_create(cluster, monkeypatch):
    h100_fleet(cluster, 3)
    created = []
    real = cluster.client.create_pod

    def failing(pod):
        if len(created) == 2:
            raise RuntimeError("apiserver unavailable")
        created.append(pod.metadata.name)
        return real(pod)

    monkeypatch.setattr(cluster.client, "create_pod", failing)
    sched = GPUScheduler(cluster.client)
    wl = GPUWorkload(name="t", product=H100, gpus_per_node=8, num_nodes=3)
    assert sched.place(wl) is None
    assert created == ["t-0", "t-1"]
    assert cluster.client.direct().list_pods(
        label_selector={WORKLOAD_LABEL: "t"}) == []


# ------------------------------------------- the env -> one rank per GPU

def test_placed_env_gives_one_rank_per_gpu_on_gloo(cluster, tmp_path):
    """2 nodes x 2 GPUs: the placed pods' env, each pod starting 2
    processes with LOCAL_RANK 0 and 1, joins one gloo group of 4 ranks
    through ``cluster_env``; an all-reduce of the ranks sums 0+1+2+3. The
    coordinator is the placed one with its DNS name swapped for
    localhost: no cluster DNS here."""
    h100_fleet(cluster, 2, count=2)
    GPUScheduler(cluster.client).place(GPUWorkload(
        name="job", product=H100, gpus_per_node=2, num_nodes=2))
    port = launch._free_port()
    envs = []
    for pod in cluster.client.direct().list_pods(
            label_selector={WORKLOAD_LABEL: "job"}):
        env = dict(pod.spec.env)
        assert env["JAX_COORDINATOR_ADDRESS"] == "job-0.job:8476"
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        for local in range(int(env["LOCAL_WORLD_SIZE"])):
            envs.append(dict(env, LOCAL_RANK=str(local)))
    results = launch.run_placed(ranks.placed_member, envs, timeout=120.0,
                                workdir=str(tmp_path))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    assert all(r["world"] == 4 and r["sum"] == 6.0 for r in results)


def test_gpu_twins_and_tp_decode_import_no_jax():
    """Imported alone, the GPU twins, tensor-parallel decoding and the
    launcher load nothing of JAX or the JAX package."""
    code = ("import sys\n"
            "import k8s_operator_libs_tpu_torch.gpu\n"
            "import k8s_operator_libs_tpu_torch.models.generate\n"
            "import k8s_operator_libs_tpu_torch.parallel.launch\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'k8s_operator_libs_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
