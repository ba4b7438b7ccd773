"""Replay a canned fault-injection scenario on the fake cluster (the GPU
twin of the JAX package's ``tools/health_sim.py``).

``python -m k8s_operator_libs_tpu_torch.health.sim``: the health
subsystem's story end to end and offline. A GB200 NVLink clique of four
nodes plus two healthy H100 nodes in no clique run the NVIDIA driver
DaemonSet; the driver pod on one clique node starts crash-looping, and
the whole detect -> quarantine -> clique-atomic repair (through the
upgrade pipeline) -> recover loop runs under :class:`GPUOperator` on
:class:`FakeCluster` and :class:`FakeClock`. It prints a timeline of
verdict, quarantine and upgrade-state transitions, and exits 0 only if
the clique converges back to schedulable and healthy with the driver
pod recreated.
"""

from __future__ import annotations

import sys

from ..api.v1alpha1 import DrainSpec, DriverUpgradePolicySpec
from ..core.fakecluster import FakeCluster
from ..gpu.operator import GPUOperator, ManagedComponent
from ..gpu.topology import (CLIQUE_LABEL, COUNT_LABEL, NVLINK_DOMAIN_GPUS,
                            PRODUCT_LABEL)
from ..upgrade.util import KeyFactory
from ..utils.clock import FakeClock
from . import consts as hconsts
from .classifier import ClassifierConfig
from .monitor import HealthOptions
from .remediation import RemediationPolicy

NS = "gpu-operator"
COMPONENT = "gpu"
DRIVER_DS = "nvidia-driver-daemonset"
TICK = 15.0  # modelled seconds between reconcile ticks
# the clique's four nodes: GPUs per node such that the product's NVLink
# domain holds exactly four, so the clique is admitted only whole
CLIQUE_PRODUCT = "NVIDIA-GB200"
CLIQUE_NODES = 4
CLIQUE_GPUS = NVLINK_DOMAIN_GPUS[CLIQUE_PRODUCT] // CLIQUE_NODES
SOLO_PRODUCT, SOLO_GPUS = "NVIDIA-H100-80GB-HBM3", 8


def build_fleet(cluster):
    clique_labels = {PRODUCT_LABEL: CLIQUE_PRODUCT,
                     COUNT_LABEL: str(CLIQUE_GPUS),
                     CLIQUE_LABEL: "u.pool-a"}
    ds = cluster.add_daemonset(DRIVER_DS, namespace=NS,
                               labels={"app": DRIVER_DS},
                               revision_hash="v1")
    hosts = [f"pool-a-h{i}" for i in range(CLIQUE_NODES)]
    for h in hosts:
        cluster.add_node(h, labels=clique_labels)
        cluster.add_pod(f"driver-{h}", h, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
    for name in ("solo-0", "solo-1"):
        cluster.add_node(name, labels={PRODUCT_LABEL: SOLO_PRODUCT,
                                       COUNT_LABEL: str(SOLO_GPUS)})
        cluster.add_pod(f"driver-{name}", name, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
    return hosts


def main() -> int:
    clock = FakeClock()
    cluster = FakeCluster(clock=clock, cache_lag=0.5)
    build_fleet(cluster)
    keys = KeyFactory(COMPONENT)

    op = GPUOperator(
        cluster.client,
        components=[ManagedComponent(
            name=COMPONENT, namespace=NS,
            driver_labels={"app": DRIVER_DS},
            policy=DriverUpgradePolicySpec(
                auto_upgrade=True, max_parallel_upgrades=0,
                max_unavailable="100%",
                drain=DrainSpec(enable=True, force=True,
                                timeout_second=60)))],
        recorder=cluster.recorder, clock=clock, synchronous=True,
        health=HealthOptions(
            classifier=ClassifierConfig(damping_seconds=30.0,
                                        persist_seconds=60.0),
            policy=RemediationPolicy(recovery_seconds=45.0,
                                     backoff_base_seconds=60.0)))

    def snapshot():
        nodes = {n.metadata.name: n
                 for n in cluster.client.direct().list_nodes()}
        return {h: (nodes[h].metadata.labels.get(hconsts.VERDICT_LABEL)
                    or nodes[h].metadata.labels.get(hconsts.QUARANTINE_LABEL)
                    or "healthy",
                    "Q" if hconsts.QUARANTINE_LABEL
                    in nodes[h].metadata.labels else "-",
                    nodes[h].metadata.labels.get(keys.state_label, "") or "-",
                    "cordoned" if nodes[h].spec.unschedulable else "open")
                for h in sorted(nodes)}

    print("== fault injection: driver-pool-a-h0 starts crash-looping ==")
    cluster.set_pod_status(NS, "driver-pool-a-h0", ready=False,
                           restart_count=12)

    last = None
    quarantined_seen = repaired_seen = False
    for tick in range(120):
        op.reconcile()
        cluster.reconcile_daemonsets()
        state = snapshot()
        if state != last:
            print(f"t={clock.now():7.1f}s")
            for node, row in state.items():
                print(f"   {node:12s} verdict={row[0]:22s} {row[1]:2s} "
                      f"upgrade={row[2]:22s} {row[3]}")
            last = state
        report = op.last_health
        if report and report.quarantined_slices:
            quarantined_seen = True
        if report and report.actions.driver_pods_restarted:
            repaired_seen = True
            print(f"t={clock.now():7.1f}s    driver pods restarted: "
                  f"{report.actions.driver_pods_restarted}")
        nodes = cluster.client.direct().list_nodes()
        done = all(
            not n.spec.unschedulable
            and hconsts.QUARANTINE_LABEL not in n.metadata.labels
            for n in nodes)
        if quarantined_seen and repaired_seen and done:
            pods = cluster.client.direct().list_pods(namespace=NS)
            ready = all(cs.ready for p in pods
                        for cs in p.status.container_statuses)
            print(f"\n== converged at t={clock.now():.1f}s: clique "
                  f"quarantined, repaired clique-atomically, uncordoned; "
                  f"{len(pods)} driver pods, all ready={ready} ==")
            return 0 if ready else 1
        clock.advance(TICK)
    print("\n== FAILED to converge ==", file=sys.stderr)
    print(f"quarantined_seen={quarantined_seen} "
          f"repaired_seen={repaired_seen}", file=sys.stderr)
    for node, row in snapshot().items():
        print(f"   {node}: {row}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
