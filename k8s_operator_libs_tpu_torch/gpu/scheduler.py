"""Thin GPU scheduler: place a PyTorch job onto whole GPU nodes, one rank
per GPU.

GPU twin of the JAX package's ``tpu/scheduler.py`` (``SliceScheduler``),
with its placement contract:

- a workload names a GPU product, the GPUs each node must have, and how
  many nodes (``num_nodes`` per slice, ``num_slices`` slices);
- a node is eligible when GFD's labels (``gpu/topology.py``) match, it is
  Ready and schedulable (so nodes mid-upgrade, cordoned by the state
  machine, are excluded) and no live pod on it requests a GPU; the busy
  nodes come from one pod LIST per pass, made only when a node survives
  the cheap filters;
- placement is all-or-nothing: one pod per node, requesting every GPU of
  the node (``nvidia.com/gpu``, so the upgrade library's
  ``gpu_workload_deletion_filter`` sees exactly these pods), behind a
  headless Service named after the workload; a full existing pod set is
  adopted, a partial one cleaned up, and a failed create rolled back.

Each pod's env carries the host-level keys the port's
``parallel/distributed.py:cluster_env`` reads (``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES``, ``JAX_COORDINATOR_ADDRESS`` behind the Service,
and over several slices ``MEGASCALE_NUM_SLICES``/``MEGASCALE_SLICE_ID``)
plus ``LOCAL_WORLD_SIZE``, the node's GPUs: the pod starts that many
processes, each with its ``LOCAL_RANK`` (``torchrun --nproc-per-node``),
and ``cluster_env`` makes them ranks ``(slice x nodes + worker) x GPUs +
LOCAL_RANK`` of one group. Where the reference's one process per host
drives every chip, here every GPU is a rank.

Nodes and pods are read by attribute, and the client is duck-typed
(``direct()``, ``list_nodes``, ``list_pods``, ``create_pod``,
``create_service``, ``delete_pod``); the pods and the Service it creates
are the port's object model (``core/objects.py``). Placement ignores
cliques: a slice is any eligible nodes, in name order.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

from ..core.objects import (ObjectMeta, Pod, PodSpec, Service, ServicePort,
                            ServiceSpec)
from .device_plugin import GPU_RESOURCE, pod_requests_gpu
from .topology import gpu_info_for_node

logger = logging.getLogger(__name__)

# the operator's workload label (the JAX package's ``wire.py``), so its
# tooling sees these pods as it sees the TPU scheduler's
WORKLOAD_LABEL = "tpu.dev/workload"
COORDINATOR_PORT = 8476
MEGASCALE_PORT = 8080


def _is_conflict(exc: Exception) -> bool:
    """The client's 409 (its ``ConflictError``, known here by name: the
    port imports no client library)."""
    return any(c.__name__ == "ConflictError" for c in type(exc).__mro__)


# ------------------------------------------------------------ scheduling

@dataclasses.dataclass
class GPUWorkload:
    """A PyTorch job wanting ``num_slices`` x ``num_nodes`` whole nodes
    of ``product`` with ``gpus_per_node`` GPUs each, one rank per GPU."""

    name: str
    product: str                # GFD's nvidia.com/gpu.product
    gpus_per_node: int          # GFD's nvidia.com/gpu.count
    num_nodes: int = 1          # nodes per slice
    namespace: str = "default"
    num_slices: int = 1
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    env: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Placement:
    workload: str
    node_names: List[str]
    pods: List[str]


class GPUScheduler:
    def __init__(self, client):
        self._client = client

    # -- inventory ----------------------------------------------------------

    def eligible_nodes(self, product: str, gpus: int) -> List:
        """Every Ready, schedulable node of ``product`` with ``gpus``
        GPUs that no live GPU pod holds, by name. Reads are direct
        (uncached): a cached list can miss a pod just placed and
        double-allocate its GPUs."""
        candidates = []
        for node in self._client.direct().list_nodes():
            info = gpu_info_for_node(node)
            if info is None or info.product != product or info.gpus != gpus:
                continue
            if node.spec.unschedulable or not node.is_ready():
                continue          # cordoned or degraded, e.g. mid-upgrade
            candidates.append(node)
        if not candidates:
            return []             # no pod LIST where nothing could fit
        busy = self._gpu_busy_nodes()
        return sorted((n for n in candidates if n.metadata.name not in busy),
                      key=lambda n: n.metadata.name)

    def _gpu_busy_nodes(self) -> set:
        """Nodes hosting a live GPU-requesting pod, from ONE cluster-wide
        pod LIST."""
        return {p.spec.node_name
                for p in self._client.direct().list_pods()
                if p.spec.node_name and pod_requests_gpu(p)
                and p.status.phase in ("Running", "Pending")}

    # -- placement ----------------------------------------------------------

    def place(self, workload: GPUWorkload) -> Optional[Placement]:
        """Bind the workload to its nodes, all or nothing; None when not
        enough nodes are free (the caller requeues)."""
        if workload.num_slices < 1 or workload.num_nodes < 1:
            raise ValueError(f"workload {workload.name}: num_slices and "
                             f"num_nodes must be >= 1")
        expected = workload.num_slices * workload.num_nodes
        # a full labelled set is a live placement (adopt it); a partial one
        # the debris of a crashed attempt (clean it up for the next pass)
        existing = self._client.direct().list_pods(
            namespace=workload.namespace,
            label_selector={WORKLOAD_LABEL: workload.name})
        if len(existing) >= expected:
            logger.info("workload %s already has %d/%d pods; adopting the "
                        "existing placement", workload.name, len(existing),
                        expected)
            self._ensure_headless_service(workload)
            return self._adopt_placement(workload, existing)
        if existing:
            logger.warning("workload %s has a partial pod set (%d/%d); "
                           "cleaning up for a fresh placement next pass",
                           workload.name, len(existing), expected)
            self._delete_pods(existing, "cleanup")
            return None
        nodes = self.eligible_nodes(workload.product, workload.gpus_per_node)
        if len(nodes) < expected:
            logger.info("need %d free %s nodes with %d GPUs for workload "
                        "%s, have %d", expected, workload.product,
                        workload.gpus_per_node, workload.name, len(nodes))
            return None
        self._ensure_headless_service(workload)
        pods = self._pods(workload, nodes[:expected])
        created = []
        try:
            for p in pods:
                created.append(self._create_pod(p))
        except NotImplementedError:
            raise             # a misconfigured client, never retryable
        except Exception:  # exc: allow — any failure mid-placement rolls back the pods created so far and reports no placement
            logger.exception("placement of %s failed after %d/%d pods; "
                             "rolling back", workload.name, len(created),
                             len(pods))
            self._delete_pods(created, "rollback")
            return None
        return Placement(workload=workload.name,
                         node_names=[p.spec.node_name for p in created],
                         pods=[p.metadata.name for p in created])

    def _pods(self, workload: GPUWorkload, nodes) -> List[Pod]:
        """One pod per node: slice s's are ``<name>-<s>-<worker>`` over
        several slices, ``<name>-<worker>`` over one; slice 0's worker 0
        serves the rendezvous."""
        multi = workload.num_slices > 1
        name = workload.name
        coordinator = (f"{name}-0-0" if multi else f"{name}-0") + f".{name}"
        pods = []
        for s in range(workload.num_slices):
            members = nodes[s * workload.num_nodes:
                            (s + 1) * workload.num_nodes]
            prefix = f"{name}-{s}" if multi else name
            hostnames = ",".join(f"{prefix}-{i}.{name}"
                                 for i in range(len(members)))
            for worker, node in enumerate(members):
                pod = Pod(metadata=ObjectMeta(
                    name=f"{prefix}-{worker}", namespace=workload.namespace,
                    labels={**workload.labels, WORKLOAD_LABEL: name}))
                pod.spec.node_name = node.metadata.name
                pod.spec.hostname = f"{prefix}-{worker}"
                pod.spec.subdomain = name
                pod.spec.resource_requests = {
                    GPU_RESOURCE: workload.gpus_per_node}
                env = {**workload.env,
                       "TPU_WORKER_ID": str(worker),
                       "TPU_WORKER_HOSTNAMES": hostnames,
                       "JAX_COORDINATOR_ADDRESS":
                           f"{coordinator}:{COORDINATOR_PORT}",
                       "LOCAL_WORLD_SIZE": str(workload.gpus_per_node)}
                if multi:
                    env.update({
                        "MEGASCALE_NUM_SLICES": str(workload.num_slices),
                        "MEGASCALE_SLICE_ID": str(s),
                        "MEGASCALE_COORDINATOR_ADDRESS":
                            f"{coordinator}:{MEGASCALE_PORT}"})
                pod.spec.env = env
                pods.append(pod)
        return pods

    def _adopt_placement(self, workload: GPUWorkload,
                         existing: List) -> Placement:
        """The Placement a full existing pod set stands for, in creation
        order: by the numbers in the names ("w-10" after "w-2")."""
        def order(p):
            return tuple(int(x) for x in p.metadata.name.rsplit("-", 2)[1:]
                         if x.isdigit())
        pods = sorted(existing, key=lambda p: (order(p), p.metadata.name))
        return Placement(workload=workload.name,
                         node_names=[p.spec.node_name for p in pods],
                         pods=[p.metadata.name for p in pods])

    def _ensure_headless_service(self, workload: GPUWorkload) -> None:
        """Create (idempotently) the headless Service named after the
        workload, so each pod resolves as ``<pod>.<workload>`` and the
        coordinator address is a DNS name on a real cluster."""
        svc = Service(
            metadata=ObjectMeta(name=workload.name,
                                namespace=workload.namespace,
                                labels={WORKLOAD_LABEL: workload.name}),
            spec=ServiceSpec(cluster_ip="None",
                             selector={WORKLOAD_LABEL: workload.name},
                             ports=[ServicePort(name="coordinator",
                                                port=COORDINATOR_PORT),
                                    ServicePort(name="megascale",
                                                port=MEGASCALE_PORT)]))
        create = (getattr(self._client, "create_service", None)
                  or getattr(self._client.direct(), "create_service", None))
        if create is None:
            logger.warning("client cannot create Services; coordinator DNS "
                           "for workload %s needs a headless Service named "
                           "%r", workload.name, workload.name)
            return
        try:
            create(svc)
        except RuntimeError as exc:
            if not _is_conflict(exc):
                raise         # it exists already: nothing to do otherwise

    def _delete_pods(self, pods, why: str) -> None:
        for p in pods:
            try:
                self._client.delete_pod(p.metadata.namespace,
                                        p.metadata.name)
            except (RuntimeError, KeyError, TimeoutError):
                logger.warning("%s: could not delete %s/%s", why,
                               p.metadata.namespace, p.metadata.name)

    def _create_pod(self, pod: Pod):
        create = (getattr(self._client, "create_pod", None)
                  or getattr(self._client.direct(), "create_pod", None))
        if create is None:
            raise NotImplementedError("client does not support pod creation")
        return create(pod)
