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
- a slice's nodes share one interconnect domain, as the reference places
  a multi-host job inside one whole ICI slice: nodes that carry a clique
  label (a multi-node NVLink domain, GB200 NVL72) give a slice only
  nodes of one clique, while nodes without one (an H100 HGX node, whose
  NVLink ends at the node) form one pool joined by the data-centre
  network, from which a slice takes any nodes. A slice never mixes two
  cliques, nor a clique with the pool; domains are taken in the order of
  their first node's name, nodes in name order;
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
are the port's object model (``core/objects.py``). A successful bind is
timed into the hub's ``placement_latency_seconds`` (labelled by the GPU
product), as the reference's scheduler times it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

from ..core.objects import (ObjectMeta, Pod, Service, ServicePort,
                            ServiceSpec)
from ..utils.clock import Clock, RealClock
from ..wire import WORKLOAD_LABEL
from .device_plugin import GPU_RESOURCE, pod_requests_gpu
from .topology import gpu_info_for_node

logger = logging.getLogger(__name__)

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
    # each slice's interconnect domain: ``clique/<id>``, or for a slice of
    # nodes without a clique its node names joined by ","
    slice_ids: List[str] = dataclasses.field(default_factory=list)

    @property
    def slice_id(self) -> str:
        """The first slice's domain (the reference's field)."""
        return self.slice_ids[0] if self.slice_ids else ""


def _domain(node) -> str:
    """A node's interconnect domain: ``clique/<id>``, or "" for a node
    without a clique (the pool joined by the data-centre network)."""
    info = gpu_info_for_node(node)
    return f"clique/{info.clique}" if info and info.multi_node else ""


def _slice_id(nodes) -> str:
    return _domain(nodes[0]) or ",".join(n.metadata.name for n in nodes)


class GPUScheduler:
    def __init__(self, client, metrics=None,
                 clock: Optional[Clock] = None):
        self._client = client
        self._metrics = metrics  # MetricsHub for placement_latency_seconds
        self._clock = clock or RealClock()

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

    def _choose(self, workload: GPUWorkload, nodes: List) -> Optional[List]:
        """The nodes of each slice, in slice order, from ``nodes`` (the
        eligible ones, by name): each slice takes the first domain that
        still has ``num_nodes`` free nodes. None when a slice finds no
        such domain."""
        domains: Dict[str, List] = {}
        for node in nodes:
            domains.setdefault(_domain(node), []).append(node)
        free = list(domains.values())
        chosen = []
        for _ in range(workload.num_slices):
            home = next((d for d in free if len(d) >= workload.num_nodes),
                        None)
            if home is None:
                return None
            chosen.append(home[:workload.num_nodes])
            del home[:workload.num_nodes]
        return chosen

    def place(self, workload: GPUWorkload) -> Optional[Placement]:
        """Bind the workload to its nodes, all or nothing; None when not
        enough nodes are free (the caller requeues)."""
        t0 = self._clock.now()
        placement = self._place(workload)
        if placement is not None and self._metrics is not None:
            # latency of a successful bind (inventory LISTs + pod
            # creates); a pass that finds no room is not latency
            self._metrics.observe(
                "placement_latency_seconds",
                max(0.0, self._clock.now() - t0),
                labels={"accelerator": workload.product})
        return placement

    def _place(self, workload: GPUWorkload) -> Optional[Placement]:
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
        slices = (self._choose(workload, nodes) if len(nodes) >= expected
                  else None)
        if slices is None:
            logger.info("need %d x %d free %s nodes with %d GPUs, each "
                        "slice in one interconnect domain, for workload "
                        "%s; have %d", workload.num_slices,
                        workload.num_nodes, workload.product,
                        workload.gpus_per_node, workload.name, len(nodes))
            return None
        self._ensure_headless_service(workload)
        pods = self._pods(workload, [n for s in slices for n in s])
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
                         pods=[p.metadata.name for p in created],
                         slice_ids=[_slice_id(s) for s in slices])

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
        by_name = {n.metadata.name: n
                   for n in self._client.direct().list_nodes()}
        nodes = [by_name.get(p.spec.node_name) for p in pods]
        per = max(1, workload.num_nodes)
        slice_ids = [_slice_id(chunk) for chunk in
                     (nodes[i:i + per] for i in range(0, len(nodes), per))
                     if None not in chunk]
        return Placement(workload=workload.name,
                         node_names=[p.spec.node_name for p in pods],
                         pods=[p.metadata.name for p in pods],
                         slice_ids=slice_ids)

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
