"""Minimal typed Kubernetes object model (a copy of the JAX package's
``core/objects.py``).

Only the kinds and fields the operator libraries touch are modelled:
Node, Pod, DaemonSet, ControllerRevision, Job, Service, Lease and Event.
Field names map one-to-one onto client-go's (``node.spec.unschedulable``,
``pod.status.phase``, ...). :mod:`.serde` converts them to and from the
apiserver's JSON, and :class:`~.liveclient.LiveClient` returns them.
Objects are plain mutable dataclasses.
"""

from __future__ import annotations

import copy
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    """metav1.OwnerReference — only what getPodsOwnedbyDs / getOrphanedPods
    need (reference pkg/upgrade/upgrade_state.go:320-355)."""

    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = True


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_new_uid)
    resource_version: str = "0"
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    generation: int = 1


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List["Taint"] = field(default_factory=list)


@dataclass
class NodeCondition:
    type: str = "Ready"
    status: str = "True"  # "True" | "False" | "Unknown"


@dataclass
class NodeStatus:
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=lambda: NodeStatus(
        conditions=[NodeCondition(type="Ready", status="True")]))

    kind: str = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name

    def is_ready(self) -> bool:
        """Mirrors isNodeUnschedulable/isNodeConditionReady used by
        GetCurrentUnavailableNodes (reference pkg/upgrade/upgrade_state.go:192-211)."""
        for c in self.status.conditions:
            if c.type == "Ready":
                return c.status == "True"
        return False


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerStatus:
    name: str = "main"
    ready: bool = False
    restart_count: int = 0


@dataclass
class PodCondition:
    type: str = "Ready"
    status: str = "False"


@dataclass
class Volume:
    name: str = "v"
    empty_dir: bool = False


@dataclass
class PodSpec:
    node_name: str = ""
    volumes: List[Volume] = field(default_factory=list)
    termination_grace_period_seconds: Optional[int] = None
    # summed container resource requests, e.g. {"google.com/tpu": 4}
    resource_requests: Dict[str, int] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    # hostname + subdomain make the pod DNS-resolvable as
    # <hostname>.<subdomain> through a headless Service named <subdomain>
    # (the JAX/MEGASCALE coordinator address must resolve cluster-wide)
    hostname: str = ""
    subdomain: str = ""


@dataclass
class PodStatus:
    phase: str = "Running"  # Pending | Running | Succeeded | Failed | Unknown
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    init_container_statuses: List[ContainerStatus] = field(default_factory=list)
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind: str = "Pod"

    @property
    def name(self) -> str:
        return self.metadata.name

    def controller_owner(self) -> Optional[OwnerReference]:
        for ref in self.metadata.owner_references:
            if ref.controller:
                return ref
        return None

    def is_ready(self) -> bool:
        """Pod readiness as the reference checks it: the Ready pod condition
        (reference pkg/upgrade/validation_manager.go:118-136)."""
        for c in self.status.conditions:
            if c.type == "Ready":
                return c.status == "True"
        return False


# ---------------------------------------------------------------------------
# DaemonSet + ControllerRevision
# ---------------------------------------------------------------------------


@dataclass
class DaemonSetStatus:
    desired_number_scheduled: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)

    kind: str = "DaemonSet"

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ControllerRevision:
    """apps/v1 ControllerRevision. The reference finds a DaemonSet's current
    template hash by listing revisions owned by the DS and taking the highest
    ``revision`` (reference pkg/upgrade/pod_manager.go:95-121)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    revision: int = 1

    kind: str = "ControllerRevision"


# ---------------------------------------------------------------------------
# Job (wait-for-completion checks target arbitrary workload pods; Jobs appear
# in reference tests — upgrade_suit_test.go:419-453)
# ---------------------------------------------------------------------------


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: JobStatus = field(default_factory=JobStatus)

    kind: str = "Job"


# ---------------------------------------------------------------------------
# Service (headless Services give workload pods stable DNS names — the JAX /
# MEGASCALE coordinator address must resolve across the cluster)
# ---------------------------------------------------------------------------


@dataclass
class ServicePort:
    # k8s requires NAMED ports whenever a Service has more than one
    name: str = ""
    port: int = 0


@dataclass
class ServiceSpec:
    cluster_ip: str = ""          # "None" == headless
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)

    kind: str = "Service"

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Lease (coordination.k8s.io/v1) — leader election for HA operator
# deployments (the reference's consumers get this from controller-runtime;
# our deployable binary implements it against this object)
# ---------------------------------------------------------------------------


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: Optional[float] = None   # epoch seconds
    renew_time: Optional[float] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)

    kind: str = "Lease"

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Event
# ---------------------------------------------------------------------------


@dataclass
class Event:
    """A recorded k8s Event (reference util.go:141-153 emits warning/normal
    events with reason ``<DRIVER>DriverUpgrade``)."""

    object_kind: str = ""
    object_name: str = ""
    event_type: str = "Normal"  # Normal | Warning
    reason: str = ""
    message: str = ""


def deep_copy(obj):
    """DeepCopy, k8s-style. Every API round-trip copies."""
    return copy.deepcopy(obj)
