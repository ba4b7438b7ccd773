"""Kubernetes JSON to object model and back (a copy of the JAX
package's ``core/serde.py``).

The object model (:mod:`.objects`) keeps Go-style snake_case fields; the
Kubernetes REST API speaks camelCase JSON. :mod:`.liveclient` parses
apiserver responses with it, and an apiserver stand-in (a test's, or
``chip_smoke.py``'s) writes its nodes with it, so both sides of the wire
agree on every field. Only the fields the libraries read are mapped;
unknown fields in incoming JSON are ignored, as client-go does.
"""

from __future__ import annotations

import calendar
import time
from typing import Dict, List, Optional

from ..utils.clock import Clock, RealClock

from .objects import (ContainerStatus, ControllerRevision, DaemonSet,
                      DaemonSetStatus, Job, JobStatus, Lease, LeaseSpec, Node,
                      NodeCondition, NodeSpec, NodeStatus, ObjectMeta,
                      OwnerReference, Pod, PodCondition, PodSpec, PodStatus,
                      Service, ServicePort, ServiceSpec, Taint, Volume)

RFC3339 = "%Y-%m-%dT%H:%M:%SZ"

# The creationTimestamp fallback clock (a real apiserver always sends the
# field; synthetic payloads may not). Injectable so a FakeClock-driven
# harness parses to deterministic metadata.
_clock: Clock = RealClock()


def set_default_clock(clock: Clock) -> Clock:
    """Swap the module's fallback clock (tests); returns
    the previous one so callers can restore it."""
    global _clock
    prev, _clock = _clock, clock
    return prev


def _ts_to_rfc3339(ts: Optional[float]) -> Optional[str]:
    if ts is None:
        return None
    return time.strftime(RFC3339, time.gmtime(ts))


def _ts_to_rfc3339_micro(ts: Optional[float]) -> Optional[str]:
    """RFC3339Micro — exactly six fractional digits. coordination.k8s.io/v1
    declares Lease acquireTime/renewTime as metav1.MicroTime, which a real
    apiserver parses STRICTLY in this format; second-precision values get
    HTTP 400 ('cannot parse "Z" as ".000000"')."""
    if ts is None:
        return None
    # integer microseconds with carry: round(.9999996s) must roll into the
    # seconds, not wrap to .000000 of the PREVIOUS second
    sec, usec = divmod(round(ts * 1_000_000), 1_000_000)
    return (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(sec))
            + ".%06dZ" % usec)


def _rfc3339_to_ts(s: Optional[str]) -> Optional[float]:
    if not s:
        return None
    try:
        # calendar.timegm, NOT mktime: the timestamp is UTC and mktime would
        # apply the local (possibly DST-shifted) offset
        ts = float(calendar.timegm(time.strptime(s[:19] + "Z", RFC3339)))
    except ValueError:
        return None
    # preserve fractional seconds (MicroTime round-trip fidelity)
    if len(s) > 19 and s[19] == ".":
        frac = s[20:].rstrip("Zz")
        if frac.isdigit():
            ts += int(frac) / (10.0 ** len(frac))
    return ts


# ------------------------------------------------------------------ meta

def meta_to_json(m: ObjectMeta) -> Dict:
    out: Dict = {"name": m.name, "uid": m.uid,
                 "resourceVersion": m.resource_version,
                 "generation": m.generation,
                 "creationTimestamp": _ts_to_rfc3339(m.creation_timestamp)}
    if m.namespace:
        out["namespace"] = m.namespace
    if m.labels:
        out["labels"] = dict(m.labels)
    if m.annotations:
        out["annotations"] = dict(m.annotations)
    if m.owner_references:
        out["ownerReferences"] = [
            {"kind": o.kind, "name": o.name, "uid": o.uid,
             "controller": o.controller, "apiVersion": "apps/v1"}
            for o in m.owner_references]
    if m.deletion_timestamp is not None:
        out["deletionTimestamp"] = _ts_to_rfc3339(m.deletion_timestamp)
    return out


def meta_from_json(j: Dict) -> ObjectMeta:
    return ObjectMeta(
        name=j.get("name", ""),
        namespace=j.get("namespace", ""),
        labels=dict(j.get("labels") or {}),
        annotations=dict(j.get("annotations") or {}),
        uid=j.get("uid", ""),
        resource_version=j.get("resourceVersion", "0"),
        owner_references=[
            OwnerReference(kind=o.get("kind", ""), name=o.get("name", ""),
                           uid=o.get("uid", ""),
                           controller=bool(o.get("controller", False)))
            for o in j.get("ownerReferences") or []],
        creation_timestamp=_rfc3339_to_ts(j.get("creationTimestamp"))
        or _clock.wall(),
        deletion_timestamp=_rfc3339_to_ts(j.get("deletionTimestamp")),
        generation=j.get("generation", 1),
    )


# ------------------------------------------------------------------ node

def node_to_json(n: Node) -> Dict:
    spec: Dict = {"unschedulable": n.spec.unschedulable}
    if n.spec.taints:  # real apiserver omits the field when empty
        spec["taints"] = [{"key": t.key, "value": t.value,
                           "effect": t.effect} for t in n.spec.taints]
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": meta_to_json(n.metadata),
        "spec": spec,
        "status": {"conditions": [{"type": c.type, "status": c.status}
                                  for c in n.status.conditions]},
    }


def node_from_json(j: Dict) -> Node:
    spec_j = j.get("spec") or {}
    return Node(
        metadata=meta_from_json(j.get("metadata") or {}),
        spec=NodeSpec(
            unschedulable=bool(spec_j.get("unschedulable", False)),
            taints=[Taint(key=t.get("key", ""), value=t.get("value", ""),
                          effect=t.get("effect", ""))
                    for t in spec_j.get("taints") or []]),
        status=NodeStatus(conditions=[
            NodeCondition(type=c.get("type", ""), status=c.get("status", ""))
            for c in (j.get("status") or {}).get("conditions") or []]),
    )


# ------------------------------------------------------------------- pod

def pod_to_json(p: Pod) -> Dict:
    container: Dict = {"name": "main"}
    if p.spec.resource_requests:
        container["resources"] = {"requests": {
            k: str(v) for k, v in p.spec.resource_requests.items()}}
    if p.spec.env:
        container["env"] = [{"name": k, "value": v}
                            for k, v in p.spec.env.items()]
    spec: Dict = {"nodeName": p.spec.node_name, "containers": [container]}
    if p.spec.hostname:
        spec["hostname"] = p.spec.hostname
    if p.spec.subdomain:
        spec["subdomain"] = p.spec.subdomain
    if p.spec.termination_grace_period_seconds is not None:
        spec["terminationGracePeriodSeconds"] = (
            p.spec.termination_grace_period_seconds)
    if p.spec.volumes:
        spec["volumes"] = [
            {"name": v.name, **({"emptyDir": {}} if v.empty_dir else {})}
            for v in p.spec.volumes]
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": meta_to_json(p.metadata),
        "spec": spec,
        "status": {
            "phase": p.status.phase,
            "containerStatuses": [_cs_to_json(c)
                                  for c in p.status.container_statuses],
            "initContainerStatuses": [
                _cs_to_json(c) for c in p.status.init_container_statuses],
            "conditions": [{"type": c.type, "status": c.status}
                           for c in p.status.conditions],
        },
    }


def _cs_to_json(c: ContainerStatus) -> Dict:
    return {"name": c.name, "ready": c.ready, "restartCount": c.restart_count}


def _cs_from_json(j: Dict) -> ContainerStatus:
    return ContainerStatus(name=j.get("name", ""),
                           ready=bool(j.get("ready", False)),
                           restart_count=int(j.get("restartCount", 0)))


def _parse_quantity(q) -> int:
    """k8s resource quantity → int (TPU/GPU device counts are integers)."""
    try:
        return int(str(q))
    except ValueError:
        return 0


def pod_from_json(j: Dict) -> Pod:
    spec_j = j.get("spec") or {}
    requests: Dict[str, int] = {}
    env: Dict[str, str] = {}
    for c in spec_j.get("containers") or []:
        for k, v in ((c.get("resources") or {}).get("requests") or {}).items():
            requests[k] = requests.get(k, 0) + _parse_quantity(v)
        for e in c.get("env") or []:
            if "value" in e:
                env[e.get("name", "")] = e["value"]
    status_j = j.get("status") or {}
    return Pod(
        metadata=meta_from_json(j.get("metadata") or {}),
        spec=PodSpec(
            node_name=spec_j.get("nodeName", ""),
            hostname=spec_j.get("hostname", ""),
            subdomain=spec_j.get("subdomain", ""),
            volumes=[Volume(name=v.get("name", ""),
                            empty_dir="emptyDir" in v)
                     for v in spec_j.get("volumes") or []],
            termination_grace_period_seconds=spec_j.get(
                "terminationGracePeriodSeconds"),
            resource_requests=requests,
            env=env,
        ),
        status=PodStatus(
            phase=status_j.get("phase", ""),
            container_statuses=[_cs_from_json(c) for c in
                                status_j.get("containerStatuses") or []],
            init_container_statuses=[
                _cs_from_json(c) for c in
                status_j.get("initContainerStatuses") or []],
            conditions=[PodCondition(type=c.get("type", ""),
                                     status=c.get("status", ""))
                        for c in status_j.get("conditions") or []],
        ),
    )


# ------------------------------------------------- daemonset / revision

def daemonset_to_json(d: DaemonSet) -> Dict:
    return {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": meta_to_json(d.metadata),
        "spec": {"selector": {"matchLabels": dict(d.selector)}},
        "status": {"desiredNumberScheduled":
                   d.status.desired_number_scheduled},
    }


def daemonset_from_json(j: Dict) -> DaemonSet:
    return DaemonSet(
        metadata=meta_from_json(j.get("metadata") or {}),
        selector=dict(((j.get("spec") or {}).get("selector") or {})
                      .get("matchLabels") or {}),
        status=DaemonSetStatus(desired_number_scheduled=int(
            (j.get("status") or {}).get("desiredNumberScheduled", 0))),
    )


def controller_revision_to_json(r: ControllerRevision) -> Dict:
    return {"apiVersion": "apps/v1", "kind": "ControllerRevision",
            "metadata": meta_to_json(r.metadata), "revision": r.revision}


def controller_revision_from_json(j: Dict) -> ControllerRevision:
    return ControllerRevision(metadata=meta_from_json(j.get("metadata") or {}),
                              revision=int(j.get("revision", 1)))


# ------------------------------------------------------------------- job

def job_to_json(job: Job) -> Dict:
    return {"apiVersion": "batch/v1", "kind": "Job",
            "metadata": meta_to_json(job.metadata),
            "status": {"active": job.status.active,
                       "succeeded": job.status.succeeded,
                       "failed": job.status.failed}}


def job_from_json(j: Dict) -> Job:
    s = j.get("status") or {}
    return Job(metadata=meta_from_json(j.get("metadata") or {}),
               status=JobStatus(active=int(s.get("active", 0)),
                                succeeded=int(s.get("succeeded", 0)),
                                failed=int(s.get("failed", 0))))


def service_to_json(s: Service) -> Dict:
    spec: Dict = {}
    if s.spec.cluster_ip:
        spec["clusterIP"] = s.spec.cluster_ip
    if s.spec.selector:
        spec["selector"] = dict(s.spec.selector)
    if s.spec.ports:
        spec["ports"] = [{"name": p.name, "port": p.port}
                         for p in s.spec.ports]
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": meta_to_json(s.metadata), "spec": spec}


def service_from_json(j: Dict) -> Service:
    spec_j = j.get("spec") or {}
    return Service(
        metadata=meta_from_json(j.get("metadata") or {}),
        spec=ServiceSpec(
            cluster_ip=spec_j.get("clusterIP", ""),
            selector=dict(spec_j.get("selector") or {}),
            ports=[ServicePort(name=p.get("name", ""),
                               port=int(p.get("port", 0)))
                   for p in spec_j.get("ports") or []]))


def lease_to_json(lease: Lease) -> Dict:
    spec: Dict = {
        "holderIdentity": lease.spec.holder_identity,
        "leaseDurationSeconds": lease.spec.lease_duration_seconds,
        "leaseTransitions": lease.spec.lease_transitions,
    }
    # MicroTime fields, NOT metav1.Time: a real apiserver rejects
    # second-precision RFC3339 here with HTTP 400 (ADVICE r2)
    if lease.spec.acquire_time is not None:
        spec["acquireTime"] = _ts_to_rfc3339_micro(lease.spec.acquire_time)
    if lease.spec.renew_time is not None:
        spec["renewTime"] = _ts_to_rfc3339_micro(lease.spec.renew_time)
    return {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta_to_json(lease.metadata), "spec": spec}


def lease_from_json(j: Dict) -> Lease:
    spec_j = j.get("spec") or {}
    # every LeaseSpec field is an optional pointer in the real API —
    # explicit JSON nulls (another client's released lease) are legal
    return Lease(
        metadata=meta_from_json(j.get("metadata") or {}),
        spec=LeaseSpec(
            holder_identity=spec_j.get("holderIdentity") or "",
            lease_duration_seconds=int(
                spec_j.get("leaseDurationSeconds") or 15),
            acquire_time=_rfc3339_to_ts(spec_j.get("acquireTime")),
            renew_time=_rfc3339_to_ts(spec_j.get("renewTime")),
            lease_transitions=int(spec_j.get("leaseTransitions") or 0)))


def list_to_json(kind: str, items: List[Dict],
                 resource_version: Optional[str] = None) -> Dict:
    out = {"apiVersion": "v1", "kind": f"{kind}List", "items": items}
    if resource_version is not None:
        # the collection RV a watch resumes from (ListMeta.resourceVersion)
        out["metadata"] = {"resourceVersion": resource_version}
    return out
