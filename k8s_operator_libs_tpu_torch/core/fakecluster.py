"""In-process fake Kubernetes apiserver — our envtest.

The reference's central test fixture is envtest: a real kube-apiserver + etcd
with **no kubelet and no scheduler**, so Node/Pod/DaemonSet objects are plain
API objects whose status tests hand-set (reference upgrade_suit_test.go:73-97,
293-296). We reproduce exactly that contract in-process:

- objects live in a thread-safe store keyed by (kind, namespace, name), with
  resourceVersion bumped on every write and deep-copy on every round-trip;
- the **cached** client view lags writes by a configurable ``cache_lag``
  (modelling the controller-runtime informer cache whose staleness the
  reference works around with a poll-until-synced barrier,
  node_upgrade_state_provider.go:92-117);
- pod delete / eviction removes the pod (no kubelet: nothing restarts it —
  DaemonSet recreation is simulated explicitly by
  :meth:`FakeCluster.reconcile_daemonsets`, playing the role of the
  kube-controller-manager that envtest also lacks);
- a :class:`FakeRecorder` captures Events like record.NewFakeRecorder(100)
  (reference upgrade_suit_test.go:63).

A copy of the JAX package's ``core/fakecluster.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import heapq
import queue
import itertools
from typing import Dict, List, Optional, Tuple

from ..utils import threads
from ..utils.clock import Clock, RealClock
from .client import (Client, ConflictError, EventRecorder, ExpiredError,
                     InvalidError, NotFoundError,
                     TooManyRequestsError, make_event)
from .objects import (
    ContainerStatus,
    ControllerRevision,
    DaemonSet,
    Event,
    Job,
    Node,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodCondition,
    deep_copy,
)

Key = Tuple[str, str, str]  # (kind, namespace, name)


def _key(obj) -> Key:
    return (obj.kind, getattr(obj.metadata, "namespace", ""), obj.metadata.name)


def _match_labels(labels: Dict[str, str], selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


class _Bookmark:
    """A watch BOOKMARK: no object change, just a fresher resume point
    (metadata.resource_version is all a consumer may read)."""

    def __init__(self, rv: str):
        self.metadata = ObjectMeta(name="", namespace="",
                                   resource_version=rv)


class FakeRecorder(EventRecorder):
    """Captures events for assertion; drained between tests like the
    reference's FakeRecorder channel (upgrade_suit_test.go:176-199)."""

    def __init__(self):
        self.events: List[Event] = []
        self._lock = threads.make_lock("fake-recorder")

    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        with self._lock:
            self.events.append(make_event(obj, event_type, reason, message))

    def record(self, event: Event) -> None:
        """Append an already-built Event (the HTTP facade's POST route)."""
        with self._lock:
            self.events.append(event)

    def drain(self) -> List[Event]:
        with self._lock:
            out, self.events = self.events, []
            return out


class FakeCluster:
    """The store + both client views. ``cluster.client`` is the cached view
    (controller-runtime analog); ``cluster.client.direct()`` is the uncached
    view (client-go analog)."""

    def __init__(self, clock: Optional[Clock] = None, cache_lag: float = 0.0):
        self.clock = clock or RealClock()
        self.cache_lag = cache_lag
        self._store: Dict[Key, object] = {}
        self._lock = threads.make_rlock("fake-cluster-store")
        self._version = itertools.count(1)
        # pending cache deliveries: (due_time, seq, key, obj-or-None)
        self._pending: List[Tuple[float, int, Key, Optional[object]]] = []
        self._pending_seq = itertools.count()
        self._cache: Dict[Key, object] = {}
        self._crds: Dict[str, dict] = {}
        self._watchers: List["queue.Queue"] = []
        # watch replay: bounded event history (rv, etype, kind, obj, t) so a
        # client can resume from a resourceVersion instead of re-listing
        # (controller-runtime informer protocol); RVs at/below
        # _history_floor have been compacted away → 410 Gone on resume.
        # ``t`` is the clock time the write landed: the non-blocking
        # watch poll (:meth:`watch_events`) delays delivery by
        # ``cache_lag`` from it, so informer staleness — and the chaos
        # ``watch-lag`` fault that widens it — is modelled at the watch
        # stream, exactly where a real informer's lag lives.
        self._history: List[Tuple[int, str, str, object, float]] = []
        self._history_floor = 0
        self._history_limit = 4096
        self._last_rv = 0
        # PDB simulation: {(ns, name): remaining 429s} — see block_eviction
        self._eviction_blocks: Dict[Tuple[str, str], int] = {}
        self.recorder = FakeRecorder()
        self.client: Client = _FakeClient(self, cached=True)

    # ------------------------------------------------------------------ watch

    def subscribe(self) -> "queue.Queue":
        """Watch the STORE (uncached — real apiserver watch semantics):
        every create/update/delete lands as ("ADDED"|"MODIFIED"|"DELETED",
        kind, deep-copied object) on the returned queue."""
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._watchers.append(q)
        return q

    def unsubscribe(self, q: "queue.Queue") -> None:
        with self._lock:
            if q in self._watchers:
                self._watchers.remove(q)

    def _notify(self, event_type: str, kind: str, obj) -> None:
        try:
            rv = int(obj.metadata.resource_version)
        except (TypeError, ValueError):
            rv = self._last_rv
        self._history.append((rv, event_type, kind, deep_copy(obj),
                              self.clock.now()))
        if len(self._history) > self._history_limit:
            dropped = self._history[:-self._history_limit]
            self._history = self._history[-self._history_limit:]
            self._history_floor = dropped[-1][0]
        for q in list(self._watchers):
            q.put((event_type, kind, deep_copy(obj)))

    def current_rv(self) -> str:
        """The collection resourceVersion a LIST response reports."""
        with self._lock:
            return str(self._last_rv)

    def events_since(self, rv: str) -> List[Tuple[str, str, object]]:
        """Replay events with resourceVersion strictly greater than ``rv``
        (the watch resume protocol). Raises :class:`ExpiredError` when the
        requested version predates the history window — the real
        apiserver's 410 Gone."""
        try:
            floor = int(rv)
        except (TypeError, ValueError):
            raise ExpiredError(f"invalid resourceVersion {rv!r}")
        with self._lock:
            if floor < self._history_floor:
                raise ExpiredError(
                    f"too old resource version: {floor} "
                    f"({self._history_floor})")
            return [(etype, kind, deep_copy(obj))
                    for erv, etype, kind, obj, _t in self._history
                    if erv > floor]

    def watch_events(self, kind: str, resource_version,
                     namespace: Optional[str] = None,
                     allow_bookmarks: bool = False) -> List[Tuple[str, object]]:
        """Non-blocking watch poll for ONE kind: every event with
        resourceVersion strictly greater than ``resource_version`` whose
        cache-lag due time (write time + ``cache_lag``) has arrived, as
        ``(etype, obj)`` pairs in commit order. Events not yet due are
        withheld — and so is everything after them, preserving order — so
        a pump-mode informer resumes exactly at the gap next poll. With
        ``allow_bookmarks``, a trailing BOOKMARK carrying the collection
        resourceVersion is appended when nothing was withheld, letting the
        consumer's resume point pass kinds/namespaces it filtered out.
        Raises :class:`ExpiredError` (410 Gone) past the history window."""
        try:
            floor = int(resource_version)
        except (TypeError, ValueError):
            raise ExpiredError(f"invalid resourceVersion {resource_version!r}")
        with self._lock:
            if floor < self._history_floor:
                raise ExpiredError(
                    f"too old resource version: {floor} "
                    f"({self._history_floor})")
            now = self.clock.now()
            lag = self.cache_lag
            out: List[Tuple[str, object]] = []
            withheld = False
            for erv, etype, k, obj, t in self._history:
                if erv <= floor:
                    continue
                if t + lag > now:
                    withheld = True
                    break  # order-preserving: deliver a due prefix only
                if k != kind:
                    continue
                if (namespace is not None
                        and (obj.metadata.namespace or "") != namespace):
                    continue
                out.append((etype, deep_copy(obj)))
            if allow_bookmarks and not withheld:
                out.append(("BOOKMARK", _Bookmark(str(self._last_rv))))
            return out

    # ------------------------------------------------------------------ store

    def _bump(self, obj) -> None:
        self._last_rv = next(self._version)
        obj.metadata.resource_version = str(self._last_rv)

    def _publish(self, key: Key, obj: Optional[object]) -> None:
        """Queue the new state for the cached view after cache_lag."""
        due = self.clock.now() + self.cache_lag
        heapq.heappush(self._pending, (due, next(self._pending_seq), key,
                                       deep_copy(obj) if obj is not None else None))

    def _sync_cache(self) -> None:
        now = self.clock.now()
        while self._pending and self._pending[0][0] <= now:
            _, _, key, obj = heapq.heappop(self._pending)
            if obj is None:
                self._cache.pop(key, None)
            else:
                self._cache[key] = obj

    def flush_cache(self) -> None:
        """Force the cached view current (tests use this to skip lag)."""
        with self._lock:
            while self._pending:
                _, _, key, obj = heapq.heappop(self._pending)
                if obj is None:
                    self._cache.pop(key, None)
                else:
                    self._cache[key] = obj

    def create(self, obj):
        with self._lock:
            key = _key(obj)
            if key in self._store:
                raise ConflictError(f"{key} already exists")
            stored = deep_copy(obj)
            self._bump(stored)
            self._store[key] = stored
            self._publish(key, stored)
            self._notify("ADDED", key[0], stored)
            return deep_copy(stored)

    def update(self, obj):
        """Full-object update with resourceVersion conflict detection."""
        with self._lock:
            key = _key(obj)
            cur = self._store.get(key)
            if cur is None:
                raise NotFoundError(key)
            if (obj.metadata.resource_version not in ("", "0")
                    and obj.metadata.resource_version != cur.metadata.resource_version):
                raise ConflictError(f"{key}: stale resourceVersion")
            stored = deep_copy(obj)
            stored.metadata.resource_version = cur.metadata.resource_version
            self._bump(stored)
            self._store[key] = stored
            self._publish(key, stored)
            self._notify("MODIFIED", key[0], stored)
            return deep_copy(stored)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            key = (kind, namespace, name)
            if key not in self._store:
                raise NotFoundError(key)
            gone = self._store[key]
            del self._store[key]
            self._publish(key, None)
            # the real apiserver's DELETED event carries a fresh
            # resourceVersion (an etcd revision); replay ordering needs it
            self._bump(gone)
            self._notify("DELETED", kind, gone)

    def get(self, kind: str, namespace: str, name: str, cached: bool = False):
        with self._lock:
            if cached:
                self._sync_cache()
                obj = self._cache.get((kind, namespace, name))
            else:
                obj = self._store.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError((kind, namespace, name))
            return deep_copy(obj)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             cached: bool = False,
             field_node_name: Optional[str] = None) -> List[object]:
        """``field_node_name`` is served store-side like the real
        apiserver's ``spec.nodeName`` field selector — filtering BEFORE
        the deep copy, not after, so a per-node pod list on a 10k-pod
        fleet copies one object, not ten thousand (the fleetbench
        hot path). Output order is (namespace, name), identical to the
        previous full-store sort for a single kind."""
        with self._lock:
            if cached:
                self._sync_cache()
                src = self._cache
            else:
                src = self._store
            matched = []
            for (k, ns, name), obj in src.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if (field_node_name is not None
                        and getattr(obj.spec, "node_name", None)
                        != field_node_name):
                    continue
                if not _match_labels(obj.metadata.labels, label_selector):
                    continue
                matched.append(((ns, name), obj))
            matched.sort(key=lambda kv: kv[0])
            return [deep_copy(obj) for _, obj in matched]

    def list_with_rv(self, kind: str, namespace: Optional[str] = None,
                     label_selector: Optional[Dict[str, str]] = None
                     ) -> Tuple[List[object], str]:
        """Snapshot + the collection resourceVersion, read atomically under
        ONE lock — reading them separately lets a concurrent write land
        between them, producing a list that claims an RV it does not
        contain (the resume protocol would then skip that write forever)."""
        with self._lock:
            return (self.list(kind, namespace=namespace,
                              label_selector=label_selector),
                    str(self._last_rv))

    # ----------------------------------------------------- object conveniences
    #
    # These setup helpers flush the cache before returning, mirroring test
    # setup against envtest where fixtures wait for the informer cache to sync
    # before the code under test runs. Writes through the *client* (patches,
    # deletes) still lag by cache_lag — that is what the barrier code must
    # handle.

    def add_node(self, name: str, labels: Optional[Dict[str, str]] = None,
                 annotations: Optional[Dict[str, str]] = None,
                 unschedulable: bool = False, ready: bool = True) -> Node:
        node = Node(metadata=ObjectMeta(name=name, namespace="",
                                        labels=dict(labels or {}),
                                        annotations=dict(annotations or {})))
        node.spec.unschedulable = unschedulable
        node.status.conditions[0].status = "True" if ready else "False"
        created = self.create(node)
        self.flush_cache()
        return created

    def add_daemonset(self, name: str, namespace: str = "default",
                      labels: Optional[Dict[str, str]] = None,
                      selector: Optional[Dict[str, str]] = None,
                      revision_hash: str = "rev-1") -> DaemonSet:
        """Create a DS plus its current ControllerRevision (the reference
        resolves 'latest template' via owned ControllerRevisions with max
        revision — pod_manager.go:95-121)."""
        labels = dict(labels or {})
        ds = DaemonSet(metadata=ObjectMeta(name=name, namespace=namespace, labels=labels),
                       selector=dict(selector or labels))
        ds = self.create(ds)
        self.add_controller_revision(ds, revision_hash, revision=1)
        return ds

    def add_controller_revision(self, ds: DaemonSet, revision_hash: str,
                                revision: int) -> ControllerRevision:
        cr = ControllerRevision(
            metadata=ObjectMeta(
                name=f"{ds.metadata.name}-{revision_hash}",
                namespace=ds.metadata.namespace,
                labels={"controller-revision-hash": revision_hash},
                owner_references=[OwnerReference(kind="DaemonSet",
                                                 name=ds.metadata.name,
                                                 uid=ds.metadata.uid)]),
            revision=revision)
        created = self.create(cr)
        self.flush_cache()
        return created

    def bump_daemonset_revision(self, ds_name: str, namespace: str,
                                revision_hash: str) -> None:
        """Simulate a driver-image update: a new ControllerRevision with a
        higher revision number. Existing pods keep the old hash label and so
        become 'outdated' (podInSyncWithDS false — upgrade_state.go:558-578)."""
        ds = self.get("DaemonSet", namespace, ds_name)
        revs = [r for r in self.list("ControllerRevision", namespace)
                if any(o.uid == ds.metadata.uid for o in r.metadata.owner_references)]
        next_rev = max((r.revision for r in revs), default=0) + 1
        self.add_controller_revision(ds, revision_hash, next_rev)

    def add_pod(self, name: str, node_name: str, namespace: str = "default",
                labels: Optional[Dict[str, str]] = None,
                annotations: Optional[Dict[str, str]] = None,
                owner_ds: Optional[DaemonSet] = None,
                revision_hash: Optional[str] = None,
                phase: str = "Running", ready: bool = True,
                restart_count: int = 0) -> Pod:
        labels = dict(labels or {})
        owners = []
        if owner_ds is not None:
            owners.append(OwnerReference(kind="DaemonSet", name=owner_ds.metadata.name,
                                         uid=owner_ds.metadata.uid))
            labels.setdefault("controller-revision-hash", revision_hash or "rev-1")
            for k, v in owner_ds.selector.items():
                labels.setdefault(k, v)
        elif revision_hash is not None:
            labels.setdefault("controller-revision-hash", revision_hash)
        pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace, labels=labels,
                                      annotations=dict(annotations or {}),
                                      owner_references=owners))
        pod.spec.node_name = node_name
        pod.status.phase = phase
        pod.status.container_statuses = [ContainerStatus(ready=ready,
                                                         restart_count=restart_count)]
        pod.status.conditions = [PodCondition(type="Ready",
                                              status="True" if ready else "False")]
        created = self.create(pod)
        if owner_ds is not None:
            ds = self.get("DaemonSet", owner_ds.metadata.namespace, owner_ds.metadata.name)
            ds.status.desired_number_scheduled += 1
            self.update(ds)
        self.flush_cache()
        return created

    def block_eviction(self, namespace: str, name: str, times: int = 1) -> None:
        """Simulate a PodDisruptionBudget: the next ``times`` eviction
        attempts for this pod get HTTP 429 (the apiserver's PDB response);
        kubectl drain — and our Helper — retry until their timeout."""
        with self._lock:
            self._eviction_blocks[(namespace, name)] = times

    def consume_eviction_block(self, namespace: str, name: str) -> bool:
        with self._lock:
            left = self._eviction_blocks.get((namespace, name), 0)
            if left <= 0:
                return False
            self._eviction_blocks[(namespace, name)] = left - 1
            return True

    def set_pod_status(self, namespace: str, name: str, phase: Optional[str] = None,
                       ready: Optional[bool] = None,
                       restart_count: Optional[int] = None) -> Pod:
        pod = self.get("Pod", namespace, name)
        if phase is not None:
            pod.status.phase = phase
        if ready is not None:
            for cs in pod.status.container_statuses:
                cs.ready = ready
            for c in pod.status.conditions:
                if c.type == "Ready":
                    c.status = "True" if ready else "False"
        if restart_count is not None:
            for cs in pod.status.container_statuses:
                cs.restart_count = restart_count
        updated = self.update(pod)
        self.flush_cache()
        return updated

    # ------------------------------------------------------------------ CRDs
    # Raw-dict CRD storage (the apiextensions surface crdutil needs).

    def get_crd(self, name: str) -> dict:
        with self._lock:
            crd = self._crds.get(name)
            if crd is None:
                raise NotFoundError(("CustomResourceDefinition", "", name))
            return deep_copy(crd)

    def create_crd(self, crd: dict) -> dict:
        with self._lock:
            name = crd["metadata"]["name"]
            if name in self._crds:
                raise ConflictError(f"CRD {name} already exists")
            stored = deep_copy(crd)
            stored["metadata"]["resourceVersion"] = str(next(self._version))
            self._crds[name] = stored
            return deep_copy(stored)

    def update_crd(self, crd: dict) -> dict:
        with self._lock:
            name = crd["metadata"]["name"]
            cur = self._crds.get(name)
            if cur is None:
                raise NotFoundError(("CustomResourceDefinition", "", name))
            rv = crd.get("metadata", {}).get("resourceVersion", "")
            if rv and rv != cur["metadata"]["resourceVersion"]:
                raise ConflictError(f"CRD {name}: stale resourceVersion")
            stored = deep_copy(crd)
            stored["metadata"]["resourceVersion"] = str(next(self._version))
            self._crds[name] = stored
            return deep_copy(stored)

    def list_crds(self) -> List[dict]:
        with self._lock:
            return [deep_copy(c) for c in self._crds.values()]

    def reconcile_daemonsets(self) -> List[Pod]:
        """Play the DaemonSet controller for one step: for every DS, recreate
        a pod (at the *latest* revision hash) on any node matching the DS that
        lost its pod. envtest has no controller-manager either; reference
        tests hand-create the replacement pod (upgrade_state_test.go pod
        restart specs). Returns pods created."""
        created = []
        with self._lock:
            for ds in self.list("DaemonSet"):
                revs = [r for r in self.list("ControllerRevision", ds.metadata.namespace)
                        if any(o.uid == ds.metadata.uid
                               for o in r.metadata.owner_references)]
                if not revs:
                    continue
                latest = max(revs, key=lambda r: r.revision)
                latest_hash = latest.metadata.labels["controller-revision-hash"]
                pods = [p for p in self.list("Pod", ds.metadata.namespace)
                        if any(o.uid == ds.metadata.uid
                               for o in p.metadata.owner_references)]
                covered = {p.spec.node_name for p in pods}
                want = int(ds.metadata.annotations.get("fake/want-nodes-count",
                                                       ds.status.desired_number_scheduled))
                candidates = [n for n in self.list("Node", namespace=None)
                              if n.metadata.name not in covered]
                for node in candidates[:max(0, want - len(pods))]:
                    pod = Pod(metadata=ObjectMeta(
                        name=f"{ds.metadata.name}-{node.metadata.name}",
                        namespace=ds.metadata.namespace,
                        labels={**ds.selector,
                                "controller-revision-hash": latest_hash},
                        owner_references=[OwnerReference(
                            kind="DaemonSet", name=ds.metadata.name,
                            uid=ds.metadata.uid)]))
                    pod.spec.node_name = node.metadata.name
                    pod.status.phase = "Running"
                    pod.status.container_statuses = [ContainerStatus(ready=True)]
                    pod.status.conditions = [PodCondition(type="Ready",
                                                          status="True")]
                    created.append(self.create(pod))
        self.flush_cache()
        return created


class _FakeClient(Client):
    def __init__(self, cluster: FakeCluster, cached: bool):
        self._c = cluster
        self._cached = cached
        self._direct: Optional[Client] = None

    def direct(self) -> Client:
        if self._cached:
            if self._direct is None:
                self._direct = _FakeClient(self._c, cached=False)
            return self._direct
        return self

    # -- reads --------------------------------------------------------------

    def get_node(self, name: str) -> Node:
        return self._c.get("Node", "", name, cached=self._cached)

    def list_nodes(self, label_selector=None) -> List[Node]:
        return self._c.list("Node", namespace=None, label_selector=label_selector,
                            cached=self._cached)

    def get_pod(self, namespace: str, name: str) -> Pod:
        return self._c.get("Pod", namespace, name, cached=self._cached)

    def list_pods(self, namespace=None, label_selector=None,
                  field_node_name=None) -> List[Pod]:
        # field selector served store-side (pre-copy), like the real
        # apiserver's spec.nodeName index
        return self._c.list("Pod", namespace=namespace,
                            label_selector=label_selector,
                            cached=self._cached,
                            field_node_name=field_node_name)

    def list_daemonsets(self, namespace=None, label_selector=None) -> List[DaemonSet]:
        return self._c.list("DaemonSet", namespace=namespace,
                            label_selector=label_selector, cached=self._cached)

    def list_controller_revisions(self, namespace=None,
                                  label_selector=None) -> List[ControllerRevision]:
        return self._c.list("ControllerRevision", namespace=namespace,
                            label_selector=label_selector, cached=self._cached)

    def get_job(self, namespace: str, name: str) -> Job:
        return self._c.get("Job", namespace, name, cached=self._cached)

    # -- informer protocol --------------------------------------------------
    #
    # LIST-with-rv and non-blocking watch polls always serve STORE truth
    # (an informer's LIST/WATCH is apiserver traffic, never its own
    # cache), on both client views. Watch delivery lags writes by the
    # cluster's ``cache_lag`` — see FakeCluster.watch_events — which is
    # what a pump-mode CachedClient's staleness window is made of.

    def list_nodes_with_rv(self, label_selector=None):
        return self._c.list_with_rv("Node", namespace=None,
                                    label_selector=label_selector)

    def list_pods_with_rv(self, namespace=None, label_selector=None):
        return self._c.list_with_rv("Pod", namespace=namespace,
                                    label_selector=label_selector)

    def list_daemonsets_with_rv(self, namespace=None, label_selector=None):
        return self._c.list_with_rv("DaemonSet", namespace=namespace,
                                    label_selector=label_selector)

    def list_controller_revisions_with_rv(self, namespace=None,
                                          label_selector=None):
        return self._c.list_with_rv("ControllerRevision", namespace=namespace,
                                    label_selector=label_selector)

    def watch_nodes(self, timeout_seconds=None, resource_version=None,
                    allow_bookmarks=False):
        return self._c.watch_events("Node", resource_version,
                                    allow_bookmarks=allow_bookmarks)

    def watch_pods(self, namespace=None, timeout_seconds=None,
                   resource_version=None, allow_bookmarks=False):
        return self._c.watch_events("Pod", resource_version,
                                    namespace=namespace,
                                    allow_bookmarks=allow_bookmarks)

    def watch_daemonsets(self, namespace=None, timeout_seconds=None,
                         resource_version=None, allow_bookmarks=False):
        return self._c.watch_events("DaemonSet", resource_version,
                                    namespace=namespace,
                                    allow_bookmarks=allow_bookmarks)

    def watch_controller_revisions(self, namespace=None, timeout_seconds=None,
                                   resource_version=None,
                                   allow_bookmarks=False):
        return self._c.watch_events("ControllerRevision", resource_version,
                                    namespace=namespace,
                                    allow_bookmarks=allow_bookmarks)

    # -- writes -------------------------------------------------------------

    def patch_node_metadata(self, name, labels=None, annotations=None) -> Node:
        with self._c._lock:
            node = self._c.get("Node", "", name)  # always patch against live state
            for k, v in (labels or {}).items():
                if v is None:
                    node.metadata.labels.pop(k, None)
                else:
                    node.metadata.labels[k] = v
            for k, v in (annotations or {}).items():
                if v is None:
                    node.metadata.annotations.pop(k, None)
                else:
                    node.metadata.annotations[k] = v
            return self._c.update(node)

    def patch_node_unschedulable(self, name: str, unschedulable: bool) -> Node:
        with self._c._lock:
            node = self._c.get("Node", "", name)
            node.spec.unschedulable = unschedulable
            return self._c.update(node)

    def patch_node_taints(self, name: str, taint_patch) -> Node:
        """Strategic-merge-patch the taints LIST with the real apiserver's
        semantics for ``patchStrategy: merge, patchMergeKey: key``
        (NodeSpec.Taints in the upstream API): entries update-in-place by
        key, unknown keys append, and a ``{"$patch": "delete", "key": K}``
        directive removes the K entry. ``taint_patch`` is the raw patch
        list (dicts as they appear on the wire)."""
        from .objects import Taint
        with self._c._lock:
            node = self._c.get("Node", "", name)
            taints = list(node.spec.taints)
            for entry in taint_patch:
                key = entry.get("key", "")
                if entry.get("$patch") == "delete":
                    taints = [t for t in taints if t.key != key]
                    continue
                for i, t in enumerate(taints):
                    if t.key == key:
                        # SMP merges the MATCHED entry field-by-field:
                        # absent fields keep their current values
                        taints[i] = Taint(
                            key=key,
                            value=entry.get("value", t.value),
                            effect=entry.get("effect", t.effect))
                        break
                else:
                    taints.append(Taint(key=key,
                                        value=entry.get("value", ""),
                                        effect=entry.get("effect", "")))
            # the real apiserver validates the MERGED object and 422s
            # `spec.taints[i].effect: Required value` — this catches both
            # an appended entry missing effect AND an explicit empty
            # effect patched onto an existing key (defaulting to "" would
            # accept payloads the live path rejects). Raised before any
            # store mutation, so a 422 leaves the node untouched.
            for t in taints:
                if not t.effect:
                    raise InvalidError(
                        f"Node {name!r} is invalid: spec.taints: "
                        f"Invalid value: taint {t.key!r}: effect: "
                        "Required value")
            node.spec.taints = taints
            return self._c.update(node)

    def create_pod(self, pod: Pod) -> Pod:
        created = self._c.create(pod)
        self._c.flush_cache()
        return created

    def create_service(self, service):
        created = self._c.create(service)
        self._c.flush_cache()
        return created

    def create_event(self, event: Event, namespace: str = "default") -> Event:
        """Persist an already-built Event (ClientEventRecorder's write
        path); lands in the cluster-wide FakeRecorder for assertions, like
        the HTTP facade's POST route."""
        copied = deep_copy(event)
        self._c.recorder.record(copied)
        return copied

    # leases are never cached: leader election must read fresh state
    def get_lease(self, namespace, name):
        return self._c.get("Lease", namespace, name)

    def create_lease(self, lease):
        created = self._c.create(lease)
        self._c.flush_cache()
        return created

    def update_lease(self, lease):
        updated = self._c.update(lease)
        self._c.flush_cache()
        return updated

    def delete_pod(self, namespace, name, grace_period_seconds=None) -> None:
        self._c.delete("Pod", namespace, name)

    def evict_pod(self, namespace, name, grace_period_seconds=None) -> None:
        # PDB simulation: registered blocks return 429 (block_eviction);
        # otherwise eviction degrades to delete (no kubelet in the fake).
        # Missing pods 404 BEFORE the PDB check, like a real apiserver —
        # a pod deleted out-of-band must not read as "still blocked".
        self._c.get("Pod", namespace, name)  # raises NotFoundError
        if self._c.consume_eviction_block(namespace, name):
            raise TooManyRequestsError(
                f"Cannot evict pod {namespace}/{name}: disruption budget "
                "would be violated")
        self._c.delete("Pod", namespace, name)
