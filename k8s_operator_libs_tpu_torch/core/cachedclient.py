"""Informer-cached client: the production analog of controller-runtime's
cached ``client.Client``.

The reference pairs a *cached* controller-runtime client with an *uncached*
clientset (upgrade_state.go:127-135); the staleness this creates is bridged
by the provider's poll-until-synced barrier
(node_upgrade_state_provider.go:92-117). With only the uncached
:class:`~.liveclient.LiveClient`, every read is an apiserver GET and the
barrier degenerates to a single immediately-true poll. This module supplies
the missing half:

- :class:`CachedClient` wraps any watch-capable client (LiveClient in
  production, or LiveClient-over-:class:`~.httpapi.FakeAPIServer` in tests).
- One :class:`_Informer` per kind (Node, Pod, DaemonSet) runs a
  list-then-watch loop in a background thread: LIST seeds the store (and
  yields the collection resourceVersion), then WATCH events update it.
  Subsequent windows RESUME from the last-seen resourceVersion —
  controller-runtime's ListWatch protocol — so the happy path performs
  exactly ONE list for the informer's lifetime; BOOKMARK events keep the
  resume point fresh through idle windows. Only ``WatchError`` (a 410
  Gone / Expired resourceVersion) or a transport/decode failure forces a
  re-LIST (re-listing every window would be the periodic O(cluster) list
  load the informer pattern exists to avoid).
- Reads serve deep copies from the store (mutating a returned object never
  corrupts the cache). Writes go straight through to the live client and do
  NOT update the store — visibility arrives via the watch, exactly the lag
  the cache-sync barrier exists to absorb.
- ``direct()`` returns the raw uncached client, restoring the reference's
  two-client split for the drain helper and pod listing
  (upgrade_state.go:132-135).

ControllerRevisions are informer-cached too when the live client supports
watching them (FakeCluster's client does; they are on the per-node
"is the driver up to date" path, an O(fleet) LIST source when uncached)
and pass through uncached otherwise. Jobs always pass
through: genuinely low-frequency point reads.

``cache_lag`` injects an artificial delay before each watch event is applied
to the store — the live-transport analog of FakeCluster's ``cache_lag``,
used by tests to prove the barrier genuinely polls more than once.

Two additions make the cache a *delta source* (tick cost O(changed), not
O(fleet)):

- **Dirty sets.** Every informer accumulates the keys touched since the
  consumer last drained them, with the terminal event kind per key.
  :meth:`CachedClient.drain_deltas` hands them out per Kubernetes kind and
  clears them; a ``resynced`` flag marks that a re-list happened (the
  consumer's incremental view must full-rebuild — see
  ``upgrade/upgrade_state.py:IncrementalStateBuilder``).
- **Pumped mode** (``pumped=True``). Instead of background watch threads,
  the informers advance only when :meth:`CachedClient.pump` is called —
  one non-blocking watch poll per informer, applied on the CALLING
  thread. The reconcile loop pumps at tick start and the provider's
  cache-sync barrier pumps between polls, so the whole read path is
  synchronous and byte-for-byte deterministic — which is what lets the
  chaos campaign and fleetbench run the informer read path under a fake
  clock. Production keeps the threaded mode.

  Pacing caveat: watch delivery lags writes by the server-side
  ``cache_lag``, measured on the injected clock. A consumer that ticks
  in a tight loop without advancing time can therefore pump forever
  without seeing un-barriered writes (pod deletes/creates) — tick on an
  interval greater than the lag, as every in-repo consumer does
  (``cmd/operator.py --interval``, fleetbench's modelled 30 s, the
  campaign's 15 s fake-clock ticks). Provider-barriered writes are
  immune: the barrier itself sleeps the clock past the lag.

A copy of the JAX package's ``core/cachedclient.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import threads
from ..utils.clock import Clock, RealClock
from .client import Client, NotFoundError, WatchError
from .objects import ControllerRevision, DaemonSet, Job, Node, Pod

logger = logging.getLogger(__name__)

_Key = Tuple[str, str]  # (namespace or "", name)


def _key(obj) -> _Key:
    return (obj.metadata.namespace or "", obj.metadata.name)


def _not_older(event_rv: str, cached_rv: str) -> bool:
    """Apply an event only if it is not older than the cached object (the
    apiserver's RVs are opaque but practically monotonic ints; on parse
    failure, apply — a full re-list follows every window anyway)."""
    try:
        return int(event_rv) >= int(cached_rv)
    except (TypeError, ValueError):
        return True


def _match_labels(obj, selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    labels = obj.metadata.labels or {}
    return all(labels.get(k) == v for k, v in selector.items())


class KindDelta:
    """What changed for one kind since the consumer last drained:
    ``changed`` maps (namespace, name) → the LAST event kind observed
    ("ADDED"/"MODIFIED"/"DELETED"); ``resynced`` means a full re-list
    replaced the store (initial sync, 410 Gone, or transport failure) —
    per-key deltas are meaningless across it and consumers must rebuild."""

    __slots__ = ("kind", "changed", "resynced")

    def __init__(self, kind: str):
        self.kind = kind
        self.changed: Dict[_Key, str] = {}
        self.resynced = False

    def __repr__(self) -> str:
        return (f"<KindDelta {self.kind} changed={len(self.changed)} "
                f"resynced={self.resynced}>")


class _Informer:
    """List-then-watch loop for one kind, feeding a keyed store."""

    def __init__(self, kind: str,
                 list_fn: Callable[[], List],
                 watch_fn: Callable[..., object],
                 watch_window_seconds: float,
                 cache_lag: float = 0.0,
                 event_hook: Optional[Callable] = None,
                 clock: Optional[Clock] = None):
        self.kind = kind
        self._list_fn = list_fn
        self._watch_fn = watch_fn
        self._window = watch_window_seconds
        self._cache_lag = cache_lag
        # injected so the watch-lag chaos fault replays deterministically
        # under a FakeClock (DET001: no bare sleeps in the library)
        self._clock = clock or RealClock()
        self.event_hook = event_hook  # called AFTER an event is applied
        self._store: Dict[_Key, object] = {}
        self._rv: Optional[str] = None  # watch resume point; None → re-list
        self._resume_ok = False         # baseline RV came from the LIST
        self._supports_resume = True    # cleared on first TypeError
        # delta surface: keys touched since the last drain (terminal event
        # kind per key) + whether a re-list replaced the store wholesale —
        # both read/written ONLY under the store lock
        self._dirty: Dict[_Key, str] = {}
        self._resynced = False
        name = f"informer-{kind.lower()}"
        self._lock = threads.make_lock(f"{name}-store")
        # serializes pump_once() callers (the reconcile tick and barrier
        # polls may pump from shard workers concurrently)
        self._pump_lock = threads.make_lock(f"{name}-pump")
        self._synced = threads.make_event(f"{name}-synced")
        self._stop = threads.make_event(f"{name}-stop")
        self._thread = threads.spawn(name, self._run, start=False)

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout=timeout)

    def wait_synced(self, timeout: float) -> bool:
        return self._synced.wait(timeout)

    def invalidate(self) -> None:
        """Drop the watch resume point: the next advance re-lists (the
        consumer-facing resync surface — CachedClient.resync)."""
        self._set_resume_point(None)

    # --------------------------------------------------------------- reads

    def get(self, namespace: str, name: str):
        with self._lock:
            obj = self._store.get((namespace or "", name))
        if obj is None:
            raise NotFoundError(f"{self.kind} {namespace}/{name} "
                                "not in informer cache")
        return copy.deepcopy(obj)

    def snapshot(self) -> List:
        with self._lock:
            return [copy.deepcopy(o) for o in self._store.values()]

    # --------------------------------------------------------------- deltas

    def drain(self) -> Tuple[Dict[_Key, str], bool]:
        """Hand out and clear the accumulated (dirty keys, resynced) pair."""
        with self._lock:
            dirty, self._dirty = self._dirty, {}
            resynced, self._resynced = self._resynced, False
            return dirty, resynced

    # ----------------------------------------------------- resume point
    #
    # (_rv, _resume_ok) live under the STORE lock: the threaded loop is
    # their sole writer in threaded mode, but pumped mode drives the same
    # informer from whichever thread pumps (the reconcile tick, a barrier
    # poll inside a shard worker), so every access goes through these.

    def _resume_point(self):
        with self._lock:
            return self._rv, self._resume_ok

    def _set_resume_point(self, rv, resume_ok=None) -> None:
        with self._lock:
            self._rv = rv
            if resume_ok is not None:
                self._resume_ok = resume_ok

    def _advance_resume_point(self, event_rv) -> None:
        """Adopt an event/bookmark RV as the resume point ONLY when the
        baseline came from a LIST that reported one — otherwise events in
        the LIST→watch-open gap were never covered and resuming would
        skip them forever."""
        with self._lock:
            if self._resume_ok and event_rv:
                self._rv = event_rv

    # ---------------------------------------------------------------- pump

    def pump_once(self) -> None:
        """One synchronous list-or-watch step (pumped mode): re-list when
        the resume point is lost, otherwise apply every watch event
        available NOW. Transport failures leave the store stale (and the
        resume point intact where possible) for the next pump — the
        pump-mode analog of the thread loop's retry. ``_pump_lock``
        serializes concurrent pump callers."""
        with self._pump_lock:
            rv, _ = self._resume_point()
            if rv is None:
                try:
                    self._relist()
                    self._synced.set()
                except Exception as exc:  # exc: allow — the informer must survive any list failure; staleness is surfaced and the next pump retries
                    logger.warning("informer %s: pump re-list failed: %s "
                                   "(stale until next pump)", self.kind, exc)
                return
            try:
                events = self._watch_fn(timeout_seconds=0.0,
                                        resource_version=rv,
                                        allow_bookmarks=True)
            except WatchError as exc:
                logger.info("informer %s: watch expired (%s); re-listing",
                            self.kind, exc)
                try:
                    self._relist()
                except Exception as exc2:  # exc: allow — re-list after watch expiry is best-effort; the next pump retries
                    self._set_resume_point(None)
                    logger.warning("informer %s: pump re-list failed: %s "
                                   "(stale until next pump)", self.kind, exc2)
                return
            except Exception as exc:  # exc: allow — a pump watch failure leaves the cache stale until the next pump, by design
                logger.warning("informer %s: pump watch failed: %s "
                               "(stale until next pump)", self.kind, exc)
                return
            for etype, obj in events:
                if etype == "BOOKMARK":
                    self._advance_resume_point(obj.metadata.resource_version)
                    continue
                self._apply(etype, obj)
                self._advance_resume_point(obj.metadata.resource_version)
                if self.event_hook is not None:
                    self.event_hook(self.kind, etype, obj)

    # ---------------------------------------------------------------- loop

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                rv, _ = self._resume_point()
                if rv is None:
                    self._relist()
                    self._synced.set()
                stream = self._open_watch()
                for etype, obj in stream:
                    if self._stop.is_set():
                        return
                    if etype == "BOOKMARK":
                        # no object change — just a fresher resume point
                        self._advance_resume_point(
                            obj.metadata.resource_version)
                        continue
                    if self._cache_lag:
                        self._clock.sleep(self._cache_lag)
                    self._apply(etype, obj)
                    self._advance_resume_point(obj.metadata.resource_version)
                    if self.event_hook is not None:
                        # post-apply: a reader woken by the hook sees the
                        # event already reflected in the store
                        self.event_hook(self.kind, etype, obj)
                # clean window end: loop → next watch RESUMES from _rv;
                # no re-list on the happy path
            except WatchError as exc:
                logger.info("informer %s: watch expired (%s); re-listing",
                            self.kind, exc)
                self._set_resume_point(None)
            except Exception as exc:  # exc: allow — the background informer thread must survive anything and re-list
                if self._stop.is_set():
                    return
                logger.warning("informer %s: %s; re-listing in 1s",
                               self.kind, exc)
                self._set_resume_point(None)
                self._stop.wait(1.0)

    def _open_watch(self):
        """Watch with resume when the client supports it; plain watch (each
        window preceded by a re-list, the pre-resume behavior) otherwise."""
        if self._supports_resume:
            try:
                rv, _ = self._resume_point()
                return self._watch_fn(timeout_seconds=self._window,
                                      resource_version=rv,
                                      allow_bookmarks=True)
            except TypeError:
                self._supports_resume = False
                logger.info("informer %s: client watch has no resume "
                            "support; re-listing per window", self.kind)
        # without resume, the next window must re-list — and event RVs must
        # not be adopted as resume points in the meantime (they would stop
        # the re-list while the watch has no replay to cover window gaps)
        self._set_resume_point(None, resume_ok=False)
        return self._watch_fn(timeout_seconds=self._window)

    def _relist(self) -> None:
        result = self._list_fn()
        # list fns may return (items, collection_rv) — the resume point —
        # or bare items (no resume support)
        items, rv = (result if isinstance(result, tuple) else (result, None))
        # RV "0" means "any version" to the server (no replay) — not a
        # usable resume point; treat like absent so the next window re-lists
        resume = rv if rv and rv != "0" else None
        with self._lock:
            self._store = {_key(o): o for o in items}
            # per-key deltas are void across a wholesale replace
            self._dirty = {}
            self._resynced = True
            self._rv = resume
            self._resume_ok = resume is not None

    def _apply(self, etype: str, obj) -> None:
        key = _key(obj)
        with self._lock:
            if etype == "DELETED":
                self._store.pop(key, None)
                self._dirty[key] = "DELETED"
                return
            cached = self._store.get(key)
            if cached is None or _not_older(obj.metadata.resource_version,
                                            cached.metadata.resource_version):
                self._store[key] = obj
                self._dirty[key] = etype


class CachedClient(Client):
    """Cached reads over informer stores; writes and ``direct()`` hit the
    wrapped live client. Call :meth:`start` (or use as a context manager)
    before reading; reads before the initial list raise
    :class:`RuntimeError`."""

    def __init__(self, live: Client,
                 namespaces: Optional[List[str]] = None,
                 watch_window_seconds: float = 30.0,
                 cache_lag: float = 0.0,
                 clock: Optional[Clock] = None,
                 pumped: bool = False):
        """``namespaces`` scopes the Pod / DaemonSet / ControllerRevision
        informers: one informer set per namespace, so a shared cluster's
        unrelated pods never enter the store (the reference consumer
        scopes its cache the same way via manager.Options.Namespace).
        None = cluster-wide. ``pumped=True`` runs every informer
        synchronously on the caller's thread via :meth:`pump` — see the
        module docstring."""
        self._live = live
        self._started = False
        self._pumped = pumped
        self._clock = clock or RealClock()
        self._namespaces = sorted(set(namespaces)) if namespaces else [None]
        # prefer the *_with_rv list forms: they return the collection
        # resourceVersion the watch resumes from (one LIST per informer
        # lifetime); plain list fns degrade to re-list-per-window
        list_nodes = getattr(live, "list_nodes_with_rv", live.list_nodes)
        list_pods = getattr(live, "list_pods_with_rv", live.list_pods)
        list_ds = getattr(live, "list_daemonsets_with_rv",
                          live.list_daemonsets)
        self._informers: List[_Informer] = [
            _Informer("Node", list_nodes, live.watch_nodes,
                      watch_window_seconds, cache_lag,
                      clock=self._clock)]
        # ControllerRevisions join the cache only when the live client can
        # watch them (the fake apiserver can; a client that can't keeps
        # the old uncached passthrough)
        self._cr_cached = hasattr(live, "watch_controller_revisions")
        list_cr = getattr(live, "list_controller_revisions_with_rv",
                          live.list_controller_revisions)
        for ns in self._namespaces:
            self._informers.append(_Informer(
                "Pod",
                lambda ns=ns: list_pods(namespace=ns),
                lambda ns=ns, **kw: live.watch_pods(namespace=ns, **kw),
                watch_window_seconds, cache_lag, clock=self._clock))
            self._informers.append(_Informer(
                "DaemonSet",
                lambda ns=ns: list_ds(namespace=ns),
                lambda ns=ns, **kw: live.watch_daemonsets(namespace=ns,
                                                          **kw),
                watch_window_seconds, cache_lag, clock=self._clock))
            if self._cr_cached:
                self._informers.append(_Informer(
                    "ControllerRevision",
                    lambda ns=ns: list_cr(namespace=ns),
                    lambda ns=ns, **kw: live.watch_controller_revisions(
                        namespace=ns, **kw),
                    watch_window_seconds, cache_lag, clock=self._clock))

    def set_event_hook(self, hook: Optional[Callable]) -> None:
        """``hook(kind, etype, obj)`` fires after each watch event lands in
        the store — a reconcile loop woken by it reads a cache that already
        reflects the event (no wake-before-visible race)."""
        for inf in self._informers:
            inf.event_hook = hook

    # ----------------------------------------------------------- lifecycle

    def start(self, sync_timeout: float = 30.0) -> "CachedClient":
        """Start informers and block until every cache has listed once
        (mgr.GetCache().WaitForCacheSync analog). In pumped mode the
        initial lists run inline, retried on transient failure until the
        (injected-clock) deadline."""
        if self._pumped:
            deadline = self._clock.now() + sync_timeout
            for inf in self._informers:
                while not inf.wait_synced(0.0):
                    inf.pump_once()
                    if inf.wait_synced(0.0):
                        break
                    if self._clock.now() >= deadline:
                        raise TimeoutError(
                            f"informer {inf.kind} failed to sync "
                            f"within {sync_timeout}s")
                    self._clock.sleep(0.5)
            self._started = True
            return self
        for inf in self._informers:
            inf.start()
        deadline = self._clock.now() + sync_timeout
        for inf in self._informers:
            remaining = deadline - self._clock.now()
            if not inf.wait_synced(max(remaining, 0.0)):
                self.stop()
                raise TimeoutError(
                    f"informer {inf.kind} failed to sync "
                    f"within {sync_timeout}s")
        self._started = True
        return self

    def stop(self) -> None:
        if self._pumped:
            return  # no threads to stop
        for inf in self._informers:
            inf.stop()
        for inf in self._informers:
            inf.join(timeout=0.1)  # daemon threads; exit by next window

    # ------------------------------------------------------ delta surface

    def pump(self, kinds: Optional[Tuple[str, ...]] = None) -> None:
        """Advance every (or the named kinds') informer by one synchronous
        list-or-watch step. Pumped mode only (threaded informers advance
        themselves); safe from concurrent threads."""
        if not self._pumped:
            return
        for inf in self._informers:
            if kinds is None or inf.kind in kinds:
                inf.pump_once()

    def resync(self) -> None:
        """Invalidate every informer's resume point so its next advance
        (pump, or the threaded loop's next window) performs a full
        re-LIST. The degraded-mode recovery path: after an apiserver
        blackout the watch replay window is gone and the store may have
        missed arbitrary events — the operator calls this when its
        circuit breaker closes, and the resulting ``resynced`` delta
        flag forces the next BuildState to full-rebuild from the fresh
        lists (docs/resilience.md)."""
        for inf in self._informers:
            inf.invalidate()

    def drain_deltas(self) -> Dict[str, KindDelta]:
        """The per-kind dirty sets accumulated since the last drain,
        merged across namespace-scoped informers of the same kind, and
        cleared. Consumers drain once per reconcile tick and patch their
        incremental views from the result."""
        out: Dict[str, KindDelta] = {}
        for inf in self._informers:
            changed, resynced = inf.drain()
            delta = out.setdefault(inf.kind, KindDelta(inf.kind))
            delta.changed.update(changed)
            delta.resynced = delta.resynced or resynced
        return out

    def __enter__(self) -> "CachedClient":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _caches(self, kind: str) -> List[_Informer]:
        if not self._started:  # thr: allow — write-once in start() before any reader thread exists; GIL-atomic bool read
            raise RuntimeError("CachedClient.start() not called")
        return [inf for inf in self._informers if inf.kind == kind]

    # ------------------------------------------------------- cached reads

    def get_node(self, name: str) -> Node:
        return self._caches("Node")[0].get("", name)

    def list_nodes(self, label_selector=None) -> List[Node]:
        return [n for n in self._caches("Node")[0].snapshot()
                if _match_labels(n, label_selector)]

    def get_pod(self, namespace: str, name: str) -> Pod:
        for inf in self._caches("Pod"):
            try:
                return inf.get(namespace, name)
            except NotFoundError:
                continue
        raise NotFoundError(f"Pod {namespace}/{name} not in informer cache")

    def list_pods(self, namespace=None, label_selector=None,
                  field_node_name=None) -> List[Pod]:
        pods = [p for inf in self._caches("Pod") for p in inf.snapshot()]
        if namespace:
            pods = [p for p in pods if p.metadata.namespace == namespace]
        if field_node_name:
            pods = [p for p in pods if p.spec.node_name == field_node_name]
        return [p for p in pods if _match_labels(p, label_selector)]

    def list_daemonsets(self, namespace=None,
                        label_selector=None) -> List[DaemonSet]:
        dss = [d for inf in self._caches("DaemonSet")
               for d in inf.snapshot()]
        if namespace:
            dss = [d for d in dss if d.metadata.namespace == namespace]
        return [d for d in dss if _match_labels(d, label_selector)]

    # --------------------------------------- uncached passthrough reads

    def list_controller_revisions(self, namespace=None, label_selector=None
                                  ) -> List[ControllerRevision]:
        if self._cr_cached:
            crs = [c for inf in self._caches("ControllerRevision")
                   for c in inf.snapshot()]
            if namespace:
                crs = [c for c in crs if c.metadata.namespace == namespace]
            return [c for c in crs if _match_labels(c, label_selector)]
        return self._live.list_controller_revisions(namespace, label_selector)

    def get_job(self, namespace: str, name: str) -> Job:
        return self._live.get_job(namespace, name)

    # ------------------------------------------------------------- writes

    def patch_node_metadata(self, name, labels=None, annotations=None) -> Node:
        return self._live.patch_node_metadata(name, labels=labels,
                                              annotations=annotations)

    def patch_node_unschedulable(self, name: str, unschedulable: bool) -> Node:
        return self._live.patch_node_unschedulable(name, unschedulable)

    def patch_node_taints(self, name: str, taint_patch) -> Node:
        return self._live.patch_node_taints(name, taint_patch)

    def create_pod(self, pod: Pod) -> Pod:
        return self._live.create_pod(pod)

    def create_service(self, service):
        return self._live.create_service(service)

    # leases bypass the cache entirely: leader election must see fresh state
    def get_lease(self, namespace, name):
        return self._live.get_lease(namespace, name)

    def create_lease(self, lease):
        return self._live.create_lease(lease)

    def update_lease(self, lease):
        return self._live.update_lease(lease)

    def delete_pod(self, namespace, name, grace_period_seconds=None) -> None:
        self._live.delete_pod(namespace, name,
                              grace_period_seconds=grace_period_seconds)

    def evict_pod(self, namespace, name, grace_period_seconds=None) -> None:
        self._live.evict_pod(namespace, name,
                             grace_period_seconds=grace_period_seconds)

    # ------------------------------------------------------------ escape

    def watch_nodes(self, *a, **kw):
        return self._live.watch_nodes(*a, **kw)

    def watch_pods(self, *a, **kw):
        return self._live.watch_pods(*a, **kw)

    def watch_daemonsets(self, *a, **kw):
        return self._live.watch_daemonsets(*a, **kw)

    def watch_controller_revisions(self, *a, **kw):
        return self._live.watch_controller_revisions(*a, **kw)

    def direct(self) -> Client:
        """The uncached client (kubernetes.Interface analog) — the drain
        helper and eviction path read through this, never the cache."""
        return self._live
