"""NodeUpgradeStateProvider — synchronized node state access.

Reference pkg/upgrade/node_upgrade_state_provider.go. This component is
load-bearing for the whole library's idempotency contract: ApplyState is
stateless, so every state transition it writes must be visible to the *next*
reconcile's cached reads. The provider therefore (a) serializes writes per
node with a KeyedMutex (:43, :60, :78, :145) and (b) after every label or
annotation patch, polls the cached client until the write is visible —
the cache-sync barrier (:92-117, :163-197; ≤10 s at 1 s intervals).

One deliberate extension over the reference: writes can be BATCHED — the
state label and annotations of one node go out as a single strategic-merge
patch (the reference pays a patch + barrier per field), and a whole state
bucket's transitions can share one barrier wait in which the per-node cache
lags overlap instead of serializing (v5p-64: 16 hosts x ~6 in-window
transitions per rolling upgrade). The visibility contract is unchanged:
every write is reflected by the cached client before the call returns.

A copy of the JAX package's ``upgrade/node_state_provider.py``; the port
imports nothing of that package.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..core.client import ApiError, Client, EventRecorder
from ..core.objects import Node
from ..obs.journey import JourneyRecorder
from ..utils.clock import Clock, RealClock
from . import consts
from .util import KeyFactory, KeyedMutex, log_event

logger = logging.getLogger(__name__)

# The reference deletes an annotation by passing the literal string "null"
# (node_upgrade_state_provider.go:170-186). We keep the same sentinel so
# call sites read identically.
NULL = "null"


class CacheSyncTimeoutError(TimeoutError):
    """The cached client never showed the write within the barrier timeout."""


class NodeUpgradeStateProvider:
    def __init__(self, client: Client, keys: KeyFactory,
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 sync_timeout: float = consts.CACHE_SYNC_TIMEOUT_SECONDS,
                 sync_poll: float = consts.CACHE_SYNC_POLL_SECONDS,
                 metrics=None, journey: Optional[JourneyRecorder] = None,
                 timeline=None):
        self._client = client
        self._keys = keys
        self._recorder = recorder
        self._clock = clock or RealClock()
        self._sync_timeout = sync_timeout
        self._sync_poll = sync_poll
        self._mutex = KeyedMutex()
        # fleet black box (obs/timeline.py): the same choke point that
        # persists the journey annotation also records the transition as
        # a timeline event — one write path, one event trail, no second
        # source of truth. Public so the operator can late-bind its
        # process-wide timeline onto an injected provider.
        self.timeline = timeline
        # THE journey choke point (obs/journey.py): every state-label write
        # goes through this provider, so folding the journey annotations
        # into the same patch keeps timeline and label atomically coherent.
        # Always on — the annotations are what cmd/status.py --timeline and
        # the stuck detector read; ``metrics`` additionally feeds the
        # per-phase duration histogram when a MetricsHub is wired.
        self._journey = journey if journey is not None else JourneyRecorder(
            component=keys.component,
            annotation_key=keys.journey_annotation,
            stuck_key=keys.stuck_reported_annotation,
            clock=self._clock, metrics=metrics)

    # ----------------------------------------------------------------- reads

    def get_node(self, name: str) -> Node:
        """GetNode (:59-68): cached read under the per-node mutex."""
        with self._mutex.lock(name):
            return self._client.get_node(name)

    # ---------------------------------------------------------------- writes

    def change_node_upgrade_state(self, node: Node, new_state: str) -> None:
        """ChangeNodeUpgradeState (:72-134): patch the state label, then block
        until the cached client reflects it. Setting UNKNOWN ("") removes the
        label. Emits a Normal event on success."""
        self.change_nodes_state_and_annotations([node], new_state)

    def change_node_upgrade_annotation(self, node: Node, key: str,
                                       value: str) -> None:
        """ChangeNodeUpgradeAnnotation (:138-216): set (or, for value "null",
        delete) an annotation with the same cache-sync barrier + event."""
        self.change_nodes_state_and_annotations([node], None, {key: value})

    def change_node_state_and_annotations(
            self, node: Node, new_state: Optional[str] = None,
            annotations: Optional[dict] = None) -> None:
        """Combined write for one node: state label + annotations in ONE
        patch with ONE barrier (the reference pays per field)."""
        self.change_nodes_state_and_annotations([node], new_state, annotations)

    def change_nodes_state_and_annotations(
            self, nodes: List[Node], new_state: Optional[str] = None,
            annotations: Optional[dict] = None) -> None:
        """THE write path. Applies the same state label (``new_state`` None =
        leave untouched, UNKNOWN = remove) and annotations (value ``NULL`` =
        delete) to every node: one strategic-merge patch per node, then one
        barrier wait covering all of them. Per-node Normal events mirror the
        reference's per-write event trail exactly."""
        nodes = list(nodes)
        if not nodes or (new_state is None and not annotations):
            return
        label_value: Optional[str] = None
        labels = None
        if new_state is not None:
            label_value = (new_state
                           if new_state != consts.UpgradeState.UNKNOWN
                           else None)
            labels = {self._keys.state_label: label_value}
        patched_annos = {k: (None if v == NULL else v)
                         for k, v in (annotations or {}).items()}
        # Per-node patch payloads: shared caller annotations plus, on an
        # actual state TRANSITION, the journey bookkeeping (timeline append
        # + stuck-marker clear) — one patch, one barrier, label and journey
        # atomically coherent. A re-write of the current state contributes
        # nothing (JourneyRecorder.record returns {}), so idempotent passes
        # and label flaps never reset time-in-state.
        per_node_annos = {}
        rv_floor = {}
        skipped: set = set()
        for node in nodes:
            annos = dict(patched_annos)
            if labels is not None:
                old = node.metadata.labels.get(self._keys.state_label) or ""
                new = label_value or ""
                if old != new:
                    annos.update(self._journey.record(node, old, new))
                    if self.timeline is not None:
                        self.timeline.record_event(
                            kind="journey-transition",
                            entity=f"node/{node.metadata.name}",
                            detail=f"{self._keys.component}: "
                                   f"{old or 'unknown'} -> "
                                   f"{new or 'unknown'}")
            per_node_annos[node.metadata.name] = annos
            # No-op dedupe: when the caller's view already shows every
            # value this write would set AND the cached object agrees, the
            # patch is pure churn (idempotent re-application) — skip patch,
            # barrier, and event trail for this node. Both views must
            # agree: a caller merely AHEAD of the cache still patches (the
            # durable write is what matters), and a stale caller patches
            # too (harmless re-assert).
            if self._values_current(node, labels, label_value, annos):
                cached = None
                try:
                    cached = self._client.get_node(node.metadata.name)
                except (ApiError, TimeoutError):
                    pass
                if cached is not None and self._values_current(
                        cached, labels, label_value, annos):
                    skipped.add(node.metadata.name)
                    continue
            with self._mutex.lock(node.metadata.name):
                patched = self._client.patch_node_metadata(
                    node.metadata.name, labels=labels,
                    annotations=annos or None)
            rv_floor[node.metadata.name] = getattr(
                patched.metadata, "resource_version", "") if patched else ""
        if skipped:
            nodes = [n for n in nodes if n.metadata.name not in skipped]
            if not nodes:
                return

        def synced(n: Node) -> bool:
            if labels is not None and (
                    n.metadata.labels.get(self._keys.state_label)
                    != label_value):
                return False
            return all(n.metadata.annotations.get(k) == v
                       for k, v in per_node_annos[n.metadata.name].items())

        self._wait_synced_many({n.metadata.name for n in nodes}, synced,
                               rv_floor)

        for node in nodes:
            if labels is not None:
                node.metadata.labels = dict(node.metadata.labels)
                if label_value is None:
                    node.metadata.labels.pop(self._keys.state_label, None)
                else:
                    node.metadata.labels[self._keys.state_label] = label_value
                log_event(self._recorder, node, "Normal",
                          self._keys.event_reason,
                          f"Node upgrade state updated to {new_state or 'unknown'}")
                logger.info("node %s upgrade state -> %r",
                            node.metadata.name, new_state)
            node_annos = per_node_annos[node.metadata.name]
            if node_annos:
                node.metadata.annotations = dict(node.metadata.annotations)
                for k, v in node_annos.items():
                    if v is None:
                        node.metadata.annotations.pop(k, None)
                        verb = "deleted"
                    else:
                        node.metadata.annotations[k] = v
                        verb = f"set to {v}"
                    if k not in patched_annos:
                        continue  # journey bookkeeping stays out of the
                        # event trail (it rides every transition)
                    log_event(self._recorder, node, "Normal",
                              self._keys.event_reason,
                              f"Node annotation {k} {verb}")

    def _values_current(self, node: Node, labels, label_value,
                        annos: dict) -> bool:
        """True when ``node`` already shows the state label (if being
        written) and every annotation value (None = absent) this write
        would set."""
        if labels is not None:
            if (node.metadata.labels.get(self._keys.state_label)
                    != label_value):
                return False
        for k, v in annos.items():
            current = node.metadata.annotations.get(k)
            if v is None:
                if k in node.metadata.annotations:
                    return False
            elif current != v:
                return False
        return True

    # --------------------------------------------------------------- barrier

    def _wait_synced_many(self, names, pred, rv_floor=None) -> None:
        """Poll-until-visible (:92-117) over a set of nodes: the individual
        writes' cache lags overlap inside one wait. Raises
        CacheSyncTimeoutError after sync_timeout — the reference returns an
        error, failing the current ApplyState pass; the next reconcile
        retries idempotently.

        A node is also considered synced when the cached object's
        resourceVersion has reached or passed ``rv_floor`` (the version our
        patch produced) even though the written values no longer match: a
        concurrent writer — e.g. an async DrainManager thread moving the
        node to upgrade-failed — superseded our write between the patch and
        the poll. The barrier's contract is "the next reconcile sees a state
        at least as new as this write", which supersession satisfies;
        requiring the exact values would turn that benign race into a
        CacheSyncTimeoutError failing the whole batch.

        Polling is ADAPTIVE where the reference's is fixed-1 s: start at
        sync_poll/20 and back off x2 to sync_poll. Same contract (bounded by
        sync_timeout, poll-until-visible), far lower added latency — informer
        caches typically sync in tens of ms."""
        pending = set(names)
        rv_floor = rv_floor or {}
        deadline = self._clock.now() + self._sync_timeout
        poll = self._sync_poll / 20.0
        # a pump-mode informer cache advances only when pumped — the
        # barrier IS its poll loop, so drive the Node informer here
        pump = getattr(self._client, "pump", None)
        while pending:
            if pump is not None:
                try:
                    pump(kinds=("Node",))
                except Exception:  # exc: allow — a failing barrier pump degrades to polling the (possibly stale) cache
                    logger.debug("barrier pump failed; polling stale cache")
            for name in list(pending):
                try:
                    n = self._client.get_node(name)
                except KeyError:
                    continue  # node not in cache yet
                if pred(n):
                    pending.discard(name)
                elif self._rv_at_least(n.metadata.resource_version,
                                       rv_floor.get(name)):
                    logger.info(
                        "node %s: write superseded by a concurrent writer "
                        "(cache at resourceVersion %s >= patch %s); barrier "
                        "satisfied", name, n.metadata.resource_version,
                        rv_floor.get(name))
                    pending.discard(name)
            if not pending:
                break
            if self._clock.now() >= deadline:
                raise CacheSyncTimeoutError(
                    f"cached client did not reflect write to nodes "
                    f"{sorted(pending)} within {self._sync_timeout}s")
            self._clock.sleep(poll)
            poll = min(poll * 2.0, self._sync_poll)

    @staticmethod
    def _rv_at_least(observed, floor) -> bool:
        """True when the cache's resourceVersion is at/past the patch's.
        resourceVersions are opaque strings in the API contract, but both
        real etcd and the in-repo fakes emit monotonically increasing
        integers; anything non-numeric falls back to exact-match-only."""
        if not observed or not floor:
            return False
        try:
            return int(observed) >= int(floor)
        except (TypeError, ValueError):
            return False
