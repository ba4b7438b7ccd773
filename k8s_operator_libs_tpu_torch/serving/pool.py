"""Replica registry: one serving runtime per node, registered in the
cluster, health-scraped from its metrics text.

A port of the JAX package's ``serving/pool.py``. A :class:`Replica` binds
a **runtime adapter** (anything with the small duck-typed surface below)
to the node that hosts it. Two adapters exist: :class:`BatcherRuntime`
(an in-process :class:`~..models.serve.ContinuousBatcher` of this
package, on the device its parameters live on) and
:class:`~.sim.SimReplicaRuntime` (no model: the router's tests).

Runtime adapter surface::

    submit(prompt, max_new) -> local request id      (raises if draining)
    poll() -> {local rid: tokens}                    (each result once)
    drain() -> None                                  (stop admission)
    handoff() -> [(local rid, prompt, max_new), ...] (never-admitted queue)
    idle -> bool (property)
    alive() -> bool                                  (False once crashed)
    metrics_text() -> str                            (Prometheus text)

Streaming and live-migration surface (optional: a runtime that carries
it lets the router stream tokens and migrate IN-FLIGHT requests across a
drain instead of finishing them on the drainer)::

    poll_stream() -> {local rid: [new tokens]}       (each token once)
    export_slot(local rid) -> payload                (quiesce + freeze)
    adopt_slot(payload) -> new local rid             (restore + resume)
    payload_version -> int                           (KV wire version)

Health and backpressure signals are not read from the adapter object:
:meth:`ReplicaPool.scrape` parses them out of the replica's own metrics
exposition (the ``tpu_workload_serve_*`` families, the bytes a scrape of
the port's ``server.py`` or the JAX package's ``cmd/serve.py`` returns).
Registration is mirrored onto the node through the client with the
``wire.py`` replica keys, and :meth:`ReplicaPool.refresh_nodes` keeps a
per-node :class:`NodeState` (cordon, quarantine, reclaim taint, upgrade
state label) that the router's drain watch reads. A failing cluster call
keeps the last good view (counted in ``node_refresh_errors``).

**The client contract.** ``client`` (optional) has
``patch_node_metadata(name, labels=, annotations=)`` and ``direct()``
returning an object with ``get_node(name)``; a node has
``metadata.labels``, ``spec.unschedulable``, ``spec.taints`` (each with
``.key``) and ``is_ready()``. An apiserver failure must be raised as this
package's :class:`~..core.client.ApiError` or as ``TimeoutError``: those
two are what the pool and the router catch. A client of another package
is wrapped so that it re-raises its own errors as these.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Callable, Dict, List, Optional

from ..core.client import ApiError
from ..upgrade.consts import UpgradeState
from ..upgrade.util import KeyFactory
from ..utils import threads
from ..utils.clock import Clock, RealClock
from ..wire import (KV_PAYLOAD_VERSION_ANNOTATION, LANE_LABEL,
                    QUARANTINE_LABEL, RECLAIM_TAINT_KEY,
                    REPLICA_ENDPOINT_ANNOTATION, REPLICA_ID_LABEL,
                    REPLICA_WEIGHT_LABEL)

logger = logging.getLogger(__name__)

# Node upgrade-state labels that make a node unsafe to ADMIT to (and
# trigger the router's proactive drain). Deliberately NOT
# ``upgrade-required``: admission marks every outdated node at once, and
# treating that as un-admitting (or draining on it) would take the whole
# fleet out in one tick — the budget-limited ``cordon-required``
# admission is the "your cordon is imminent" signal, and it lands one
# reconcile BEFORE the cordon itself.
DRAIN_STATES = (
    UpgradeState.CORDON_REQUIRED,
    UpgradeState.WAIT_FOR_JOBS_REQUIRED,
    UpgradeState.POD_DELETION_REQUIRED,
    UpgradeState.DRAIN_REQUIRED,
    UpgradeState.POD_RESTART_REQUIRED,
    UpgradeState.VALIDATION_REQUIRED,
    UpgradeState.FAILED,
)

# one exposition sample line: name{labels} value
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*?)(\{[^}]*\})?\s+([^\s]+)$")


def parse_gauges(text: str) -> Dict[str, float]:
    """Prometheus text exposition → ``{family: value}`` (label sets of a
    family sum — the pool consumes scalar process gauges, where a family
    has one series anyway). Histogram sample lines (``_bucket``/``_sum``/
    ``_count``) parse like any other family; the pool simply never looks
    them up."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        out[m.group(1)] = out.get(m.group(1), 0.0) + value
    return out


@dataclasses.dataclass
class NodeState:
    """The router's view of one replica's node, refreshed per tick."""

    schedulable: bool = True
    ready: bool = True
    quarantined: bool = False
    reclaim_tainted: bool = False
    state_label: str = ""
    known: bool = False         # False until one successful refresh


@dataclasses.dataclass
class ReplicaStats:
    """Backpressure signals parsed from the replica's /metrics text."""

    queue_depth: float = 0.0
    slots_busy: float = 0.0
    slots_total: float = 0.0
    draining: bool = False
    failed: bool = False
    stale: bool = True          # True until one successful scrape
    scrape_errors: int = 0


class Replica:
    """One registered serving replica: a runtime adapter on a node."""

    def __init__(self, replica_id: str, node_name: str, runtime,
                 url: Optional[str] = None, weight: float = 1.0,
                 lane: Optional[str] = None):
        if weight <= 0:
            raise ValueError(f"replica {replica_id}: weight must be "
                             f"positive, got {weight}")
        self.id = replica_id
        self.node_name = node_name
        self.runtime = runtime
        self.url = url
        self.weight = float(weight)
        # QoS lane this replica is DEDICATED to (None = serves every
        # lane); mirrored to the node as the LANE_LABEL so a restarted
        # router rebuilds lane-reserved capacity from the cluster
        self.lane = lane
        self.stats = ReplicaStats()
        self.draining = False       # router-side admission stop
        self.drain_reason: Optional[str] = None
        self.failed = False         # runtime crashed / unreachable
        self.drained = False        # drain finished (idle after handoff)
        self.scale_down = False     # autoscaler victim: release when drained

    def describe(self) -> Dict[str, object]:
        return {
            "id": self.id, "node": self.node_name, "url": self.url,
            "weight": self.weight, "lane": self.lane,
            "draining": self.draining,
            "drain_reason": self.drain_reason, "failed": self.failed,
            "drained": self.drained,
            "queue_depth": self.stats.queue_depth,
            "slots_busy": self.stats.slots_busy,
            "slots_total": self.stats.slots_total,
            "stale": self.stats.stale,
        }


class ReplicaPool:
    """The registry. ``client`` (optional) mirrors registration into node
    labels/annotations and feeds :meth:`refresh_nodes`; without one the
    pool is a purely in-memory registry (unit tests, standalone router).

    ``scrape_gate`` (optional ``fn(replica) -> None``) runs before each
    replica's scrape and may raise (a flaking metrics endpoint)."""

    def __init__(self, client=None, component: str = "libtpu",
                 metrics=None, clock: Optional[Clock] = None,
                 metrics_prefix: str = "tpu_workload"):
        self._client = client
        self.keys = KeyFactory(component)
        self._metrics = metrics
        self._clock = clock or RealClock()
        self._prefix = metrics_prefix
        self._registry_lock = threads.make_lock("replica-pool-registry")
        self._replicas: Dict[str, Replica] = {}
        self.node_states: Dict[str, NodeState] = {}
        self.node_refresh_errors = 0
        self.scrape_gate: Optional[Callable[[Replica], None]] = None

    @property
    def client(self):
        """The (optional) cluster client — the router stamps drain
        intents through it."""
        return self._client

    # ---------------------------------------------------------- registry

    @property
    def replicas(self) -> Dict[str, Replica]:
        """The registry, id -> replica: the dict last published, read
        under the registry lock (see :meth:`register`)."""
        with self._registry_lock:
            return self._replicas

    def register(self, replica: Replica) -> Replica:
        """Add (or replace — a respawned generation reuses the node, not
        the id) a replica and mirror the registration onto its node.

        The registry is replaced, never changed in place (here and in
        :meth:`deregister`): the router binary registers from an HTTP
        handler while its ticker iterates the registry (:meth:`scrape`,
        :meth:`refresh_nodes`, :meth:`admitting`), and a dict that
        changes size under an iteration raises. Each reader iterates the
        dict it read, whole; readers and writers take the registry
        lock."""
        with self._registry_lock:
            self._replicas = {**self._replicas, replica.id: replica}
        if self._client is not None:
            annotations = {}
            if replica.url:
                annotations[REPLICA_ENDPOINT_ANNOTATION] = replica.url
            payload_version = getattr(replica.runtime, "payload_version",
                                      None)
            if payload_version is not None:
                # adoptability pre-check for migrating routers: the KV
                # wire version this replica speaks, in the cluster
                annotations[KV_PAYLOAD_VERSION_ANNOTATION] = \
                    str(int(payload_version))
            labels = {REPLICA_ID_LABEL: replica.id,
                      REPLICA_WEIGHT_LABEL: f"{replica.weight:g}"}
            if replica.lane is not None:
                labels[LANE_LABEL] = replica.lane
            try:
                self._client.patch_node_metadata(
                    replica.node_name, labels=labels,
                    annotations=annotations or None)
            except (ApiError, TimeoutError):
                # in-memory registry stays authoritative; the mirror is
                # observability, not a correctness dependency
                logger.warning("could not mirror replica %s registration "
                               "onto node %s", replica.id,
                               replica.node_name, exc_info=True)
        return replica

    def deregister(self, replica_id: str) -> Optional[Replica]:
        with self._registry_lock:
            replicas = dict(self._replicas)
            replica = replicas.pop(replica_id, None)
            self._replicas = replicas
        if replica is not None and self._client is not None:
            try:
                self._client.patch_node_metadata(
                    replica.node_name,
                    labels={REPLICA_ID_LABEL: None,
                            REPLICA_WEIGHT_LABEL: None,
                            LANE_LABEL: None},
                    annotations={REPLICA_ENDPOINT_ANNOTATION: None,
                                 KV_PAYLOAD_VERSION_ANNOTATION: None})
            except (ApiError, TimeoutError):
                logger.warning("could not clear replica %s registration "
                               "from node %s", replica_id,
                               replica.node_name, exc_info=True)
        return replica

    def live(self) -> List[Replica]:
        """Replicas whose runtime still runs (draining included)."""
        return [r for r in self.replicas.values() if not r.failed]

    def node_admitting(self, node_name: str) -> bool:
        """Is the node safe to ADMIT new work to? Unknown nodes default
        to admitting (a registry-only pool has no cluster view).
        ``upgrade-required`` alone does NOT block admission — see
        :data:`DRAIN_STATES`."""
        state = self.node_states.get(node_name)
        if state is None or not state.known:
            return True
        return (state.schedulable and state.ready
                and not state.quarantined and not state.reclaim_tainted
                and state.state_label not in DRAIN_STATES)

    def admitting(self) -> List[Replica]:
        """Replicas currently accepting new requests: runtime alive, not
        draining, node clean."""
        return [r for r in self.replicas.values()
                if not r.failed and not r.draining and not r.stats.failed
                and not r.stats.draining
                and self.node_admitting(r.node_name)]

    # ------------------------------------------------------ cluster views

    def refresh_nodes(self) -> None:
        """Refresh every replica node's :class:`NodeState` through the
        client. A read failure keeps the previous view (stale beats
        absent under apiserver faults: the pod-side drain watch is the
        authoritative backstop)."""
        if self._client is None:
            return
        for node_name in {r.node_name for r in self.replicas.values()}:
            try:
                node = self._client.direct().get_node(node_name)
            except (ApiError, TimeoutError):
                self.node_refresh_errors += 1
                continue
            labels = node.metadata.labels
            self.node_states[node_name] = NodeState(
                schedulable=not node.spec.unschedulable,
                ready=node.is_ready(),
                quarantined=QUARANTINE_LABEL in labels,
                reclaim_tainted=any(t.key == RECLAIM_TAINT_KEY
                                    for t in node.spec.taints),
                state_label=labels.get(self.keys.state_label, ""),
                known=True)

    def scrape(self) -> None:
        """Scrape every live replica's ``/metrics`` text and refresh its
        :class:`ReplicaStats`. A scrape failure marks the stats stale but
        keeps the last good values — the router keeps routing on its most
        recent knowledge while the endpoint flakes."""
        for replica in self.replicas.values():
            if replica.failed:
                continue
            try:
                if self.scrape_gate is not None:
                    self.scrape_gate(replica)
                gauges = parse_gauges(replica.runtime.metrics_text())
            except Exception:  # exc: allow — a failing scrape of any shape marks the stats stale; the router routes around it
                replica.stats.stale = True
                replica.stats.scrape_errors += 1
                continue
            p = self._prefix
            replica.stats = ReplicaStats(
                queue_depth=gauges.get(f"{p}_serve_queue_depth", 0.0),
                slots_busy=gauges.get(f"{p}_serve_slots_busy", 0.0),
                slots_total=gauges.get(f"{p}_serve_slots_total", 0.0),
                draining=gauges.get(f"{p}_serve_draining", 0.0) > 0,
                failed=gauges.get(f"{p}_serve_failed", 0.0) > 0,
                stale=False,
                scrape_errors=replica.stats.scrape_errors)
            if self._metrics is not None:
                self._metrics.observe(
                    "replica_queue_depth", replica.stats.queue_depth,
                    labels={"replica": replica.id},
                    buckets=_queue_depth_buckets())


def _queue_depth_buckets():
    from ..obs.metrics import QUEUE_DEPTH_BUCKETS
    return QUEUE_DEPTH_BUCKETS


class BatcherRuntime:
    """In-process runtime adapter over this package's
    :class:`~..models.serve.ContinuousBatcher`, on the device its
    ``params`` live on. The batcher writes its telemetry into its own
    :class:`~..obs.metrics.MetricsHub`; :meth:`metrics_text` renders it
    under the ``tpu_workload`` prefix, as the port's ``server.py``
    ``/metrics`` does, so the pool's scrape parses real exposition bytes.
    The caller steps the batcher (:meth:`step`); the router does not."""

    def __init__(self, params, cfg, max_slots: int = 8,
                 capacity_per_slot: int = 512, block_size: int = 16,
                 shared_prefix=None, clock: Optional[Clock] = None,
                 hub=None):
        from ..models.serve import ContinuousBatcher
        from ..obs.metrics import MetricsHub
        self.hub = hub if hub is not None else MetricsHub()
        self.srv = ContinuousBatcher(
            params, cfg, max_slots=max_slots,
            capacity_per_slot=capacity_per_slot, block_size=block_size,
            shared_prefix=shared_prefix, metrics=self.hub, clock=clock)
        self._failed = False
        self.reject_adoptions = 0

    @property
    def payload_version(self) -> int:
        return self.srv.payload_version

    def submit(self, prompt, max_new: int) -> int:
        return self.srv.submit(prompt, max_new)

    def poll(self):
        if self._failed:
            return {}
        return self.srv.poll()

    def poll_stream(self):
        if self._failed:
            return {}
        return self.srv.poll_stream()

    def export_slot(self, rid: int) -> dict:
        if self._failed:
            raise RuntimeError("runtime failed; nothing to export")
        return self.srv.export_slot(rid)

    def adopt_slot(self, payload: dict) -> int:
        if self._failed:
            raise RuntimeError("runtime failed; adopt on a peer")
        if self.reject_adoptions > 0:
            # test hook mirroring SimReplicaRuntime.reject_adoptions:
            # forces the router's degraded re-prefill fallback
            self.reject_adoptions -= 1
            raise RuntimeError("adoption refused (forced rejection)")
        return self.srv.adopt_slot(payload)

    @property
    def busy(self) -> bool:
        return bool(self.srv._running)

    def drain(self) -> None:
        self.srv.drain()

    def handoff(self):
        return self.srv.handoff()

    @property
    def idle(self) -> bool:
        return self.srv.idle

    def alive(self) -> bool:
        return not self._failed

    def fail(self) -> None:
        """Mark the runtime crashed (test hook — a real batcher crash
        surfaces as step() raising, which the caller routes here)."""
        self._failed = True

    def step(self, n: int = 1) -> None:
        if self._failed:
            return
        try:
            if not self.srv.idle:
                self.srv.step(n)
        except Exception:  # exc: allow — a batcher crash of any shape fails the runtime; the router collects it
            logger.exception("replica batcher step crashed; failing the "
                             "runtime")
            self._failed = True

    def metrics_text(self) -> str:
        return self.hub.render(prefix="tpu_workload")
