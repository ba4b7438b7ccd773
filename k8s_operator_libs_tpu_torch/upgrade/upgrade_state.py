"""ClusterUpgradeStateManager — the cluster-wide upgrade state machine.

Rebuild of reference pkg/upgrade/upgrade_state.go. The consumer (an operator's
reconcile loop) calls :meth:`ClusterUpgradeStateManager.build_state` +
:meth:`~ClusterUpgradeStateManager.apply_state` every reconcile tick. State
lives in the cluster — each node's upgrade state is a node label, auxiliary
handshakes are annotations — so ApplyState is stateless and idempotent
(upgrade_state.go:68-72, 357-361): if a pass errors midway, the next reconcile
completes the work from cluster state.

Pipeline (fixed processing order, upgrade_state.go:418-481):

    unknown/done → upgrade-required → cordon-required → wait-for-jobs-required
    → pod-deletion-required → drain-required → pod-restart-required
    → validation-required → uncordon-required → upgrade-done
    (any failure → upgrade-failed, with automatic re-entry)

TPU generalization: the scheduling unit is an UpgradeGroup (one node by
default; all hosts of a multi-host slice with a TPU grouper) — see
:mod:`.groups` for the three group-awareness points.

A copy of the JAX package's ``upgrade/upgrade_state.py``; the port
imports nothing of that package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Dict, List, Optional

from ..api.v1alpha1 import (
    DriverUpgradePolicySpec,
    scaled_int_or_percent,
)
from ..core.client import Client, EventRecorder, NotFoundError
from ..core.objects import DaemonSet, Node, Pod
from ..utils.clock import Clock, RealClock
from . import consts
from .consts import UpgradeState
from .cordon_manager import CordonManager
from .drain_manager import DrainConfiguration, DrainManager
from .groups import (
    AT_OR_PAST_POD_RESTART,
    AT_OR_PAST_UNCORDON,
    GroupPolicy,
    GroupView,
    NodeGrouper,
    SingleNodeGrouper,
    build_group_views,
)
from .node_state_provider import NULL, NodeUpgradeStateProvider
from .pod_manager import PodDeletionFilter, PodManager, PodManagerConfig
from .safe_driver_load_manager import SafeDriverLoadManager
from .sharding import BudgetAccountant, ShardRunner
from .util import KeyFactory, log_event
from .validation_manager import ValidationManager

logger = logging.getLogger(__name__)

TRUE_STRING = "true"

# Sibling states that still require the node out of service: everything in
# progress EXCEPT uncordon-required — a sibling merely waiting to uncordon
# must not block ours, or two finished components deadlock each other.
# FAILED stays blocking: a node whose other driver is broken must not
# return to service.
SIBLING_BLOCKING = tuple(s for s in UpgradeState.IN_PROGRESS
                         if s != UpgradeState.UNCORDON_REQUIRED)


@dataclasses.dataclass
class NodeUpgradeState:
    """A node joined with the driver pod running on it and the DaemonSet
    controlling that pod (reference upgrade_state.go:43-53). DaemonSet is
    None for orphaned pods."""

    node: Node
    driver_pod: Pod
    driver_daemonset: Optional[DaemonSet]

    def is_orphaned_pod(self) -> bool:
        return self.driver_daemonset is None


@dataclasses.dataclass
class ClusterUpgradeState:
    """map[state-label][]NodeUpgradeState (reference upgrade_state.go:55-62)."""

    node_states: Dict[str, List[NodeUpgradeState]] = dataclasses.field(
        default_factory=dict)

    def bucket(self, state: str) -> List[NodeUpgradeState]:
        return self.node_states.get(state, [])


class BuildStateError(RuntimeError):
    """BuildState refuses to act on incomplete information — e.g. a driver
    DaemonSet with unscheduled pods (reference upgrade_state.go:241-248)."""


def state_fingerprint(state: ClusterUpgradeState) -> Dict[str, list]:
    """Canonical, order-insensitive form of a ClusterUpgradeState for the
    incremental-vs-rebuild equivalence oracle: per bucket, the sorted
    (node, node RV, pod, pod RV, owner-DS uid) tuples. Resource versions
    are included so a stale object — not just a missing one — fails the
    comparison."""
    out: Dict[str, list] = {}
    for bucket, entries in state.node_states.items():
        if not entries:
            continue
        out[bucket] = sorted(
            (ns.node.metadata.name, ns.node.metadata.resource_version,
             ns.driver_pod.metadata.namespace, ns.driver_pod.metadata.name,
             ns.driver_pod.metadata.resource_version,
             ns.driver_daemonset.metadata.uid
             if ns.driver_daemonset is not None else None)
            for ns in entries)
    return out


def _match_labels(labels: Dict[str, str],
                  selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class IncrementalStateBuilder:
    """BuildState that persists across ticks and is PATCHED from informer
    deltas instead of re-joining the world (the O(changed) reconcile's
    second layer).

    Holds the driver-pod / node / DaemonSet maps the join is made of;
    :meth:`refresh` applies one tick's drained deltas (or full-rebuilds on
    the first tick, on an informer re-list, or when no deltas are
    available), and :meth:`assemble` re-buckets in memory — O(pods) python
    work, zero apiserver calls. Node objects are refreshed only when their
    key appears in a delta, which is sound because every state-machine
    write is barriered into the cache before ApplyState returns, so the
    next tick's drain is guaranteed to carry it."""

    def __init__(self, manager: "ClusterUpgradeStateManager",
                 namespace: str, driver_labels: Dict[str, str]):
        self._mgr = manager
        self._ns = namespace
        self._labels = dict(driver_labels)
        self._pods: Dict[tuple, Pod] = {}       # (ns, name) -> Pod
        self._nodes: Dict[str, Node] = {}       # referenced nodes only
        self._dss: Dict[str, DaemonSet] = {}    # uid -> DaemonSet
        self._primed = False
        self.rebuilds = 0                        # full rebuilds performed

    def matches(self, namespace: str, driver_labels: Dict[str, str]) -> bool:
        return self._ns == namespace and self._labels == dict(driver_labels)

    # ------------------------------------------------------------ refresh

    def refresh(self, deltas: Optional[dict]) -> None:
        client = self._mgr.client
        if (not self._primed or deltas is None
                or any(d.resynced for d in deltas.values())):
            self._rebuild()
            return
        ds_delta = deltas.get("DaemonSet")
        if ds_delta is not None and any(ns == self._ns
                                        for ns, _ in ds_delta.changed):
            self._dss = {ds.metadata.uid: ds for ds in client.list_daemonsets(
                namespace=self._ns, label_selector=self._labels)}
        pod_delta = deltas.get("Pod")
        if pod_delta is not None:
            for (ns, name), etype in pod_delta.changed.items():
                if ns != self._ns:
                    continue
                if etype == "DELETED":
                    self._pods.pop((ns, name), None)
                    continue
                try:
                    pod = client.get_pod(ns, name)
                except NotFoundError:
                    self._pods.pop((ns, name), None)
                    continue
                if _match_labels(pod.metadata.labels, self._labels):
                    self._pods[(ns, name)] = pod
                else:
                    self._pods.pop((ns, name), None)
        node_delta = deltas.get("Node")
        if node_delta is not None:
            for (_ns, name), etype in node_delta.changed.items():
                if name not in self._nodes:
                    continue  # unreferenced; fetched lazily if ever joined
                if etype == "DELETED":
                    self._nodes.pop(name, None)
                    continue
                try:
                    self._nodes[name] = client.get_node(name)
                except NotFoundError:
                    self._nodes.pop(name, None)

    def _rebuild(self) -> None:
        client = self._mgr.client
        self._dss = {ds.metadata.uid: ds for ds in client.list_daemonsets(
            namespace=self._ns, label_selector=self._labels)}
        self._pods = {(p.metadata.namespace, p.metadata.name): p
                      for p in client.list_pods(
                          namespace=self._ns, label_selector=self._labels)}
        self._nodes = {}
        self._primed = True
        self.rebuilds += 1

    # ----------------------------------------------------------- assemble

    def assemble(self) -> ClusterUpgradeState:
        """Re-bucket the index into a ClusterUpgradeState with EXACTLY the
        full BuildState's semantics: DS-scheduled-count validation, the
        Pending-unscheduled skip, orphan inclusion, foreign-owner
        exclusion (upgrade_state.go:214-279)."""
        counts: Dict[str, int] = {}
        for pod in self._pods.values():
            owners = pod.metadata.owner_references
            if owners and owners[0].uid in self._dss:
                counts[owners[0].uid] = counts.get(owners[0].uid, 0) + 1
        for uid, ds in self._dss.items():
            if ds.status.desired_number_scheduled != counts.get(uid, 0):
                raise BuildStateError(
                    f"driver DaemonSet {ds.metadata.name} should not have "
                    f"Unscheduled pods (desired "
                    f"{ds.status.desired_number_scheduled}, "
                    f"got {counts.get(uid, 0)})")
        state = ClusterUpgradeState()
        provider = self._mgr.node_upgrade_state_provider
        for key in sorted(self._pods):
            pod = self._pods[key]
            owners = pod.metadata.owner_references
            owner = self._dss.get(owners[0].uid) if owners else None
            if owners and owner is None:
                continue  # owned by a controller we don't manage
            if pod.spec.node_name == "" and pod.status.phase == "Pending":
                logger.info("driver pod %s has no NodeName, skipping",
                            pod.metadata.name)
                continue
            node = self._nodes.get(pod.spec.node_name)
            if node is None:
                node = provider.get_node(pod.spec.node_name)
                self._nodes[pod.spec.node_name] = node
            entry = NodeUpgradeState(node=node, driver_pod=pod,
                                     driver_daemonset=owner)
            label = node.metadata.labels.get(self._mgr.keys.state_label,
                                             UpgradeState.UNKNOWN)
            state.node_states.setdefault(label, []).append(entry)
        return state


class ClusterUpgradeStateManager:
    """Reference ClusterUpgradeStateManagerImpl (:104-151) with its five
    injected action managers, builder options WithPodDeletionEnabled /
    WithValidationEnabled (:155-176), and a pluggable NodeGrouper."""

    def __init__(self, client: Client, keys: KeyFactory,
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 grouper: Optional[NodeGrouper] = None,
                 group_policy: Optional[GroupPolicy] = None,
                 synchronous: bool = False,
                 state_provider: Optional[NodeUpgradeStateProvider] = None,
                 cordon_manager: Optional[CordonManager] = None,
                 drain_manager: Optional[DrainManager] = None,
                 pod_manager: Optional[PodManager] = None,
                 validation_manager: Optional[ValidationManager] = None,
                 safe_load_manager: Optional[SafeDriverLoadManager] = None,
                 sibling_keys: Optional[List[KeyFactory]] = None,
                 metrics=None, tracer=None,
                 shard_workers: int = 0, shard_parallel: bool = True,
                 timeline=None):
        self.client = client
        self.keys = keys
        self.recorder = recorder
        self.clock = clock or RealClock()
        self.grouper = grouper or SingleNodeGrouper()
        self.group_policy = group_policy or GroupPolicy()
        # sharded reconcile (the O(changed) reconcile's third layer):
        # per-slice-group workers for the per-node handler work;
        # workers<=1 keeps the serial code path byte-identical,
        # shard_parallel=False runs the shard machinery deterministically
        # in order (chaos-campaign mode)
        self._sharder = ShardRunner(workers=shard_workers,
                                    parallel=shard_parallel,
                                    name=f"reconcile-{keys.component}")
        # incremental BuildState (layer 2): persists across ticks when the
        # caller hands informer deltas; verify_incremental asserts the
        # patched state equals a full rebuild every tick (the equivalence
        # oracle — tests and `fleetbench --verify-incremental` turn it on)
        self._inc: Optional[IncrementalStateBuilder] = None
        self.verify_incremental = False
        # observability (obs/): ``metrics`` (a MetricsHub) feeds the
        # phase-duration and drain-duration histograms through the provider
        # choke point and the drain manager; ``tracer`` wraps each
        # process_* handler in a child span of the caller's apply_state
        # span. Both default off (None) — zero overhead for library-only
        # consumers.
        self._tracer = tracer
        self.node_upgrade_state_provider = state_provider or NodeUpgradeStateProvider(
            client, keys, recorder, self.clock, metrics=metrics,
            timeline=timeline)
        if timeline is not None and \
                self.node_upgrade_state_provider.timeline is None:
            # injected provider: late-bind the process-wide timeline
            self.node_upgrade_state_provider.timeline = timeline
        self.cordon_manager = cordon_manager or CordonManager(client)
        self.drain_manager = drain_manager or DrainManager(
            client, self.node_upgrade_state_provider, keys, recorder, self.clock,
            synchronous=synchronous, metrics=metrics)
        self.pod_manager = pod_manager or PodManager(
            client, self.node_upgrade_state_provider, keys, None, recorder,
            self.clock, synchronous=synchronous)
        self.validation_manager = validation_manager or ValidationManager(
            client, self.node_upgrade_state_provider, keys, "", recorder, self.clock)
        self.safe_driver_load_manager = safe_load_manager or SafeDriverLoadManager(
            self.node_upgrade_state_provider, keys)
        self._pod_deletion_enabled = False
        self._validation_enabled = False
        # Multi-component coordination (no reference analog — the
        # DriverName global forbids it there, and two INDEPENDENT
        # reference operators managing different drivers can deadlock or
        # uncordon each other's nodes). ``sibling_keys`` names the OTHER
        # components managed on the same nodes; the machine then (a) does
        # not blame a cordon the sibling caused on the administrator at
        # admission (no initial-unschedulable annotation — both components
        # recording each other's cordon and skipping uncordon forever is
        # the deadlock), and (b) holds its own uncordon while a sibling
        # still needs the node down (uncordoning under a sibling's drain
        # would put a node back in service mid-upgrade). TPUOperator wires
        # this from its component list; the default (None) preserves exact
        # reference behavior.
        self._sibling_keys = list(sibling_keys or [])

    # ------------------------------------------------------ builder options

    def with_pod_deletion_enabled(self, deletion_filter: PodDeletionFilter
                                  ) -> "ClusterUpgradeStateManager":
        """WithPodDeletionEnabled (:155-165): turn on the optional
        pod-deletion state with the consumer-supplied filter."""
        self.pod_manager._filter = deletion_filter
        self._pod_deletion_enabled = True
        return self

    def with_validation_enabled(self, pod_selector: str
                                ) -> "ClusterUpgradeStateManager":
        """WithValidationEnabled (:167-176): turn on the optional validation
        state; pods matching ``pod_selector`` must become Ready."""
        self.validation_manager._selector = pod_selector
        self._validation_enabled = True
        return self

    def is_pod_deletion_enabled(self) -> bool:
        return self._pod_deletion_enabled

    def is_validation_enabled(self) -> bool:
        return self._validation_enabled

    # ----------------------------------------------------------- BuildState

    def build_state(self, namespace: str, driver_labels: Dict[str, str],
                    deltas: Optional[dict] = None) -> ClusterUpgradeState:
        """BuildState (:214-279): the cluster joined into per-state buckets.

        Without ``deltas`` (the default, and every direct test caller):
        a stateless point-in-time full rebuild, exactly the reference.
        With ``deltas`` (a ``CachedClient.drain_deltas()`` result, handed
        down by the reconcile loop): the state PERSISTS across ticks and
        is patched from what actually changed — a full rebuild happens
        only on the first tick, after an informer re-list/resync, or when
        the scope changed. Either way every read is a cached-store lookup
        when the client is informer-backed; ``deltas`` additionally makes
        the per-tick python work O(changed)+O(pods-rebucket) instead of
        O(fleet) joins."""
        self.pod_manager.reset_revision_cache()
        if deltas is None:
            self._inc = None
            return self._build_state_full(namespace, driver_labels)
        if self._inc is None or not self._inc.matches(namespace,
                                                      driver_labels):
            self._inc = IncrementalStateBuilder(self, namespace,
                                                driver_labels)
        self._inc.refresh(deltas)
        state = self._inc.assemble()
        if self.verify_incremental:
            full = self._build_state_full(namespace, driver_labels)
            if state_fingerprint(full) != state_fingerprint(state):
                self._inc = None  # resync from scratch next tick
                raise BuildStateError(
                    "incremental BuildState diverged from full rebuild "
                    "(equivalence oracle)")
        return state

    def _build_state_full(self, namespace: str,
                          driver_labels: Dict[str, str]
                          ) -> ClusterUpgradeState:
        """The reference full rebuild: finds driver DaemonSets + pods by
        label, joins each pod with its node, buckets by the node's current
        state label. Orphaned pods (no owner DaemonSet) are collected too
        (:250-251). Errors out if a DaemonSet has unscheduled pods
        (:241-248)."""
        state = ClusterUpgradeState()
        daemonsets = {ds.metadata.uid: ds for ds in self.client.list_daemonsets(
            namespace=namespace, label_selector=driver_labels)}
        pods = self.client.list_pods(namespace=namespace,
                                     label_selector=driver_labels)

        filtered: List[Pod] = []
        for ds in daemonsets.values():
            ds_pods = [p for p in pods
                       if p.metadata.owner_references
                       and p.metadata.owner_references[0].uid == ds.metadata.uid]
            if ds.status.desired_number_scheduled != len(ds_pods):
                raise BuildStateError(
                    f"driver DaemonSet {ds.metadata.name} should not have "
                    f"Unscheduled pods (desired "
                    f"{ds.status.desired_number_scheduled}, got {len(ds_pods)})")
            filtered.extend(ds_pods)
        # orphaned driver pods are first-class (:341-355)
        filtered.extend(p for p in pods if not p.metadata.owner_references)

        for pod in filtered:
            owner = (daemonsets.get(pod.metadata.owner_references[0].uid)
                     if pod.metadata.owner_references else None)
            if pod.spec.node_name == "" and pod.status.phase == "Pending":
                logger.info("driver pod %s has no NodeName, skipping",
                            pod.metadata.name)
                continue
            node = self.node_upgrade_state_provider.get_node(pod.spec.node_name)
            ns = NodeUpgradeState(node=node, driver_pod=pod, driver_daemonset=owner)
            label = node.metadata.labels.get(self.keys.state_label,
                                             UpgradeState.UNKNOWN)
            state.node_states.setdefault(label, []).append(ns)
        return state

    # ------------------------------------------------------------ ApplyState

    def apply_state(self, current_state: ClusterUpgradeState,
                    upgrade_policy: Optional[DriverUpgradePolicySpec]) -> None:
        """ApplyState (:364-484): one stateless, idempotent pass of the
        fixed-order pipeline."""
        if current_state is None:
            raise ValueError("currentState should not be empty")
        if upgrade_policy is None or not upgrade_policy.auto_upgrade:
            logger.info("driver auto upgrade is disabled, skipping")
            return

        total_nodes = self.get_total_managed_nodes(current_state)
        max_unavailable = total_nodes
        if upgrade_policy.max_unavailable is not None:
            max_unavailable = scaled_int_or_percent(
                upgrade_policy.max_unavailable, total_nodes, round_up=True)

        upgrades_available = self.get_upgrades_available(
            current_state, upgrade_policy.max_parallel_upgrades, max_unavailable)

        logger.info(
            "upgrades in progress=%d available=%d unavailable=%d total=%d "
            "maxUnavailable=%d",
            self.get_upgrades_in_progress(current_state), upgrades_available,
            self.get_current_unavailable_nodes(current_state), total_nodes,
            max_unavailable)

        groups = build_group_views(current_state, self.grouper)

        # each handler pass is a child span of the caller's apply_state
        # span (tpu/operator.py) — the per-phase breakdown an on-call
        # operator needs to see WHERE a slow tick spent its time
        with self._span("process_done_or_unknown_nodes"):
            self.process_done_or_unknown_nodes(current_state, UpgradeState.UNKNOWN)
            self.process_done_or_unknown_nodes(current_state, UpgradeState.DONE)
        with self._span("process_upgrade_required_nodes"):
            self.process_upgrade_required_nodes(current_state, upgrades_available,
                                                groups, max_unavailable)
        with self._span("process_cordon_required_nodes"):
            self.process_cordon_required_nodes(current_state)
        with self._span("process_wait_for_jobs_required_nodes"):
            self.process_wait_for_jobs_required_nodes(
                current_state, upgrade_policy.wait_for_completion)
        drain_enabled = (upgrade_policy.drain is not None
                         and upgrade_policy.drain.enable)
        with self._span("process_pod_deletion_required_nodes"):
            self.process_pod_deletion_required_nodes(
                current_state, upgrade_policy.pod_deletion, drain_enabled)
        with self._span("process_drain_nodes"):
            self.process_drain_nodes(current_state, upgrade_policy.drain, groups)
        with self._span("process_pod_restart_nodes"):
            self.process_pod_restart_nodes(current_state, groups)
        with self._span("process_upgrade_failed_nodes"):
            self.process_upgrade_failed_nodes(current_state, groups)
        with self._span("process_validation_required_nodes"):
            self.process_validation_required_nodes(current_state)
        with self._span("process_uncordon_required_nodes"):
            self.process_uncordon_required_nodes(current_state, groups)

    # ----------------------------------------------------------- handlers

    def process_done_or_unknown_nodes(self, state: ClusterUpgradeState,
                                      bucket_name: str) -> None:
        """ProcessDoneOrUnknownNodes (:488-550): decide upgrade-required vs
        done per node, from pod-vs-DS revision hash, the upgrade-requested
        annotation, or the safe-load handshake. The per-node decisions are
        pure reads — sharded across slice-group workers; the transitions
        stay batched on the calling thread."""

        def decide(items: List[NodeUpgradeState]):
            plain: List[Node] = []
            cordoned: List[Node] = []
            done: List[Node] = []
            for ns in items:
                is_synced, is_orphaned = self._pod_in_sync_with_ds(ns)
                is_requested = self._is_upgrade_requested(ns.node)
                waiting_safe_load = (
                    self.safe_driver_load_manager
                    .is_waiting_for_safe_driver_load(ns.node))
                if ((not is_synced and not is_orphaned)
                        or waiting_safe_load or is_requested):
                    # Remember pre-upgrade unschedulable state so uncordon
                    # can be skipped at the end (:512-523); batched with the
                    # state label into one patch + one cache barrier. A
                    # cordon attributable to a sibling component's in-flight
                    # upgrade is TRANSIENT — recording it would make this
                    # component skip uncordon too (mutual-skip deadlock when
                    # both see each other's cordon).
                    if (ns.node.spec.unschedulable
                            and not self._sibling_caused_cordon(ns.node)):
                        cordoned.append(ns.node)
                    else:
                        plain.append(ns.node)
                    continue
                if bucket_name == UpgradeState.UNKNOWN:
                    done.append(ns.node)
            return plain, cordoned, done

        require_plain: List[Node] = []
        require_cordoned: List[Node] = []
        to_done: List[Node] = []
        for plain, cordoned, done in self._sharder.run(
                state.bucket(bucket_name),
                key_fn=lambda ns: self.grouper.group_key(ns.node),
                work_fn=decide):
            require_plain.extend(plain)
            require_cordoned.extend(cordoned)
            to_done.extend(done)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            require_plain, UpgradeState.UPGRADE_REQUIRED)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            require_cordoned, UpgradeState.UPGRADE_REQUIRED,
            {self.keys.initial_state_annotation: TRUE_STRING})
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            to_done, UpgradeState.DONE)

    def process_upgrade_required_nodes(self, state: ClusterUpgradeState,
                                       upgrades_available: int,
                                       groups: Dict[str, GroupView],
                                       max_unavailable: int) -> None:
        """ProcessUpgradeRequiredNodes (:587-631), group-aware.

        Admission is per *group*: a group is admitted only when every member
        is in upgrade-required (slice atomicity), and consumes one throttle
        slot per member node. Already-cordoned nodes bypass the throttle
        (:606-616); the upgrade-requested annotation is cleared on
        processing (:594-600). An `upgrade.skip`-labeled node is skipped
        (:601-604) — and because a multi-host slice cannot atomically
        upgrade *around* one host, a skip label on ANY member holds the
        WHOLE group in upgrade-required with a Warning event (the
        single-node case degenerates to exact reference behavior).
        Oversized-group deadlock is broken per GroupPolicy (SURVEY §7.4)."""
        bucket = state.bucket(UpgradeState.UPGRADE_REQUIRED)
        in_progress = self.get_upgrades_in_progress(state)
        unavailable = self.get_current_unavailable_nodes(state)
        # admission decisions fan out across slice-group shards; the
        # maxUnavailable budget stays ONE locked accountant so concurrent
        # shards can never over-admit (upgrade/sharding.py)
        accountant = BudgetAccountant(upgrades_available)

        def admit_groups(items: List[NodeUpgradeState]) -> List[Node]:
            admitted: List[Node] = []
            processed: set = set()
            for ns in items:
                if self._is_upgrade_requested(ns.node):
                    self.node_upgrade_state_provider.change_node_upgrade_annotation(
                        ns.node, self.keys.upgrade_requested_annotation, NULL)
                key = self.grouper.group_key(ns.node)
                if key in processed:
                    continue
                processed.add(key)
                group = groups[key]
                # The skip check is group-scoped, not node-scoped: checking
                # only the per-node label would let admission triggered by a
                # sibling member cordon the skipped host anyway (the group
                # collects members by state label alone below).
                skip_nodes = [m.node.metadata.name for m in group.members
                              if self._skip_node_upgrade(m.node)]
                if skip_nodes:
                    if group.size == 1:
                        logger.info("node %s is marked for skipping upgrades",
                                    ns.node.metadata.name)
                    else:
                        logger.warning(
                            "group %s held in upgrade-required: member "
                            "node(s) %s carry the %s=true skip label and a "
                            "multi-host slice upgrades atomically",
                            group.key, ",".join(skip_nodes),
                            self.keys.skip_node_label)
                        log_event(
                            self.recorder, ns.node, "Warning",
                            self.keys.event_reason,
                            f"Holding upgrade of group {group.key}: node(s) "
                            f"{','.join(skip_nodes)} carry the "
                            f"{self.keys.skip_node_label}=true label; a "
                            f"multi-host slice cannot upgrade around one "
                            f"host — remove the label to resume")
                    continue
                # Slice atomicity: a group may start only when every
                # member's intent is known — members are upgrade-required
                # themselves, already current (done: they'll wait at the
                # group barriers), or already in progress (group already
                # started; let stragglers join so it converges). Any member
                # still unknown blocks the group for this pass.
                if group.any_in((UpgradeState.UNKNOWN,)):
                    continue
                # Slice completeness (SURVEY §7.4): when the grouper knows
                # the group's true size from topology metadata, refuse to
                # admit a partial view — the unseen hosts would be restarted
                # later, breaking atomicity. The group stays in
                # upgrade-required until every host is visible.
                expected = self.grouper.expected_group_size(ns.node)
                if expected is not None and group.size != expected:
                    logger.warning(
                        "group %s: observed %d member nodes but topology "
                        "implies %d hosts — refusing to admit a partial "
                        "slice view", group.key, group.size, expected)
                    log_event(
                        self.recorder, ns.node, "Warning",
                        self.keys.event_reason,
                        f"Refusing to start upgrade of group {group.key}: "
                        f"only {group.size} of {expected} member hosts are "
                        f"visible")
                    continue
                members = [m for m, s in zip(group.members,
                                             group.member_states)
                           if s == UpgradeState.UPGRADE_REQUIRED]
                if not members:
                    continue
                all_cordoned = all(m.node.spec.unschedulable
                                   for m in members)
                # Budget is charged per node admitted, cordoned or not (the
                # reference decrements upgradesAvailable for every node it
                # moves to cordon-required, :621-624).
                admit = accountant.try_reserve(len(members))
                if not admit and all_cordoned:
                    # already-cordoned nodes progress even with no slots
                    # (reference :606-616); for an atomic group this bypass
                    # applies only when *all* pending members are cordoned —
                    # still charged, like the reference's decrement.
                    accountant.force_reserve(len(members))
                    admit = True
                if (not admit and len(members) > 1
                        and self.group_policy.allow_oversized_group):
                    # Deadlock breaker (SURVEY §7.4): a multi-node group
                    # that can never fit the budget (e.g. a v5e-16 slice vs
                    # maxParallel=1, or vs maxUnavailable=25% of a small
                    # pool) may start when the cluster is otherwise quiet —
                    # nothing in progress, nothing unavailable beyond this
                    # group's own pre-cordoned members, and nothing else
                    # admitted this pass (atomic under the accountant).
                    cordoned = sum(1 for m in members
                                   if m.node.spec.unschedulable)
                    admit = accountant.try_admit_oversized(
                        in_progress == 0 and unavailable - cordoned == 0)
                if admit:
                    admitted.extend(m.node for m in members)
            return admitted

        to_cordon = self._sharder.run_flat(
            bucket, key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=admit_groups)
        # one batched transition + one cache barrier for every admitted
        # group (the serial code paid a patch-all + barrier per group)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            to_cordon, UpgradeState.CORDON_REQUIRED)

    def process_cordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """ProcessCordonRequiredNodes (:635-654): cordon patches fan out
        across slice-group shards; the state transition stays one batch."""

        def cordon(items: List[NodeUpgradeState]) -> List[Node]:
            done: List[Node] = []
            for ns in items:
                self.cordon_manager.cordon(ns.node)
                done.append(ns.node)
            return done

        cordoned = self._sharder.run_flat(
            state.bucket(UpgradeState.CORDON_REQUIRED),
            key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=cordon)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            cordoned, UpgradeState.WAIT_FOR_JOBS_REQUIRED)

    def process_wait_for_jobs_required_nodes(
            self, state: ClusterUpgradeState,
            wait_spec) -> None:
        """ProcessWaitForJobsRequiredNodes (:658-693)."""
        bucket = state.bucket(UpgradeState.WAIT_FOR_JOBS_REQUIRED)
        if wait_spec is None or not wait_spec.pod_selector:
            next_state = (UpgradeState.POD_DELETION_REQUIRED
                          if self._pod_deletion_enabled
                          else UpgradeState.DRAIN_REQUIRED)
            self.node_upgrade_state_provider.change_nodes_state_and_annotations(
                [ns.node for ns in bucket], next_state)
            return
        if not bucket:
            return
        self.pod_manager.schedule_check_on_pod_completion(PodManagerConfig(
            nodes=[ns.node for ns in bucket], wait_for_completion_spec=wait_spec))

    def process_pod_deletion_required_nodes(self, state: ClusterUpgradeState,
                                            deletion_spec,
                                            drain_enabled: bool) -> None:
        """ProcessPodDeletionRequiredNodes (:698-727)."""
        bucket = state.bucket(UpgradeState.POD_DELETION_REQUIRED)
        if not self._pod_deletion_enabled:
            self.node_upgrade_state_provider.change_nodes_state_and_annotations(
                [ns.node for ns in bucket], UpgradeState.DRAIN_REQUIRED)
            return
        if not bucket:
            return
        self.pod_manager.schedule_pod_eviction(PodManagerConfig(
            nodes=[ns.node for ns in bucket], deletion_spec=deletion_spec,
            drain_enabled=drain_enabled))

    def process_drain_nodes(self, state: ClusterUpgradeState, drain_spec,
                            groups: Dict[str, GroupView]) -> None:
        """ProcessDrainNodes (:731-760). Drain itself is per-node and may
        proceed concurrently across a group — the *barrier* is before pod
        restart, not before drain (all members are already cordoned)."""
        bucket = state.bucket(UpgradeState.DRAIN_REQUIRED)
        if drain_spec is None or not drain_spec.enable:
            self.node_upgrade_state_provider.change_nodes_state_and_annotations(
                [ns.node for ns in bucket], UpgradeState.POD_RESTART_REQUIRED)
            return
        if not bucket:
            return
        # sharded: in synchronous mode each shard drains its slice groups
        # in parallel instead of serializing the whole wave (the drain
        # manager's own StringSet already dedups in-flight nodes); async
        # mode spawns per-node workers either way
        self._sharder.run(
            bucket, key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=lambda items: self.drain_manager.schedule_nodes_drain(
                DrainConfiguration(spec=drain_spec,
                                   nodes=[ns.node for ns in items])))

    def process_pod_restart_nodes(self, state: ClusterUpgradeState,
                                  groups: Dict[str, GroupView]) -> None:
        """ProcessPodRestartNodes (:764-831) with the group restart barrier:
        in an atomic group, no driver pod restarts until every member host is
        drained (at or past pod-restart-required) — the new libtpu must come
        up against a quiesced ICI domain. Sharded per slice group (the
        barrier is group-local, so a shard owns every input to it)."""

        def check(items: List[NodeUpgradeState]):
            restart: List[Pod] = []
            validate: List[Node] = []
            uncordon: List[Node] = []
            for ns in items:
                if self.group_policy.atomic:
                    group = groups[self.grouper.group_key(ns.node)]
                    if not group.all_in(AT_OR_PAST_POD_RESTART):
                        logger.info(
                            "node %s waiting at group restart barrier "
                            "(group %s)", ns.node.metadata.name, group.key)
                        continue
                is_synced, is_orphaned = self._pod_in_sync_with_ds(ns)
                if not is_synced or is_orphaned:
                    # restart only if not already terminating (:773-781)
                    if ns.driver_pod.metadata.deletion_timestamp is None:
                        restart.append(ns.driver_pod)
                    continue
                # pod is in sync: unblock safe driver load (:783-788)
                self.safe_driver_load_manager.unblock_loading(ns.node)
                if self._is_driver_pod_in_sync(ns):
                    if not self._validation_enabled:
                        uncordon.append(ns.node)
                        continue
                    validate.append(ns.node)
                else:
                    if not self._is_driver_pod_failing(ns.driver_pod):
                        continue  # still coming up; check next reconcile
                    logger.info("driver pod failing on node %s with "
                                "repeated restarts", ns.node.metadata.name)
                    self.node_upgrade_state_provider.change_node_upgrade_state(
                        ns.node, UpgradeState.FAILED)
            return restart, validate, uncordon

        pods_to_restart: List[Pod] = []
        to_validation: List[Node] = []
        to_uncordon: List[Node] = []
        for restart, validate, uncordon in self._sharder.run(
                state.bucket(UpgradeState.POD_RESTART_REQUIRED),
                key_fn=lambda ns: self.grouper.group_key(ns.node),
                work_fn=check):
            pods_to_restart.extend(restart)
            to_validation.extend(validate)
            to_uncordon.extend(uncordon)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            to_validation, UpgradeState.VALIDATION_REQUIRED)
        self._update_nodes_to_uncordon_or_done_state(to_uncordon)
        self.pod_manager.schedule_pods_restart(pods_to_restart)

    def process_upgrade_failed_nodes(self, state: ClusterUpgradeState,
                                     groups: Optional[Dict[str, GroupView]]
                                     = None) -> None:
        """ProcessUpgradeFailedNodes (:835-877): auto-recovery — once the
        driver pod is back in sync and Ready (after manual intervention per
        docs/automatic-ofed-upgrade.md:89-98), promote to uncordon/done.

        Extension (no reference analog; found by the chaos campaign): a
        FAILED node whose pod has RECOVERED — no longer failing, but still
        at the OLD revision — could never auto-recover: the pod-restart
        handler only walks its own bucket, and the health remediator
        defers to the in-flight pipeline ("it will restart the drivers
        anyway" — false exactly here). A transient crashloop that tripped
        the failure threshold then wedged the node (and, through the
        group uncordon barrier, its whole slice) until a human deleted
        the pod. Restart such healthy-but-outdated pods here, behind the
        same group restart barrier (quiesced ICI domain). A pod that is
        STILL failing keeps the reference's manual-intervention contract
        — auto-deleting it would retry a persistent crashloop forever."""
        if groups is None:
            groups = build_group_views(state, self.grouper)

        def recover(items: List[NodeUpgradeState]) -> List[Pod]:
            restart: List[Pod] = []
            for ns in items:
                if self._is_driver_pod_in_sync(ns):
                    self._update_node_to_uncordon_or_done_state(ns.node)
                    continue
                is_synced, is_orphaned = self._pod_in_sync_with_ds(ns)
                if is_synced and not is_orphaned:
                    continue  # right revision, not Ready yet: keep waiting
                if self._is_driver_pod_failing(ns.driver_pod):
                    continue  # still broken: manual intervention (reference)
                if ns.driver_pod.metadata.deletion_timestamp is not None:
                    continue  # already terminating
                if self.group_policy.atomic:
                    group = groups[self.grouper.group_key(ns.node)]
                    if not group.all_in(AT_OR_PAST_POD_RESTART):
                        continue  # ICI domain not quiesced yet
                logger.info("restarting recovered-but-outdated driver pod "
                            "%s on failed node %s",
                            ns.driver_pod.metadata.name,
                            ns.node.metadata.name)
                restart.append(ns.driver_pod)
            return restart

        pods_to_restart = self._sharder.run_flat(
            state.bucket(UpgradeState.FAILED),
            key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=recover)
        self.pod_manager.schedule_pods_restart(pods_to_restart)

    def process_validation_required_nodes(self, state: ClusterUpgradeState) -> None:
        """ProcessValidationRequiredNodes (:880-911), sharded: each node's
        validation is an independent pod list + per-node writes."""

        def validate(items: List[NodeUpgradeState]) -> None:
            for ns in items:
                # defensively re-unblock safe load: the driver may have
                # restarted after reaching this state (:886-893)
                self.safe_driver_load_manager.unblock_loading(ns.node)
                if not self.validation_manager.validate(ns.node):
                    continue
                self._update_node_to_uncordon_or_done_state(ns.node)

        self._sharder.run(
            state.bucket(UpgradeState.VALIDATION_REQUIRED),
            key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=validate)

    def process_uncordon_required_nodes(self, state: ClusterUpgradeState,
                                        groups: Dict[str, GroupView]) -> None:
        """ProcessUncordonRequiredNodes (:915-934) with the group uncordon
        barrier: an atomic group returns to service as a unit. Sharded per
        slice group; the barrier inputs are group-local."""

        def uncordon(items: List[NodeUpgradeState]) -> List[Node]:
            done: List[Node] = []
            for ns in items:
                if self.group_policy.atomic:
                    group = groups[self.grouper.group_key(ns.node)]
                    if not group.all_in(AT_OR_PAST_UNCORDON):
                        logger.info(
                            "node %s waiting at group uncordon barrier "
                            "(group %s)", ns.node.metadata.name, group.key)
                        continue
                if self._sibling_needs_node_down(ns.node):
                    # another managed component still needs this node out of
                    # service; retry next pass once its pipeline finishes
                    logger.info("node %s uncordon deferred: sibling "
                                "component mid-upgrade",
                                ns.node.metadata.name)
                    continue
                self.cordon_manager.uncordon(ns.node)
                done.append(ns.node)
            return done

        uncordoned = self._sharder.run_flat(
            state.bucket(UpgradeState.UNCORDON_REQUIRED),
            key_fn=lambda ns: self.grouper.group_key(ns.node),
            work_fn=uncordon)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            uncordoned, UpgradeState.DONE)

    # ------------------------------------------------------------- helpers

    def _span(self, name: str):
        """A tracer child span, or a no-op when no tracer is wired."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, component=self.keys.component)

    def _pod_in_sync_with_ds(self, ns: NodeUpgradeState):
        """podInSyncWithDS (:558-578) → (is_synced, is_orphaned)."""
        if ns.is_orphaned_pod():
            return False, True
        pod_hash = self.pod_manager.get_pod_controller_revision_hash(ns.driver_pod)
        ds_hash = self.pod_manager.get_daemonset_controller_revision_hash(
            ns.driver_daemonset)
        return pod_hash == ds_hash, False

    def _sibling_needs_node_down(self, node: Node) -> bool:
        """True while ANOTHER managed component's pipeline still requires
        this node out of service (uncordon gate)."""
        return any(node.metadata.labels.get(k.state_label) in SIBLING_BLOCKING
                   for k in self._sibling_keys)

    def _sibling_caused_cordon(self, node: Node) -> bool:
        """Admission attribution: the node's cordon is the SIBLING'S doing —
        sibling mid-pipeline AND the sibling did NOT itself record the
        cordon as pre-existing. If the sibling carries its own
        initial-unschedulable annotation, the cordon predates the sibling's
        upgrade too (an administrator's), and this component must record it
        as well or the admin's maintenance cordon would be removed when the
        pipelines finish."""
        return any(
            node.metadata.labels.get(k.state_label) in SIBLING_BLOCKING
            and k.initial_state_annotation not in node.metadata.annotations
            for k in self._sibling_keys)

    def _is_upgrade_requested(self, node: Node) -> bool:
        return (node.metadata.annotations.get(
            self.keys.upgrade_requested_annotation) == TRUE_STRING)

    def _skip_node_upgrade(self, node: Node) -> bool:
        return node.metadata.labels.get(self.keys.skip_node_label) == TRUE_STRING

    def _is_driver_pod_in_sync(self, ns: NodeUpgradeState) -> bool:
        """isDriverPodInSync (:936-964): synced hash + Running + all
        containers ready."""
        is_synced, is_orphaned = self._pod_in_sync_with_ds(ns)
        if is_orphaned:
            return False
        pod = ns.driver_pod
        return (is_synced and pod.status.phase == "Running"
                and len(pod.status.container_statuses) > 0
                and all(cs.ready for cs in pod.status.container_statuses))

    @staticmethod
    def _is_driver_pod_failing(pod: Pod) -> bool:
        """isDriverPodFailing (:966-978): any not-ready container with more
        than POD_FAILURE_RESTART_THRESHOLD restarts."""
        for cs in (list(pod.status.init_container_statuses)
                   + list(pod.status.container_statuses)):
            if not cs.ready and cs.restart_count > consts.POD_FAILURE_RESTART_THRESHOLD:
                return True
        return False

    def _update_node_to_uncordon_or_done_state(self, node: Node) -> None:
        """updateNodeToUncordonOrDoneState (:1000-1028): skip uncordon when
        the node was already unschedulable pre-upgrade."""
        new_state = UpgradeState.UNCORDON_REQUIRED
        key = self.keys.initial_state_annotation
        if key in node.metadata.annotations:
            new_state = UpgradeState.DONE
        self.node_upgrade_state_provider.change_node_state_and_annotations(
            node, new_state,
            {key: NULL} if new_state == UpgradeState.DONE else None)

    def _update_nodes_to_uncordon_or_done_state(self, nodes: List[Node]) -> None:
        """Batched :meth:`_update_node_to_uncordon_or_done_state`: splits by
        the initial-state annotation, one patch-all + barrier per split."""
        key = self.keys.initial_state_annotation
        to_uncordon = [n for n in nodes if key not in n.metadata.annotations]
        to_done = [n for n in nodes if key in n.metadata.annotations]
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            to_uncordon, UpgradeState.UNCORDON_REQUIRED)
        self.node_upgrade_state_provider.change_nodes_state_and_annotations(
            to_done, UpgradeState.DONE, {key: NULL})

    # ------------------------------------------------------------- counters

    def get_total_managed_nodes(self, state: ClusterUpgradeState) -> int:
        """GetTotalManagedNodes (:1034-1052)."""
        return sum(len(v) for v in state.node_states.values())

    def get_upgrades_in_progress(self, state: ClusterUpgradeState) -> int:
        """GetUpgradesInProgress (:1056-1062)."""
        return self.get_total_managed_nodes(state) - (
            len(state.bucket(UpgradeState.UNKNOWN))
            + len(state.bucket(UpgradeState.DONE))
            + len(state.bucket(UpgradeState.UPGRADE_REQUIRED)))

    def get_upgrades_done(self, state: ClusterUpgradeState) -> int:
        return len(state.bucket(UpgradeState.DONE))

    def get_upgrades_failed(self, state: ClusterUpgradeState) -> int:
        return len(state.bucket(UpgradeState.FAILED))

    def get_upgrades_pending(self, state: ClusterUpgradeState) -> int:
        return len(state.bucket(UpgradeState.UPGRADE_REQUIRED))

    def get_current_unavailable_nodes(self, state: ClusterUpgradeState) -> int:
        """GetCurrentUnavailableNodes (:192-211): cordoned or not-Ready."""
        unavailable = 0
        for node_states in state.node_states.values():
            for ns in node_states:
                if ns.node.spec.unschedulable or not ns.node.is_ready():
                    unavailable += 1
        return unavailable

    def get_upgrades_available(self, state: ClusterUpgradeState,
                               max_parallel_upgrades: int,
                               max_unavailable: int) -> int:
        """GetUpgradesAvailable (:1074-1102): maxParallelUpgrades==0 means
        unlimited; clamp by maxUnavailable counting current unavailable plus
        nodes about to cordon."""
        in_progress = self.get_upgrades_in_progress(state)
        total = self.get_total_managed_nodes(state)
        if max_parallel_upgrades == 0:
            available = len(state.bucket(UpgradeState.UPGRADE_REQUIRED))
        else:
            available = max_parallel_upgrades - in_progress
        current_unavailable = (self.get_current_unavailable_nodes(state)
                               + len(state.bucket(UpgradeState.CORDON_REQUIRED)))
        if available > max_unavailable:
            available = max_unavailable
        if current_unavailable >= max_unavailable:
            available = 0
        elif (max_unavailable < total
              and current_unavailable + available > max_unavailable):
            available = max_unavailable - current_unavailable
        return available
