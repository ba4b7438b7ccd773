"""PodManager (reference pkg/upgrade/pod_manager.go).

Three jobs:
(a) wait-for-job-completion checks with a timeout tracked in a node
    annotation (ScheduleCheckOnPodCompletion / HandleTimeoutOnPodCompletions,
    pod_manager.go:259-371);
(b) filtered workload-pod eviction via the drain helper's AdditionalFilters
    (SchedulePodEviction, :125-232);
(c) driver-pod delete so the DaemonSet restarts it at the new template
    (SchedulePodsRestart, :236-254).
Plus the revision-hash getters used to decide "is the driver up to date"
(:87-121).

A copy of the JAX package's ``upgrade/pod_manager.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

from ..api.v1alpha1 import PodDeletionSpec, WaitForCompletionSpec
from ..core.client import Client, EventRecorder, NotFoundError
from ..core.drain import Helper
from ..core.objects import DaemonSet, Node, Pod
from ..utils import threads
from ..utils.clock import Clock, RealClock
from .consts import UpgradeState
from .node_state_provider import NULL, NodeUpgradeStateProvider
from .util import KeyFactory, StringSet, log_event, parse_selector

logger = logging.getLogger(__name__)

# PodDeletionFilter (pod_manager.go:76): consumer-supplied predicate choosing
# which workload pods must be deleted before the driver upgrade (e.g. "all
# pods that mount a TPU device resource").
PodDeletionFilter = Callable[[Pod], bool]

REVISION_HASH_LABEL = "controller-revision-hash"


def daemonset_revision_hash(client, ds: DaemonSet, revisions=None) -> str:
    """Latest template hash of a DaemonSet = hash label of its owned
    ControllerRevision with the highest revision (pod_manager.go:95-121).
    ``revisions`` lets callers resolving many DaemonSets reuse ONE
    namespace LIST (cmd/status.py) instead of one per DaemonSet."""
    if revisions is None:
        revisions = client.list_controller_revisions(
            namespace=ds.metadata.namespace)
    revs = [r for r in revisions
            if any(o.uid == ds.metadata.uid
                   for o in r.metadata.owner_references)]
    if not revs:
        raise ValueError(f"no ControllerRevisions for DaemonSet "
                         f"{ds.metadata.name}")
    latest = max(revs, key=lambda r: r.revision)
    return latest.metadata.labels[REVISION_HASH_LABEL]


@dataclasses.dataclass
class PodManagerConfig:
    """PodManagerConfig (pod_manager.go:63-68)."""

    nodes: List[Node]
    deletion_spec: Optional[PodDeletionSpec] = None
    wait_for_completion_spec: Optional[WaitForCompletionSpec] = None
    drain_enabled: bool = False


class PodManager:
    def __init__(self, client: Client, state_provider: NodeUpgradeStateProvider,
                 keys: KeyFactory,
                 pod_deletion_filter: Optional[PodDeletionFilter] = None,
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None, synchronous: bool = False):
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._filter = pod_deletion_filter
        self._recorder = recorder
        self._clock = clock or RealClock()
        self._in_progress = StringSet()
        self._synchronous = synchronous
        self._threads: List[object] = []
        # per-tick DaemonSet-revision-hash memo: resolving "is this driver
        # up to date" used to LIST ControllerRevisions once per NODE per
        # tick (O(fleet) — FLEET_r01 measured ~2.6k/tick at 10k nodes);
        # the hash is a per-DaemonSet fact, so the state manager clears
        # this at every BuildState and each DS resolves exactly once
        self._rev_hash_memo: dict = {}
        self._rev_hash_lock = threads.make_lock("pod-manager-rev-memo")

    # ----------------------------------------------------- revision hashes

    def get_pod_controller_revision_hash(self, pod: Pod) -> str:
        """Pod's template hash from its controller-revision-hash label
        (pod_manager.go:87-93)."""
        try:
            return pod.metadata.labels[REVISION_HASH_LABEL]
        except KeyError:
            raise ValueError(
                f"pod {pod.metadata.name} has no {REVISION_HASH_LABEL} label")

    def reset_revision_cache(self) -> None:
        """Invalidate the per-tick DS-revision memo (called at every
        BuildState, so a revision bump is seen next tick at the latest —
        the same freshness an informer-cached read gives)."""
        with self._rev_hash_lock:
            self._rev_hash_memo = {}

    def get_daemonset_controller_revision_hash(self, ds: DaemonSet) -> str:
        """Latest template hash = hash label of the owned ControllerRevision
        with the highest revision (pod_manager.go:95-121); memoized per
        tick per DaemonSet. The ControllerRevision read prefers the cached
        client (informer-backed) over ``direct()`` — a stale
        hash costs one extra reconcile, an O(fleet) LIST storm cost 2.6k
        apiserver calls per tick."""
        uid = ds.metadata.uid
        with self._rev_hash_lock:
            cached = self._rev_hash_memo.get(uid)
        if cached is not None:
            return cached
        value = daemonset_revision_hash(self._client, ds)
        with self._rev_hash_lock:
            self._rev_hash_memo[uid] = value
        return value

    # ------------------------------------------------------------ eviction

    def schedule_pod_eviction(self, config: PodManagerConfig) -> None:
        """SchedulePodEviction (:125-232): per node, delete pods matching the
        PodDeletionFilter through the drain helper; nothing to delete →
        straight to pod-restart-required (:187-191); partial/failed deletion →
        drain-required if drain enabled else upgrade-failed (:396-406)."""
        if not config.nodes:
            return
        if config.deletion_spec is None:
            raise ValueError("pod deletion spec should not be empty")
        spec = config.deletion_spec

        def custom_filter(pod: Pod):
            if self._filter is not None and not self._filter(pod):
                return (False, None)  # skip silently, like MakePodDeleteStatusSkip
            return (True, None)

        helper = Helper(
            client=self._client,
            force=spec.force,
            ignore_all_daemon_sets=True,
            delete_empty_dir_data=spec.delete_empty_dir,
            timeout_seconds=float(spec.timeout_second),
            additional_filters=[custom_filter],
            clock=self._clock,
        )

        for node in config.nodes:
            if not self._in_progress.add_if_absent(node.metadata.name):
                logger.info("node %s already getting pods deleted, skipping",
                            node.metadata.name)
                continue
            if self._synchronous:
                self._evict_one(helper, node, config.drain_enabled)
            else:
                t = threads.spawn(f"evict-{node.metadata.name}",
                                  self._evict_one,
                                  args=(helper, node, config.drain_enabled),
                                  start=False)
                self._threads.append(t)
                t.start()

    def _evict_one(self, helper: Helper, node: Node, drain_enabled: bool) -> None:
        name = node.metadata.name
        try:
            pods = self._client.direct().list_pods(field_node_name=name)
            # completed pods are not deletable (the drain helper skips
            # Succeeded/Failed), so they must not count as "required" either
            # or the counts below can never match
            to_delete = [p for p in pods
                         if p.status.phase not in ("Succeeded", "Failed")
                         and self._filter is not None and self._filter(p)]
            if not to_delete:
                self._provider.change_node_upgrade_state(
                    node, UpgradeState.POD_RESTART_REQUIRED)
                return
            deletable, errs = helper.get_pods_for_deletion(name)
            if len(deletable) != len(to_delete) or errs:
                logger.error("cannot delete all required pods on %s: %s", name, errs)
                self._update_node_to_drain_or_failed(node, drain_enabled)
                return
            try:
                helper.delete_or_evict_pods(deletable)
            except Exception as exc:  # exc: allow — any eviction failure routes the node to drain-failed handling
                logger.error("failed to delete pods on node %s: %s", name, exc)
                log_event(self._recorder, node, "Warning", self._keys.event_reason,
                          f"Failed to delete workload pods on the node for the "
                          f"driver upgrade, {exc}")
                self._update_node_to_drain_or_failed(node, drain_enabled)
                return
            self._provider.change_node_upgrade_state(
                node, UpgradeState.POD_RESTART_REQUIRED)
            log_event(self._recorder, node, "Normal", self._keys.event_reason,
                      "Deleted workload pods on the node for the driver upgrade")
        finally:
            self._in_progress.remove(name)

    def _update_node_to_drain_or_failed(self, node: Node, drain_enabled: bool) -> None:
        next_state = UpgradeState.FAILED
        if drain_enabled:
            log_event(self._recorder, node, "Warning", self._keys.event_reason,
                      "Pod deletion failed but drain is enabled in spec. "
                      "Will attempt a node drain")
            next_state = UpgradeState.DRAIN_REQUIRED
        self._provider.change_node_upgrade_state(node, next_state)

    # ------------------------------------------------------------- restart

    def schedule_pods_restart(self, pods: List[Pod]) -> None:
        """SchedulePodsRestart (:236-254): plain delete of each outdated
        driver pod; the DaemonSet controller recreates it at the new
        template. A pod already gone counts as restarted (deliberate
        deviation from the reference's plain Delete: the cached snapshot
        can trail a delete the previous operator incarnation issued before
        crashing, and re-failing the pass on NotFound just burns a
        reconcile — the desired state is achieved either way)."""
        client = self._client.direct()
        for pod in pods:
            logger.info("deleting driver pod %s", pod.metadata.name)
            try:
                client.delete_pod(pod.metadata.namespace, pod.metadata.name)
            except NotFoundError:
                logger.info("driver pod %s already gone", pod.metadata.name)
            except Exception as exc:
                log_event(self._recorder, pod, "Warning", self._keys.event_reason,
                          f"Failed to restart driver pod {exc}")
                raise

    # ------------------------------------------------- completion checking

    def schedule_check_on_pod_completion(self, config: PodManagerConfig) -> None:
        """ScheduleCheckOnPodCompletion (:259-321): per node, if no selected
        workload pod is Running/Pending, clear the start-time annotation and
        advance to pod-deletion-required; otherwise apply the timeout logic.
        Blocks until all nodes are checked (WaitGroup in the reference)."""
        spec = config.wait_for_completion_spec
        assert spec is not None
        selector = parse_selector(spec.pod_selector)
        key = self._keys.wait_for_completion_start_annotation
        if self._synchronous:
            # batch the advancing nodes: one patch-all + one cache barrier
            advancing: List[Node] = []
            for node in config.nodes:
                pods = self._client.direct().list_pods(
                    label_selector=selector, field_node_name=node.metadata.name)
                if self._check_one(node, pods, spec, defer=True):
                    advancing.append(node)
            self._provider.change_nodes_state_and_annotations(
                advancing, UpgradeState.POD_DELETION_REQUIRED, {key: NULL})
            return
        workers = []
        for node in config.nodes:
            pods = self._client.direct().list_pods(
                label_selector=selector, field_node_name=node.metadata.name)
            worker = threads.spawn(f"podcheck-{node.metadata.name}",
                                   self._check_one, args=(node, pods, spec))
            workers.append(worker)
        for t in workers:
            t.join()

    def _check_one(self, node: Node, pods: List[Pod],
                   spec: WaitForCompletionSpec, defer: bool = False) -> bool:
        """Returns True when the node is ready to advance; with ``defer``
        the caller performs the (batched) state write."""
        running = any(self.is_pod_running_or_pending(p) for p in pods)
        key = self._keys.wait_for_completion_start_annotation
        if running:
            if spec.timeout_second != 0:
                self.handle_timeout_on_pod_completions(node, spec.timeout_second)
            return False
        if not defer:
            self._provider.change_node_state_and_annotations(
                node, UpgradeState.POD_DELETION_REQUIRED, {key: NULL})
        return True

    def handle_timeout_on_pod_completions(self, node: Node,
                                          timeout_seconds: int) -> None:
        """HandleTimeoutOnPodCompletions (:334-371). Uses Unix wall time in
        the annotation like the reference (portable across operator
        restarts); the injected clock offsets it for simulation."""
        key = self._keys.wait_for_completion_start_annotation
        now = int(self._clock.wall())
        if key not in node.metadata.annotations:
            self._provider.change_node_upgrade_annotation(node, key, str(now))
            return
        start = int(node.metadata.annotations[key])
        if now > start + timeout_seconds:
            self._provider.change_node_state_and_annotations(
                node, UpgradeState.POD_DELETION_REQUIRED, {key: NULL})

    @staticmethod
    def is_pod_running_or_pending(pod: Pod) -> bool:
        """IsPodRunningOrPending (:374-394)."""
        return pod.status.phase in ("Running", "Pending")

    def wait_idle(self, timeout: float = 30.0) -> None:
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
