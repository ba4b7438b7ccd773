"""DrainManager — async node drain (reference pkg/upgrade/drain_manager.go).

Per node, spawns a worker thread that cordons then drains (the goroutine at
drain_manager.go:109-133); in-flight nodes are deduped via StringSet
(:98-108). Success moves the node to pod-restart-required, any failure to
upgrade-failed (:112-132). Threads outlive the ApplyState call — subsequent
reconciles see the node still in drain-required and skip it because it is
in the draining set.

A copy of the JAX package's ``upgrade/drain_manager.py``; the port
imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

from ..api.v1alpha1 import DrainSpec
from ..core.client import Client, EventRecorder
from ..core.drain import Helper
from ..core.objects import Node
from ..utils import threads
from ..utils.clock import Clock, RealClock
from .consts import UpgradeState
from .node_state_provider import NodeUpgradeStateProvider
from .util import KeyFactory, StringSet, log_event, parse_selector

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DrainConfiguration:
    """DrainConfiguration (drain_manager.go:33-36)."""

    spec: DrainSpec
    nodes: List[Node]


class DrainManager:
    def __init__(self, client: Client, state_provider: NodeUpgradeStateProvider,
                 keys: KeyFactory, recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None, synchronous: bool = False,
                 metrics=None):
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._recorder = recorder
        self._clock = clock or RealClock()
        self._metrics = metrics  # MetricsHub for drain_duration_seconds
        self._draining = StringSet()
        # synchronous=True runs drains inline — used by deterministic tests
        # and by bench.py's simulated clock (threads + FakeClock would race).
        self._synchronous = synchronous
        self._threads: List[object] = []

    @property
    def draining_nodes(self) -> StringSet:
        return self._draining

    def schedule_nodes_drain(self, config: DrainConfiguration) -> None:
        """ScheduleNodesDrain (:58-139)."""
        if not config.nodes:
            return
        if config.spec is None:
            raise ValueError("drain spec should not be empty")
        if not config.spec.enable:
            return

        helper = Helper(
            client=self._client,
            force=config.spec.force,
            ignore_all_daemon_sets=True,  # driver pods are DaemonSet-managed
            delete_empty_dir_data=config.spec.delete_empty_dir,
            timeout_seconds=float(config.spec.timeout_second),
            pod_selector=parse_selector(config.spec.pod_selector),
            clock=self._clock,
        )

        if self._synchronous:
            # Inline drains run sequentially, so batch the success
            # transitions into one patch-all + one cache barrier (async mode
            # needs no batching: per-thread barriers overlap in real time).
            drained: List[Node] = []
            for node in config.nodes:
                if not self._draining.add_if_absent(node.metadata.name):
                    logger.info("node %s already draining, skipping",
                                node.metadata.name)
                    continue
                log_event(self._recorder, node, "Normal", self._keys.event_reason,
                          "Scheduling drain of the node")
                self._drain_one(helper, node, successes=drained)
            self._provider.change_nodes_state_and_annotations(
                drained, UpgradeState.POD_RESTART_REQUIRED)
            return
        for node in config.nodes:
            if not self._draining.add_if_absent(node.metadata.name):
                logger.info("node %s already draining, skipping", node.metadata.name)
                continue
            log_event(self._recorder, node, "Normal", self._keys.event_reason,
                      "Scheduling drain of the node")
            t = threads.spawn(f"drain-{node.metadata.name}", self._drain_one,
                              args=(helper, node), start=False)
            self._threads.append(t)
            t.start()

    def _drain_one(self, helper: Helper, node: Node,
                   successes: Optional[List[Node]] = None) -> None:
        name = node.metadata.name
        try:
            try:
                helper.run_cordon_or_uncordon(name, True, node=node)
            except Exception as exc:  # exc: allow — any cordon failure routes the node to upgrade-failed (:112-118)
                logger.error("failed to cordon node %s: %s", name, exc)
                self._provider.change_node_upgrade_state(node, UpgradeState.FAILED)
                log_event(self._recorder, node, "Warning", self._keys.event_reason,
                          f"Failed to cordon the node, {exc}")
                return
            t0 = self._clock.now()
            try:
                helper.run_node_drain(name)
            except Exception as exc:  # exc: allow — any drain failure routes the node to upgrade-failed (:122-128)
                logger.error("failed to drain node %s: %s", name, exc)
                self._provider.change_node_upgrade_state(node, UpgradeState.FAILED)
                log_event(self._recorder, node, "Warning", self._keys.event_reason,
                          f"Failed to drain the node, {exc}")
                return
            if self._metrics is not None:
                self._metrics.observe(
                    "drain_duration_seconds",
                    max(0.0, self._clock.now() - t0),
                    labels={"component": self._keys.component})
            log_event(self._recorder, node, "Normal", self._keys.event_reason,
                      "Successfully drained the node")
            if successes is not None:
                successes.append(node)
            else:
                self._provider.change_node_upgrade_state(
                    node, UpgradeState.POD_RESTART_REQUIRED)
        finally:
            self._draining.remove(name)

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Join outstanding drain threads (test helper; no reference analog —
        reference tests sleep instead, drain_manager_test.go:57-92)."""
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
