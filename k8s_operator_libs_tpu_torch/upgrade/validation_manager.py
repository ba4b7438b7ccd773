"""ValidationManager (reference pkg/upgrade/validation_manager.go).

Post-upgrade validation: waits for the consumer-designated validation pods
(picked by ``pod_selector``) on the node to be Running with all containers
Ready (:71-116, :118-136). If not ready, a start-time annotation tracks how
long validation has been pending; after 600 s the node is moved to
upgrade-failed and the annotation is cleared (:32, :139-175).

A copy of the JAX package's ``upgrade/validation_manager.py``; the port
imports nothing of that package.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..core.client import Client, EventRecorder
from ..core.objects import Node, Pod
from ..utils.clock import Clock, RealClock
from . import consts
from .consts import UpgradeState
from .node_state_provider import NULL, NodeUpgradeStateProvider
from .util import KeyFactory, log_event, parse_selector

logger = logging.getLogger(__name__)


class ValidationManager:
    def __init__(self, client: Client, state_provider: NodeUpgradeStateProvider,
                 keys: KeyFactory, pod_selector: str = "",
                 recorder: Optional[EventRecorder] = None,
                 clock: Optional[Clock] = None,
                 timeout_seconds: float = consts.VALIDATION_TIMEOUT_SECONDS):
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._selector = pod_selector
        self._recorder = recorder
        self._clock = clock or RealClock()
        self._timeout = timeout_seconds

    def validate(self, node: Node) -> bool:
        """Validate (:71-116). Returns True when validation is complete.
        Empty selector → trivially done. No validation pods on the node →
        not done (and no timeout tracking, matching :85-89)."""
        if not self._selector:
            return True
        pods = self._client.direct().list_pods(
            label_selector=parse_selector(self._selector),
            field_node_name=node.metadata.name)
        if not pods:
            logger.warning("no validation pods found on node %s", node.metadata.name)
            return False
        for pod in pods:
            if not self._is_pod_ready(pod):
                self._handle_timeout(node)
                return False
        # all ready: clear the tracking annotation
        self._provider.change_node_upgrade_annotation(
            node, self._keys.validation_start_annotation, NULL)
        return True

    @staticmethod
    def _is_pod_ready(pod: Pod) -> bool:
        """isPodReady (:118-136): Running + ≥1 container + all Ready."""
        if pod.status.phase != "Running":
            return False
        if not pod.status.container_statuses:
            return False
        return all(cs.ready for cs in pod.status.container_statuses)

    def _handle_timeout(self, node: Node) -> None:
        """handleTimeout (:139-175)."""
        key = self._keys.validation_start_annotation
        now = int(self._clock.wall())
        if key not in node.metadata.annotations:
            self._provider.change_node_upgrade_annotation(node, key, str(now))
            return
        start = int(node.metadata.annotations[key])
        if now > start + self._timeout:
            self._provider.change_node_state_and_annotations(
                node, UpgradeState.FAILED, {key: NULL})
            log_event(self._recorder, node, "Warning", self._keys.event_reason,
                      "Validation timed out; node moved to upgrade-failed")
