"""SafeDriverLoadManager (reference pkg/upgrade/safe_driver_load_manager.go).

Safe first-load protocol (doc comment :28-43): the driver pod's init container
sets the "wait-for-safe-load" node annotation and blocks. The state manager
treats such a node as upgrade-required, cordons and drains it, and — once the
node reaches pod-restart-required with an in-sync pod — removes the annotation
to unblock driver loading instead of restarting the pod.

The same handshake lets a driver DaemonSet's init container wait until a
whole group (all hosts of one failure domain) is drained before the new
driver initializes.

A copy of the JAX package's ``upgrade/safe_driver_load_manager.py``; the
port imports nothing of that package.
"""

from __future__ import annotations

from ..core.objects import Node
from .node_state_provider import NULL, NodeUpgradeStateProvider
from .util import KeyFactory


class SafeDriverLoadManager:
    def __init__(self, state_provider: NodeUpgradeStateProvider, keys: KeyFactory):
        self._provider = state_provider
        self._keys = keys

    def is_waiting_for_safe_driver_load(self, node: Node) -> bool:
        """IsWaitingForSafeDriverLoad (:51-53): annotation non-empty."""
        return bool(node.metadata.annotations.get(self._keys.safe_load_annotation, ""))

    def unblock_loading(self, node: Node) -> None:
        """UnblockLoading (:57-71): remove the annotation (no-op if absent)."""
        if not self.is_waiting_for_safe_driver_load(node):
            return
        self._provider.change_node_upgrade_annotation(
            node, self._keys.safe_load_annotation, NULL)
