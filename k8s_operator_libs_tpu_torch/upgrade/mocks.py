"""Hand-written manager mocks — the consumer-facing test doubles.

The reference ships mockery-generated testify mocks for its five manager
interfaces as part of its public test surface (reference pkg/upgrade/mocks/,
wired into the state-machine suite at upgrade_suit_test.go:99-167) so that
consumers can unit-test their reconcile logic without side effects. These are
the Python equivalents: each mock records calls, returns configurable
results/errors, and — like the reference's NodeUpgradeStateProvider mock —
the state-provider mock mutates node labels/annotations *in memory only*, so
pure transition logic can be asserted without an apiserver.

A copy of the JAX package's ``upgrade/mocks.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..core.objects import Node
from .util import KeyFactory


@dataclasses.dataclass
class Call:
    method: str
    args: Tuple
    kwargs: Dict[str, Any]


class _Recording:
    def __init__(self):
        self.calls: List[Call] = []
        self.errors: Dict[str, Exception] = {}

    def _record(self, method: str, *args, **kwargs):
        self.calls.append(Call(method, args, kwargs))
        if method in self.errors:
            raise self.errors[method]

    def calls_to(self, method: str) -> List[Call]:
        return [c for c in self.calls if c.method == method]

    def fail_on(self, method: str, exc: Exception) -> None:
        """Make the named method raise (reference tests inject errors the
        same way via mockery's Return(err))."""
        self.errors[method] = exc


class MockNodeUpgradeStateProvider(_Recording):
    """In-memory label/annotation mutation (upgrade_suit_test.go:118-143)."""

    def __init__(self, keys: KeyFactory):
        super().__init__()
        self._keys = keys

    def get_node(self, name: str) -> Node:
        self._record("get_node", name)
        raise NotImplementedError("give the manager real nodes via BuildState")

    def change_node_upgrade_state(self, node: Node, new_state: str) -> None:
        self._record("change_node_upgrade_state", node.metadata.name, new_state)
        if new_state:
            node.metadata.labels[self._keys.state_label] = new_state
        else:
            node.metadata.labels.pop(self._keys.state_label, None)

    def change_node_upgrade_annotation(self, node: Node, key: str,
                                       value: str) -> None:
        self._record("change_node_upgrade_annotation", node.metadata.name,
                     key, value)
        if value == "null":
            node.metadata.annotations.pop(key, None)
        else:
            node.metadata.annotations[key] = value

    def change_node_state_and_annotations(
            self, node: Node, new_state: Optional[str] = None,
            annotations: Optional[Dict[str, str]] = None) -> None:
        self._record("change_node_state_and_annotations", node.metadata.name,
                     new_state, dict(annotations or {}))
        self._apply(node, new_state, annotations)

    def change_nodes_state_and_annotations(
            self, nodes, new_state: Optional[str] = None,
            annotations: Optional[Dict[str, str]] = None) -> None:
        nodes = list(nodes)
        if not nodes or (new_state is None and not annotations):
            return
        self._record("change_nodes_state_and_annotations",
                     [n.metadata.name for n in nodes], new_state,
                     dict(annotations or {}))
        for node in nodes:
            self._apply(node, new_state, annotations)

    def _apply(self, node: Node, new_state: Optional[str],
               annotations: Optional[Dict[str, str]]) -> None:
        if new_state is not None:
            if new_state:
                node.metadata.labels[self._keys.state_label] = new_state
            else:
                node.metadata.labels.pop(self._keys.state_label, None)
        for key, value in (annotations or {}).items():
            if value == "null":
                node.metadata.annotations.pop(key, None)
            else:
                node.metadata.annotations[key] = value


class MockCordonManager(_Recording):
    def cordon(self, node: Node) -> None:
        self._record("cordon", node.metadata.name)
        node.spec.unschedulable = True

    def uncordon(self, node: Node) -> None:
        self._record("uncordon", node.metadata.name)
        node.spec.unschedulable = False


class MockDrainManager(_Recording):
    def schedule_nodes_drain(self, config) -> None:
        self._record("schedule_nodes_drain",
                     [n.metadata.name for n in config.nodes])


class MockPodManager(_Recording):
    def __init__(self, pod_revision_hashes: Optional[Dict[str, str]] = None,
                 ds_revision_hash: str = "rev-1"):
        super().__init__()
        self.pod_revision_hashes = pod_revision_hashes or {}
        self.ds_revision_hash = ds_revision_hash
        self._filter = None

    def get_pod_controller_revision_hash(self, pod) -> str:
        self._record("get_pod_controller_revision_hash", pod.metadata.name)
        return self.pod_revision_hashes.get(
            pod.metadata.name,
            pod.metadata.labels.get("controller-revision-hash", "rev-1"))

    def get_daemonset_controller_revision_hash(self, ds) -> str:
        self._record("get_daemonset_controller_revision_hash", ds.metadata.name)
        return self.ds_revision_hash

    def schedule_pod_eviction(self, config) -> None:
        self._record("schedule_pod_eviction",
                     [n.metadata.name for n in config.nodes])

    def schedule_pods_restart(self, pods) -> None:
        self._record("schedule_pods_restart",
                     [p.metadata.name for p in pods])

    def schedule_check_on_pod_completion(self, config) -> None:
        self._record("schedule_check_on_pod_completion",
                     [n.metadata.name for n in config.nodes])


class MockValidationManager(_Recording):
    def __init__(self, result: bool = True):
        super().__init__()
        self.result = result
        self._selector = "mock"

    def validate(self, node: Node) -> bool:
        self._record("validate", node.metadata.name)
        return self.result


class MockSafeDriverLoadManager(_Recording):
    def __init__(self, keys: KeyFactory):
        super().__init__()
        self._keys = keys

    def is_waiting_for_safe_driver_load(self, node: Node) -> bool:
        self._record("is_waiting_for_safe_driver_load", node.metadata.name)
        return bool(node.metadata.annotations.get(
            self._keys.safe_load_annotation, ""))

    def unblock_loading(self, node: Node) -> None:
        self._record("unblock_loading", node.metadata.name)
        node.metadata.annotations.pop(self._keys.safe_load_annotation, None)
