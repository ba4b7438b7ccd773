"""UpgradeGroup — the scheduling unit of the state machine.

The reference schedules upgrades node-by-node (ClusterUpgradeState's
map[state][]*NodeUpgradeState, upgrade_state.go:55-62). A multi-host TPU slice
(v5e-16, v5p-64 subslice) is one ICI failure domain: taking any host down
breaks the whole slice, so its hosts must cordon → drain → upgrade → uncordon
**atomically** (SURVEY §5.7). Per SURVEY §7.2 step 4 we make the scheduling
unit an UpgradeGroup from the start:

- :class:`SingleNodeGrouper` puts every node in its own group — the state
  machine then behaves *exactly* like the reference (verified by the
  transliterated reference test suite).
- :class:`~k8s_operator_libs_tpu_torch.gpu.topology.GPUNodeGrouper` groups
  GPU nodes by their NVLink clique (GFD's ``nvidia.com/gpu.clique``), making
  each multi-node NVLink domain one group; a node with no clique is a group
  of its own.

Group-awareness enters the state machine at three points (see
upgrade_state.py):

1. **Admission**: a group starts upgrading only as a whole; throttling
   (maxParallelUpgrades / maxUnavailable) is charged per *node* but granted
   per *group*.
2. **Restart barrier**: no driver pod in a group restarts until every member
   host is drained (all members reached pod-restart-required or later) — the
   new libtpu must initialize against a fully-quiesced ICI domain.
3. **Uncordon barrier**: the slice returns to service as a unit — no member
   uncordons until all members are in uncordon-required/done. This also
   handles partial-slice failure (SURVEY §7.4): healthy members park cordoned
   until the failed member auto-recovers, then the slice uncordons together.

A copy of the JAX package's ``upgrade/groups.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional

from ..core.objects import Node
from .consts import UpgradeState

if TYPE_CHECKING:
    from .upgrade_state import ClusterUpgradeState, NodeUpgradeState


class NodeGrouper:
    """Maps a node to its upgrade-group key."""

    def group_key(self, node: Node) -> str:
        raise NotImplementedError

    def expected_group_size(self, node: Node) -> Optional[int]:
        """How many members the node's group *should* have, when the grouper
        can know it from out-of-band metadata (a slice topology label), or
        None when only observed membership defines the group. Admission uses
        this to refuse partial group views (SURVEY §7.4): acting on fewer
        hosts than the topology implies would break slice atomicity."""
        return None


class SingleNodeGrouper(NodeGrouper):
    """Reference behavior: every node is its own group."""

    def group_key(self, node: Node) -> str:
        return node.metadata.name


@dataclasses.dataclass
class GroupPolicy:
    """How groups interact with throttling.

    atomic: enforce the restart/uncordon barriers (True for TPU slices;
        SingleNodeGrouper makes them trivially satisfied either way).
    allow_oversized_group: if a group is larger than the effective
        throttle budget and *nothing else* is in progress or unavailable,
        admit it anyway. Without this a v5e-16 slice in a small pool with
        maxUnavailable=25% could never upgrade (SURVEY §7.4 deadlock).
    """

    atomic: bool = True
    allow_oversized_group: bool = True


@dataclasses.dataclass
class GroupView:
    """A group's members joined with their current state labels."""

    key: str
    members: List["NodeUpgradeState"] = dataclasses.field(default_factory=list)
    member_states: List[str] = dataclasses.field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.members)

    def all_in(self, states) -> bool:
        return all(s in states for s in self.member_states)

    def any_in(self, states) -> bool:
        return any(s in states for s in self.member_states)


# States meaning "this member has completed its drain" for the restart
# barrier: pod-restart-required itself plus everything after it.
AT_OR_PAST_POD_RESTART = (UpgradeState.POD_RESTART_REQUIRED,
                          UpgradeState.VALIDATION_REQUIRED,
                          UpgradeState.UNCORDON_REQUIRED,
                          UpgradeState.DONE,
                          UpgradeState.FAILED)

# States meaning "this member is ready to return to service" for the
# uncordon barrier.
AT_OR_PAST_UNCORDON = (UpgradeState.UNCORDON_REQUIRED, UpgradeState.DONE)


def build_group_views(cluster_state: "ClusterUpgradeState",
                      grouper: NodeGrouper) -> Dict[str, GroupView]:
    """Join every managed node with its group across all state buckets."""
    views: Dict[str, GroupView] = {}
    for state_name, node_states in cluster_state.node_states.items():
        for ns in node_states:
            key = grouper.group_key(ns.node)
            view = views.setdefault(key, GroupView(key=key))
            view.members.append(ns)
            view.member_states.append(state_name)
    return views
