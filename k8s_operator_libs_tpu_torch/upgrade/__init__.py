"""The driver-upgrade state machine (a copy of the JAX package's
``upgrade/``; reference pkg/upgrade).

The consumer's reconcile loop calls
``ClusterUpgradeStateManager.build_state`` and ``apply_state`` every
tick; each node's state is a node label, so the serving tier
(``serving/pool.py``) reads the same ``UpgradeState`` values to drain a
replica before its node is cordoned. The scheduling unit is an upgrade
group: one node by default, or all nodes of one multi-node NVLink domain
with ``gpu.topology.GPUNodeGrouper``.
"""

from .consts import UpgradeState
from .util import KeyFactory, KeyedMutex, StringSet
from .node_state_provider import NodeUpgradeStateProvider
from .cordon_manager import CordonManager
from .drain_manager import DrainManager, DrainConfiguration
from .pod_manager import PodManager, PodManagerConfig
from .validation_manager import ValidationManager
from .safe_driver_load_manager import SafeDriverLoadManager
from .groups import GroupPolicy, GroupView, NodeGrouper, SingleNodeGrouper
from .upgrade_state import (ClusterUpgradeState, ClusterUpgradeStateManager,
                            NodeUpgradeState)

__all__ = ["ClusterUpgradeState", "ClusterUpgradeStateManager",
           "CordonManager", "DrainConfiguration", "DrainManager",
           "GroupPolicy", "GroupView", "KeyFactory", "KeyedMutex",
           "NodeGrouper", "NodeUpgradeState", "NodeUpgradeStateProvider",
           "PodManager", "PodManagerConfig", "SafeDriverLoadManager",
           "SingleNodeGrouper", "StringSet", "UpgradeState",
           "ValidationManager"]
