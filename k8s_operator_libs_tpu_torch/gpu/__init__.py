"""GPU twins of the JAX package's ``tpu/`` layer: GPU Feature Discovery's
node facts and the upgrade grouping they imply (a multi-node NVLink
domain upgrades as one group, any other GPU node alone), NVIDIA
DaemonSet recognition and the GPU workload deletion filter, and a thin
scheduler that places a job on whole nodes with one rank per GPU, and
the operator (``GPUOperator``, the twin of ``tpu/operator.py``) that runs
them with fleet health, the SLO stack and the usage meter each tick.

The grouper and the deletion filter plug into the port's
``upgrade.ClusterUpgradeStateManager`` (``grouper=``,
``with_pod_deletion_enabled``); the scheduler takes any client with its
surface.
"""

from .device_plugin import (  # noqa: F401
    GPU_RESOURCE,
    gpu_workload_deletion_filter,
    pod_requests_gpu,
)
from .operator import GPUOperator, ManagedComponent  # noqa: F401
from .scheduler import GPUScheduler, GPUWorkload, Placement  # noqa: F401
from .topology import (  # noqa: F401
    CLIQUE_LABEL,
    COUNT_LABEL,
    PRODUCT_LABEL,
    GPUNodeGrouper,
    GPUNodeInfo,
    gpu_info_for_node,
)
