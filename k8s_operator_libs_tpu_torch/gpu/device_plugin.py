"""NVIDIA device-plugin and driver DaemonSet recognition, and the filter
of the pods to evict before a driver upgrade.

GPU twin of the JAX package's ``tpu/device_plugin.py``. The DaemonSets an
upgrade rolls on a GPU node are the NVIDIA driver and the device plugin
(the GPU Operator's names below); the pods to evict first are the ones
holding GPUs, i.e. requesting the ``nvidia.com/gpu`` extended resource.
Pods are read by attribute (``pod.spec.resource_requests``), so the
upgrade library's own Pod objects pass unchanged.
"""

from __future__ import annotations

GPU_RESOURCE = "nvidia.com/gpu"

# The GPU Operator's labels for the managed DaemonSets; consumers may use
# their own (the upgrade library takes driver labels as input).
DEVICE_PLUGIN_LABELS = {"app": "nvidia-device-plugin-daemonset"}
DRIVER_LABELS = {"app": "nvidia-driver-daemonset"}


def pod_requests_gpu(pod) -> bool:
    return pod.spec.resource_requests.get(GPU_RESOURCE, 0) > 0


def gpu_workload_deletion_filter(pod) -> bool:
    """PodDeletionFilter for ``ClusterUpgradeStateManager.
    with_pod_deletion_enabled``: delete exactly the pods holding GPUs on
    the node."""
    return pod_requests_gpu(pod)
