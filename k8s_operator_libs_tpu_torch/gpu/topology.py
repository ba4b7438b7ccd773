"""GPU node facts from GPU Feature Discovery's labels, and the upgrade
grouping they imply.

GPU twin of the JAX package's ``tpu/topology.py``. GPU Feature Discovery
(GFD, part of the NVIDIA GPU Operator) labels each GPU node:

- ``nvidia.com/gpu.product``: e.g. ``NVIDIA-H100-80GB-HBM3``;
- ``nvidia.com/gpu.count``: the node's GPUs, e.g. ``8``;
- ``nvidia.com/gpu.clique``: on nodes whose GPUs share a multi-node
  NVLink domain (GB200 NVL72 racks), ``<cluster uuid>.<clique id>``.

What a TPU slice is to the reference (one ICI failure domain: its hosts
cordon, drain, upgrade and uncordon together), a clique is here: its
nodes form one upgrade group. Every other GPU node (an H100 HGX node's 8
GPUs share NVLink inside the node only) is a group of its own, which is
the reference's per-node behaviour. A clique's node count follows from
the NVLink domain of its product (:data:`NVLINK_DOMAIN_GPUS`) over the
node's GPUs; for a product not in the table only the nodes observed
define the group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PRODUCT_LABEL = "nvidia.com/gpu.product"
COUNT_LABEL = "nvidia.com/gpu.count"
CLIQUE_LABEL = "nvidia.com/gpu.clique"

# GPUs per multi-node NVLink domain, by product prefix (GB200 and GB300
# NVL72: 18 compute trays of 4 GPUs)
NVLINK_DOMAIN_GPUS = {"NVIDIA-GB200": 72, "NVIDIA-GB300": 72}


@dataclasses.dataclass(frozen=True)
class GPUNodeInfo:
    """What a node's GFD labels say about its GPUs."""

    product: str                 # e.g. NVIDIA-H100-80GB-HBM3
    gpus: int                    # GPUs on the node
    clique: Optional[str]        # its multi-node NVLink domain, if any
    clique_nodes: Optional[int]  # nodes that domain holds, where known

    @property
    def multi_node(self) -> bool:
        return self.clique is not None


def domain_gpus(product: str) -> Optional[int]:
    """GPUs in one multi-node NVLink domain of ``product``, or None."""
    for prefix, gpus in NVLINK_DOMAIN_GPUS.items():
        if product.startswith(prefix):
            return gpus
    return None


def gpu_info_for_node(node) -> Optional[GPUNodeInfo]:
    """GPUNodeInfo from a node's GFD labels; None for a node without
    them. Raises ValueError on a GPU count that is not a positive
    integer."""
    labels = node.metadata.labels
    product = labels.get(PRODUCT_LABEL)
    count = labels.get(COUNT_LABEL)
    if not product or not count:
        return None
    try:
        gpus = int(count)
    except ValueError:
        gpus = 0
    if gpus < 1:
        raise ValueError(f"node {node.metadata.name}: invalid "
                         f"{COUNT_LABEL} {count!r}")
    clique = labels.get(CLIQUE_LABEL) or None
    domain = domain_gpus(product) if clique else None
    return GPUNodeInfo(product=product, gpus=gpus, clique=clique,
                       clique_nodes=max(1, domain // gpus) if domain
                       else None)


class GPUNodeGrouper:
    """Groups a clique's nodes so the upgrade state machine takes each
    NVLink domain down and back as a unit; any other node is its own
    group. The ``NodeGrouper`` surface of the JAX package's
    ``upgrade/groups.py`` (``group_key``, ``expected_group_size``),
    duck-typed: pass it as ``ClusterUpgradeStateManager(grouper=...)``."""

    def group_key(self, node) -> str:
        info = gpu_info_for_node(node)
        if info is None or not info.multi_node:
            return node.metadata.name
        return f"clique/{info.clique}"

    def expected_group_size(self, node) -> Optional[int]:
        """The nodes a clique's group must hold before it is admitted
        (:func:`validate_clique_membership`'s rule), where the product's
        domain is known; None otherwise."""
        info = gpu_info_for_node(node)
        if info is None or not info.multi_node:
            return None
        return info.clique_nodes


def validate_clique_membership(nodes) -> Dict[str, GPUNodeInfo]:
    """Check that every node of each clique whose size is known is
    present: a drain decision over a partial view of an NVLink domain
    would restart its missing nodes later, breaking its atomicity.
    Returns {clique: GPUNodeInfo}; raises ValueError naming a clique
    whose observed node count differs from its domain's."""
    by_clique: Dict[str, list] = {}
    infos: Dict[str, GPUNodeInfo] = {}
    for node in nodes:
        info = gpu_info_for_node(node)
        if info is None or not info.multi_node:
            continue
        by_clique.setdefault(info.clique, []).append(node)
        infos[info.clique] = info
    for clique, members in by_clique.items():
        want = infos[clique].clique_nodes
        if want is not None and len(members) != want:
            raise ValueError(
                f"clique {clique}: saw {len(members)} member nodes, its "
                f"{infos[clique].product} NVLink domain implies {want} — "
                f"refusing to act on a partial clique view")
    return infos
