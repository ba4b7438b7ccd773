"""The port's upgrade state machine under operator crashes, held to the
JAX package's crash-resume fuzz (``tests/test_crash_resume.py``), run on
the port through :mod:`torch_twin`: a client that kills the operator
after a seeded number of writes (before or after the write lands), a
fresh manager resuming from cluster state, every fleet converging. The
slice fleet is a GB200 clique of four nodes grouped by
``GPUNodeGrouper`` (18 GPUs a node, so the product's 72-GPU NVLink
domain holds exactly the four), where the reference's is a four-host
v5e slice grouped by ``TPUSliceGrouper``.
"""

import pytest

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_crash_resume.py",
    renames=[
        ("""from k8s_operator_libs_tpu_torch.tpu.topology import (
    GKE_ACCELERATOR_LABEL,
    GKE_NODEPOOL_LABEL,
    GKE_TOPOLOGY_LABEL,
    TPUSliceGrouper,
)""", """from k8s_operator_libs_tpu_torch.gpu.topology import (
    CLIQUE_LABEL,
    COUNT_LABEL,
    PRODUCT_LABEL,
    GPUNodeGrouper,
)"""),
        ("""slice_labels = {GKE_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                    GKE_TOPOLOGY_LABEL: "4x4", GKE_NODEPOOL_LABEL: "pool-a"}""",
         """slice_labels = {PRODUCT_LABEL: "NVIDIA-GB200", COUNT_LABEL: "18",
                    CLIQUE_LABEL: "u.pool-a"}"""),
        ("grouper=TPUSliceGrouper()", "grouper=GPUNodeGrouper()")]))

from k8s_operator_libs_tpu_torch.core.fakecluster import (  # noqa: E402
    FakeCluster as PortCluster)
from k8s_operator_libs_tpu_torch.upgrade.util import (  # noqa: E402
    KeyFactory as PortKeys)
from k8s_operator_libs_tpu_torch.utils.clock import (  # noqa: E402
    FakeClock as PortClock)


@pytest.fixture
def clock():
    return PortClock()


@pytest.fixture
def cluster(clock):
    return PortCluster(clock=clock, cache_lag=0.5)


@pytest.fixture
def keys():
    return PortKeys("gpu")


def test_clique_is_one_group_of_four():
    """The renamed fleet is what the reference's slice is: one upgrade
    group whose admission needs all four nodes."""
    from k8s_operator_libs_tpu_torch.gpu.topology import (
        CLIQUE_LABEL, COUNT_LABEL, PRODUCT_LABEL, GPUNodeGrouper)
    c = PortCluster()
    labels = {PRODUCT_LABEL: "NVIDIA-GB200", COUNT_LABEL: "18",
              CLIQUE_LABEL: "u.pool-a"}
    for i in range(4):
        c.add_node(f"pool-a-h{i}", labels=labels)
    grouper = GPUNodeGrouper()
    nodes = c.client.list_nodes()
    assert {grouper.group_key(n) for n in nodes} == {"clique/u.pool-a"}
    assert {grouper.expected_group_size(n) for n in nodes} == {4}
