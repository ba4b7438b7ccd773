"""The port's leader elector (``core/leaderelection.py``) held to the JAX
package's own tests (``tests/test_leaderelection.py``), run on the port
through :mod:`torch_twin`: the lease CAS over the port's ``FakeCluster``
and over its ``FakeAPIServer`` and ``LiveClient``, background renewal,
release and loss.

Then one seeded candidate schedule (acquire, renew, stop renewing,
release, hijack) goes through both packages' electors on fake clocks,
and the lease each tick leaves (holder, transitions, stamps) is compared
with ``==``.
"""

import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

globals().update(reference_tests("test_leaderelection.py"))

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _schedule(seed, n=60):
    """Per tick: which of three candidates ticks, and whether one
    releases or the holder's renewals stop for a while."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 3)), float(rng.random()),
             float(rng.uniform(0.5, 9.0))) for _ in range(n)]


def _run(side, schedule):
    fc = mod(side, "core.fakecluster")
    le = mod(side, "core.leaderelection")
    clock = mod(side, "utils.clock").FakeClock(1000.0)
    cluster = fc.FakeCluster(clock=clock)
    electors = [le.LeaderElector(cluster.client.direct(), "op", "ns",
                                 f"op-{i}", clock=clock)
                for i in range(3)]
    trace = []
    for who, roll, dt in schedule:
        e = electors[who]
        if roll < 0.1:
            e.release()
        else:
            e.tick()
        clock.advance(dt)
        lease = cluster.client.direct().get_lease("ns", "op")
        trace.append((who, [x.is_leader for x in electors],
                      lease.spec.holder_identity,
                      lease.spec.lease_transitions,
                      lease.spec.renew_time, lease.spec.acquire_time))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_electors_leave_the_reference_leases(seed):
    schedule = _schedule(seed)
    want = _run("reference", schedule)
    got = _run("port", schedule)
    assert got == want
    holders = {t[2] for t in got}
    assert len(holders) >= 2, "the schedule never hands the lease over"
