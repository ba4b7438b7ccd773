"""The port's tick profiler (``obs/profile.py``) and apiserver-call
accounting (``core/client.py:CountingClient``) held to the JAX package's
own tests (``tests/test_obs_profile.py``), run on the port through
:mod:`torch_twin` with ``GPUOperator`` where they build ``TPUOperator``
and the port's operator binary and status CLI where they load
``cmd/operator.py`` and ``cmd/status.py``; the chaos campaign's tests run
the port's ``chaos/``. The fleet benchmark's smoke test runs the JAX
package's ``tools/fleetbench.py`` and is left out.

Then one seeded reconcile schedule runs under both packages' profilers,
and every tick profile (handlers, self-times, apiserver calls by verb
and kind, critical path) and the call tallies are compared with ``==``.
"""

import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_obs_profile.py",
    keep=["tpu.topology"],
    renames=[("k8s_operator_libs_tpu_torch.tpu.operator import",
              "k8s_operator_libs_tpu_torch.gpu.operator import"),
             ("TPUOperator)\n", "GPUOperator as TPUOperator)\n"),
             ("hub.render()", 'hub.render(prefix="tpu_operator")')],
    binaries=["operator", "status"],
    exclude={
        "test_fleetbench_smoke_tiny":
            "runs tools/fleetbench.py, the JAX package's fleet benchmark, "
            "which imports that package whole (its port is a benchmark's "
            "work, ROADMAP Queue A item 6)",
    }))

from torch_operator_twin import add_ds, run_twins  # noqa: E402

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _profiled(hosts, group):
    """A twin's setup: a driver on ``hosts`` single nodes (and one
    clique/slice when ``group``), the operator reading through a
    counting client whose calls the tick profiler attributes."""
    def setup(tw):
        ds = add_ds(tw)
        for i in range(hosts):
            tw.add_host(f"z-{i}", ds)
        if group:
            tw.add_group(ds, "g0")
        tw.profiler = mod(tw.side, "obs.profile").TickProfiler()
        tracer = mod(tw.side, "obs.trace").Tracer(sink=tw.profiler,
                                                  clock=tw.clock)
        tw.counting = mod(tw.side, "obs.profile").counting_client(
            tw.cluster.client, metrics=tw.hub, tracer=tracer, clock=tw.clock)
        tw.build([("drv", tw.policy(max_parallel=2))], client=tw.counting,
                 tracer=tracer)
        tw.seen = []
    return setup


@pytest.mark.parametrize("seed", [0, 1])
def test_tick_profiles_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    hosts = int(rng.integers(2, 5))
    group = bool(seed % 2)
    bump_at = int(rng.integers(1, 3))

    def hook(tw, t):
        if t == bump_at:
            tw.cluster.bump_daemonset_revision("drv", "kube-system", "v2")

    def check(tw, t):
        tw.seen.append((tw.norm(tw.profiler.last()),
                        sorted(tw.counting.counts().items()),
                        tw.counting.total_calls()))

    twins = run_twins(_profiled(hosts, group), 14, hook=hook, check=check)
    ref, port = twins
    for t, (want, got) in enumerate(zip(ref.seen, port.seen)):
        assert got == want, f"tick {t}"
    last = port.profiler.payload()
    assert last == ref.norm(ref.profiler.payload())
    calls = {k for _, counts, _ in port.seen for k, _ in counts}
    assert ("patch", "Node") in calls and ("list", "Pod") in calls
