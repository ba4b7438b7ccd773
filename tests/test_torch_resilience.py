"""The port's resilient client (``core/resilience.py``) held against the
JAX package's.

The reference's own tests (``tests/test_resilience.py``: the breaker,
retry and 429 pacing, the exemptions, the options, the drain and the
health monitor over the resilient client, the operator's degraded mode)
run on the port through :mod:`torch_twin`, its operator being the port's
``GPUOperator``, and its ``counting_client`` the port's
(``obs/profile.py``) where a test counts apiserver calls. Left out: the chaos campaign's blackout
and crash scenarios and the crash-point explorer of ``tools/crash``,
which drive the JAX package's operator, and ``cmd/status.py``'s view.
Then one seeded schedule of calls (reads, writes, watches, leases,
events, safety writes) against an apiserver that answers with 5xx, 429s
with and without ``retry_after`` and timeouts goes through both
packages' ``ResilientClient``, and every outcome, breaker state, clock
reading, counter and metrics text is compared with ``==``.
"""

import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

CHAOS = "the chaos campaign (its port comes with chaos/)"
CRASH = ("tools/crash's explorer, which drives the JAX package's "
         "operator")
globals().update(reference_tests(
    "test_resilience.py",
    keep=["chaos.campaign", "chaos.scenario"],
    renames=[("k8s_operator_libs_tpu_torch.tpu.operator import",
              "k8s_operator_libs_tpu_torch.gpu.operator import"),
             ("TPUOperator)\n", "GPUOperator as TPUOperator)\n")],
    exclude={"test_blackout_mid_upgrade_e2e": CHAOS,
             "test_blackout_replay_is_byte_identical": CHAOS,
             "test_operator_crash_fault_reboots_and_converges": CHAOS,
             "test_crash_registry_classifier": CRASH,
             "test_crash_plan_validation": CRASH,
             "test_crash_sweep_covers_every_registered_site": CRASH,
             "test_crash_points_converge_and_replay": CRASH,
             "test_alert_incarnation_regression_pin": CRASH,
             "test_status_resilience_view_and_banner":
                 "cmd/status.py's resilience view"}))

from k8s_operator_libs_tpu_torch.core.fakecluster import (  # noqa: E402
    FakeCluster as PortCluster)
from k8s_operator_libs_tpu_torch.upgrade.util import (  # noqa: E402
    KeyFactory as PortKeys)
from k8s_operator_libs_tpu_torch.utils.clock import (  # noqa: E402
    FakeClock as PortClock)

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}


@pytest.fixture
def clock():
    return PortClock()


@pytest.fixture
def cluster(clock):
    return PortCluster(clock=clock, cache_lag=0.5)


@pytest.fixture
def keys():
    return PortKeys("gpu")


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


class Apiserver:
    """A client whose every call draws its answer from a seeded stream:
    success, 5xx, a 429 with or without ``retry_after``, or a timeout,
    each in runs so the breaker opens and closes."""

    def __init__(self, errors, gen):
        self._errors = errors
        self._gen = gen
        self.mode = "up"
        self.calls = []

    def direct(self):
        return self

    def _answer(self, name):
        self.calls.append(name)
        r = self._gen.random()
        down = 0.9 if self.mode == "down" else 0.1
        if r < down:
            raise self._errors.ServerError(f"5xx on {name}")
        if r < down + 0.05:
            exc = self._errors.TooManyRequestsError(f"429 on {name}")
            if self._gen.random() < 0.5:
                exc.retry_after = float(self._gen.integers(1, 5))
            raise exc
        if r < down + 0.08:
            raise TimeoutError(f"timeout on {name}")
        return f"{name}-ok"

    def list_nodes(self, label_selector=None):
        return self._answer("list_nodes")

    def get_node(self, name):
        return self._answer("get_node")

    def patch_node_unschedulable(self, name, unschedulable):
        return self._answer("patch_node_unschedulable")

    def patch_node_metadata(self, name, labels=None, annotations=None):
        return self._answer("patch_node_metadata")

    def watch_nodes(self, **kw):
        return self._answer("watch_nodes")

    def get_lease(self, namespace, name):
        return self._answer("get_lease")

    def create_event(self, event, namespace="default"):
        return self._answer("create_event")


OPS = ("list_nodes", "get_node", "patch_node_unschedulable",
       "patch_node_metadata", "watch_nodes", "get_lease", "create_event",
       "safety", "probe")


def drive(side, seed, calls=300):
    clock = mod(side, "utils.clock").FakeClock(1000.0)
    errors = mod(side, "core.client")
    res_mod = mod(side, "core.resilience")
    hub = mod(side, "obs.metrics").MetricsHub()
    gen = np.random.default_rng(seed)
    api = Apiserver(errors, gen)
    res = res_mod.ResilientClient(api, clock=clock, retries=2,
                                  retry_base_s=0.5, retry_jitter=0.2,
                                  seed=seed, metrics=hub,
                                  failure_threshold=4, open_seconds=20.0)
    out = []
    for i in range(calls):
        if i % 40 == 0:
            api.mode = "down" if (i // 40) % 2 else "up"
        op = OPS[int(gen.integers(len(OPS)))]
        t0 = clock.now()
        try:
            if op == "safety":
                value = res.safety().patch_node_unschedulable("n0", False)
            elif op == "probe":
                value = res.probe()
            elif op in ("get_node", "get_lease"):
                value = getattr(res, op)(*(("n0",) if op == "get_node"
                                           else ("ns", "l")))
            elif op.startswith("patch"):
                value = getattr(res, op)("n0", False) if op.endswith(
                    "unschedulable") else getattr(res, op)(
                        "n0", labels={"a": "b"})
            elif op == "create_event":
                value = res.create_event(None)
            else:
                value = getattr(res, op)()
            outcome = ("ok", value)
        except (errors.ApiError, TimeoutError) as exc:
            outcome = (type(exc).__name__, str(exc))
        out.append((op, outcome, res.breaker.state, clock.now() - t0,
                    res.retried_total, res.shed_total, list(api.calls)))
        api.calls.clear()
        clock.advance(float(gen.integers(0, 6)))
    return out, res.payload(), hub.render(prefix="tpu_operator")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resilient_clients_answer_a_seeded_apiserver_alike(seed):
    """Each call's outcome (value, or the error's type and text), the
    breaker's state after it, the clock seconds it took (retry backoff
    and 429 pacing waits), the retry and shed counters and the calls
    that reached the apiserver; then the payload and the metrics text."""
    want, got = drive("reference", seed), drive("port", seed)
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert b == a, f"call {i}"
    assert got[1] == want[1]
    assert got[2] == want[2]
    states = {row[2] for row in got[0]}
    assert {"closed", "open"} <= states
    kinds = {row[1][0] for row in got[0]}
    assert {"ok", "ServerError", "BreakerOpenError"} <= kinds


def test_options_build_the_same_client():
    """``ResilienceOptions.from_dict`` and the client it builds agree."""
    conf = {"retries": 5, "retryBaseSeconds": 0.25, "retryMaxSeconds": 2.0,
            "breakerFailureThreshold": 3, "breakerOpenSeconds": 12.0,
            "seed": 9}
    built = {}
    for side in ROOTS:
        res_mod = mod(side, "core.resilience")
        opts = res_mod.ResilienceOptions.from_dict(conf)
        built[side] = vars(opts)
    assert built["port"] == built["reference"]


def test_method_verb_kind_equals_the_reference():
    """The call classifier the client boundary keys retries, shedding and
    exemptions on: every method name of either package's client and
    ``FakeCluster`` client, and a few odd ones, classify alike."""
    names = {"patch_node_metadata", "list_pods", "evict_pod", "watch_nodes",
             "get_lease", "create_event", "list_controller_revisions",
             "delete_pod", "update_lease", "get_job", "start", "pump",
             "drain_deltas", "direct", "list_widgets", "get", "x_y"}
    for side in ROOTS:
        fc = mod(side, "core.fakecluster").FakeCluster()
        names |= {n for n in dir(fc.client) if not n.startswith("_")}
        names |= {n for n in dir(mod(side, "core.client").Client)
                  if not n.startswith("_")}
    ref = mod("reference", "core.client").method_verb_kind
    port = mod("port", "core.client").method_verb_kind
    assert {n: port(n) for n in names} == {n: ref(n) for n in names}
