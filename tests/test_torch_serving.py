"""The port's serving tier (``k8s_operator_libs_tpu_torch/serving/``) held
against the JAX package's (``k8s_operator_libs_tpu/serving/``) on the CPU.

Each comparison runs one seeded scenario twice: the reference's router,
pool and runtimes (its ``BatcherRuntime`` over a JAX ``ContinuousBatcher``,
or its ``SimReplicaRuntime``), then the port's over the port's, with the
same weights (``convert.to_torch`` of one JAX tree, fp32), the same
schedule and the same drain tick. Tokens per request, the client streams,
the router's counters and its rendered ``tpu_router_*`` text must be
equal, and ``check_invariants`` empty on both at every tick.

The reference's ``FakeCluster`` client raises the reference's
``ApiError``; the port's pool catches the port's. ``PortClient`` wraps
the fake client so that it re-raises as the port's (the port's client
contract, ``serving/pool.py``).

The last test mirrors the reference's rolling-upgrade e2e over port
replicas, under the reference's operator.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_operator_libs_tpu.serving as jserving
from k8s_operator_libs_tpu import wire as jwire
from k8s_operator_libs_tpu.api.v1alpha1 import (
    DrainSpec,
    DriverUpgradePolicySpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu.core.client import ApiError as JApiError
from k8s_operator_libs_tpu.core.fakecluster import FakeCluster
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu.obs import metrics as jmetrics
from k8s_operator_libs_tpu.serving import router as jrouter
from k8s_operator_libs_tpu.serving import sim as jsim
from k8s_operator_libs_tpu.tpu.operator import ManagedComponent, TPUOperator
from k8s_operator_libs_tpu.tpu.topology import (
    GKE_ACCELERATOR_LABEL,
    GKE_NODEPOOL_LABEL,
    GKE_TOPOLOGY_LABEL,
)
from k8s_operator_libs_tpu.upgrade.consts import UpgradeState as JState
from k8s_operator_libs_tpu.upgrade.util import KeyFactory as JKeys
from k8s_operator_libs_tpu.utils.clock import FakeClock
import k8s_operator_libs_tpu_torch.serving as tserving
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch import wire as twire
from k8s_operator_libs_tpu_torch.core.client import ApiError as TApiError
from k8s_operator_libs_tpu_torch.models import paged as tpaged
from k8s_operator_libs_tpu_torch.models.generate import generate
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.obs import metrics as tmetrics
from k8s_operator_libs_tpu_torch.serving import router as trouter
from k8s_operator_libs_tpu_torch.serving import sim as tsim
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState as TState
from k8s_operator_libs_tpu_torch.upgrade.util import KeyFactory as TKeys

JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)
GEOMETRY = dict(max_slots=2, capacity_per_slot=64, block_size=8)
NODES = ("node-a", "node-b", "node-c")

WIRE_KEYS = ("KV_PAYLOAD_VERSION_ANNOTATION", "LANE_LABEL",
             "QUARANTINE_LABEL", "RECLAIM_TAINT_KEY",
             "REPLICA_ENDPOINT_ANNOTATION", "REPLICA_ID_LABEL",
             "REPLICA_WEIGHT_LABEL", "DRAIN_INTENT_ANNOTATION",
             "MIGRATION_INTENT_ANNOTATION")
STATES = ("UNKNOWN", "UPGRADE_REQUIRED", "CORDON_REQUIRED",
          "WAIT_FOR_JOBS_REQUIRED", "POD_DELETION_REQUIRED", "DRAIN_REQUIRED",
          "POD_RESTART_REQUIRED", "VALIDATION_REQUIRED", "UNCORDON_REQUIRED",
          "DONE", "FAILED", "ALL", "IN_PROGRESS")
TABLES = ("DRAIN_STATES", "LANES", "LANE_WEIGHTS", "SHED_ORDER",
          "DEFAULT_LANE", "ROUTER_PREFIX", "ROUTER_GAUGE_FAMILIES",
          "ROUTER_HISTOGRAM_FAMILIES")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    tree = jax.device_get(init_params(jax.random.PRNGKey(0), JCFG))
    return tree, convert.to_torch(tree, device="cpu")


class PortClient:
    """A reference ``FakeCluster`` client that raises the port's
    ``ApiError`` where the reference's would be raised: the port's
    client contract. ``direct()`` is wrapped the same way."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            try:
                out = attr(*args, **kwargs)
            except JApiError as exc:
                raise TApiError(str(exc)) from exc
            return PortClient(out) if name == "direct" else out
        return call


# ------------------------------------------------------------ wire keys


@pytest.mark.parametrize("name", WIRE_KEYS)
def test_wire_key_equals_the_reference(name):
    assert getattr(twire, name) == getattr(jwire, name)


@pytest.mark.parametrize("name", STATES)
def test_upgrade_state_equals_the_reference(name):
    assert getattr(TState, name) == getattr(JState, name)


@pytest.mark.parametrize("name", TABLES)
def test_serving_table_equals_the_reference(name):
    assert getattr(tserving, name) == getattr(jserving, name)


def test_keys_buckets_help_and_wire_version_equal_the_reference():
    assert TKeys("libtpu").state_label == JKeys("libtpu").state_label
    assert TKeys("gpu", domain="x.dev").state_label == \
        JKeys("gpu", domain="x.dev").state_label
    with pytest.raises(ValueError):
        TKeys("")
    assert tmetrics.QUEUE_DEPTH_BUCKETS == jmetrics.QUEUE_DEPTH_BUCKETS
    assert tmetrics.TRANSFER_BYTES_BUCKETS == jmetrics.TRANSFER_BYTES_BUCKETS
    for family in (tserving.ROUTER_GAUGE_FAMILIES
                   + tserving.ROUTER_HISTOGRAM_FAMILIES):
        assert tmetrics.HELP_TEXTS[family] == jmetrics.HELP_TEXTS[family]
    assert tsim.SIM_WIRE_VERSION == jsim.SIM_WIRE_VERSION \
        == tpaged.KV_WIRE_VERSION
    assert tserving.__all__ == jserving.__all__
    assert issubclass(TApiError, RuntimeError)


def test_serving_imports_no_jax():
    """Imported alone, the port's serving tier loads nothing of JAX or the
    JAX package."""
    code = ("import sys\n"
            "import k8s_operator_libs_tpu_torch.serving\n"
            "import k8s_operator_libs_tpu_torch.serving.router as r\n"
            "r._payload_nbytes({'kv': {'k': [0.0]}})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'k8s_operator_libs_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------- gauges


def _busy_text(runtime):
    """A runtime's metrics text with 3 requests submitted to its 2
    slots and one step taken: 2 running, 1 queued."""
    for i in range(3):
        runtime.submit([3 + i, 1, 4, 1, 5], 8)
    runtime.step()
    return runtime.metrics_text()


@pytest.mark.parametrize("kind", ["batcher", "sim"])
def test_parse_gauges_of_each_package_reads_the_others_text(weights, kind):
    tree, params = weights
    if kind == "batcher":
        # fake clocks: the timing histograms read 0 s on both sides
        texts = {"port": _busy_text(tserving.BatcherRuntime(
                     params, TCFG, clock=FakeClock(), **GEOMETRY)),
                 "reference": _busy_text(jserving.BatcherRuntime(
                     tree, JCFG, clock=FakeClock(), **GEOMETRY))}
    else:
        texts = {"port": _busy_text(tserving.SimReplicaRuntime(2)),
                 "reference": _busy_text(jserving.SimReplicaRuntime(2))}
    want = {"tpu_workload_serve_queue_depth": 1.0,
            "tpu_workload_serve_slots_busy": 2.0,
            "tpu_workload_serve_slots_total": 2.0}
    for text in texts.values():
        port, ref = tserving.parse_gauges(text), jserving.parse_gauges(text)
        assert port == ref
        for name, value in want.items():
            assert port[name] == value, (name, text)
    assert tserving.parse_gauges(texts["port"]) == \
        jserving.parse_gauges(texts["reference"])


def test_pool_scrapes_a_port_batcher_into_the_same_stats(weights):
    tree, params = weights
    stats = []
    for pkg, runtime in ((tserving, tserving.BatcherRuntime(
            params, TCFG, **GEOMETRY)), (jserving, jserving.BatcherRuntime(
                tree, JCFG, **GEOMETRY))):
        pool = pkg.ReplicaPool(clock=FakeClock())
        pool.register(pkg.Replica("r", "node-r", runtime))
        _busy_text(runtime)
        runtime.drain()
        pool.scrape()
        stats.append(dataclasses.asdict(pool.replicas["r"].stats))
    assert stats[0] == stats[1]
    assert stats[0]["draining"] and not stats[0]["stale"]


def test_payload_nbytes_equals_the_reference(weights):
    """One request exported mid-generation from a port and a JAX replica:
    the same tokens so far, and the router sizes both payloads alike."""
    tree, params = weights
    payloads = []
    for runtime in (tserving.BatcherRuntime(params, TCFG, **GEOMETRY),
                    jserving.BatcherRuntime(tree, JCFG, **GEOMETRY)):
        rid = runtime.submit([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 8)
        for _ in range(3):
            runtime.step()
        payloads.append(runtime.export_slot(rid))
    port, ref = payloads
    assert port["generated"] == ref["generated"] and \
        len(port["generated"]) == 3
    nbytes = trouter._payload_nbytes(port)
    assert nbytes == jrouter._payload_nbytes(ref) > 0
    # 2 (k, v) x layers x blocks x block x kv heads x head dim x fp32
    blocks = -(-port["kv"]["length"] // GEOMETRY["block_size"])
    assert nbytes == 2 * TCFG.n_layers * blocks * GEOMETRY["block_size"] \
        * TCFG.n_kv_heads * TCFG.head_dim * 4
    sim = tserving.SimReplicaRuntime()
    rid = sim.submit([1, 2, 3], 8)
    sim.step()
    sim_payload = sim.export_slot(rid)
    assert trouter._payload_nbytes(sim_payload) == \
        jrouter._payload_nbytes(sim_payload) == 4 * (3 + 4)


# ----------------------------------------------------- the client contract


def test_pool_needs_the_ports_api_error_from_its_client():
    """A node the cluster does not have: the fake client raises the
    reference's NotFoundError. Wrapped, the port's pool logs the failed
    mirror, keeps its last view and counts the failed read; unwrapped,
    the foreign error escapes the port's pool."""
    cluster = FakeCluster(clock=FakeClock())
    cluster.add_node("node-a")
    pool = tserving.ReplicaPool(client=PortClient(cluster.client))
    pool.register(tserving.Replica("a", "node-a",
                                   tserving.SimReplicaRuntime()))
    pool.register(tserving.Replica("gone", "node-gone",
                                   tserving.SimReplicaRuntime()))
    pool.refresh_nodes()
    assert pool.node_refresh_errors == 1
    assert pool.node_states["node-a"].known
    assert "node-gone" not in pool.node_states
    bare = tserving.ReplicaPool(client=cluster.client)
    with pytest.raises(JApiError):
        bare.register(tserving.Replica("gone", "node-gone",
                                       tserving.SimReplicaRuntime()))
    # registration mirrored onto the node with the port's wire keys
    node = cluster.client.direct().get_node("node-a")
    assert node.metadata.labels[twire.REPLICA_ID_LABEL] == "a"
    assert node.metadata.annotations[
        twire.KV_PAYLOAD_VERSION_ANNOTATION] == "1"


# ------------------------------------------- router vs router, batchers


def _fleet(pkg, runtimes, clock, cluster, **router_kw):
    client = PortClient(cluster.client) if pkg is tserving \
        else cluster.client
    pool = pkg.ReplicaPool(client=client, component="libtpu", clock=clock)
    for node, runtime in zip(NODES, runtimes):
        pool.register(pkg.Replica(f"{node}-g1", node, runtime))
    hub = (tmetrics.MetricsHub() if pkg is tserving
           else jmetrics.MetricsHub())
    router = pkg.RequestRouter(pool, metrics=hub, clock=clock, **router_kw)
    return pool, router, hub


def _cluster(clock):
    cluster = FakeCluster(clock=clock)
    for node in NODES:
        cluster.add_node(node)
    return cluster


def _outcome(router, hub):
    """Everything the two packages must agree on after a scenario."""
    reqs = {rid: (r.state, r.tokens, r.stream, r.stream_log, r.replica_id,
                  r.handoffs, r.migrations, r.priority, r.lane,
                  r.replay_skip, r.queue_wait_s, r.completed_t)
            for rid, r in router.requests.items()}
    counters = {"lanes": router.lane_stats(), "routed": router._routed,
                "rerouted": router._rerouted,
                "attempts": router.migration_attempts,
                "migrations": router.migration_successes,
                "fallbacks": router.migration_fallbacks,
                "completed": router.completed_counts, "drains": router.drains,
                "violations": router.stream_violations}
    return reqs, counters, hub.render(prefix="tpu_router")


def _tokens(out):
    return {rid: r[1] for rid, r in out[0].items()}


def _drive(pool, router, cluster, schedule, drain_tick, ticks, fail=None,
           flood=None):
    """Tick the router and step every live replica until nothing is
    outstanding. ``schedule``: {tick: [(prompt, max_new, lane, session)]}
    submitted after that tick; at ``drain_tick`` node-a's upgrade-state
    label turns cordon-required; ``fail``: (tick, replica id) crashed
    after that tick's steps."""
    state_label = pool.keys.state_label
    for it in range(ticks):
        router.tick()
        nodes = {n.metadata.name: n
                 for n in cluster.client.direct().list_nodes()}
        assert router.check_invariants(nodes) == [], it
        for prompt, max_new, lane, session in schedule.get(it, ()):
            router.submit(prompt, max_new, session=session, lane=lane)
        for replica in list(pool.replicas.values()):
            if not replica.failed:
                replica.runtime.step()
        if fail is not None and it == fail[0]:
            pool.replicas[fail[1]].runtime.fail()
        if it == drain_tick:
            cluster.client.direct().patch_node_metadata(
                "node-a", labels={state_label: "cordon-required"})
        if it > max(schedule) and router.outstanding == 0:
            router.tick()
            assert router.check_invariants() == []
            return it
    raise AssertionError(f"{router.outstanding} requests outstanding")


def _batcher_schedule():
    """Four requests at tick 0 (node-a takes two, node-b and node-c one
    each, so the peers have a free slot each when node-a drains), eight
    more over ticks 3-6, some in sessions."""
    rng = np.random.default_rng(13)
    lanes = tserving.LANES
    schedule = {}
    for i in range(12):
        n = int(rng.integers(4, 12))
        prompt = rng.integers(0, JCFG.vocab_size, size=n).tolist()
        max_new = int(rng.integers(6, 10) if i < 4 else rng.integers(3, 9))
        entry = (prompt, max_new, lanes[i % 3],
                 f"s{i % 4}" if i % 2 else None)
        schedule.setdefault(0 if i < 4 else 3 + i % 4, []).append(entry)
    return schedule


def test_port_router_over_port_batchers_equals_the_reference(weights):
    """Three replicas, twelve requests in three lanes, node-a's
    cordon-required after tick 2: the same tokens, streams, provenance,
    counters and rendered router metrics; node-a's two in-flight
    requests live-migrate, none falls back."""
    tree, params = weights
    schedule = _batcher_schedule()
    outs = []
    for pkg, make in ((jserving, lambda c: jserving.BatcherRuntime(
            tree, JCFG, clock=c, **GEOMETRY)),
                      (tserving, lambda c: tserving.BatcherRuntime(
            params, TCFG, clock=c, **GEOMETRY))):
        clock = FakeClock()
        cluster = _cluster(clock)
        pool, router, hub = _fleet(pkg, [make(clock) for _ in NODES], clock,
                                   cluster)
        _drive(pool, router, cluster, schedule, drain_tick=2, ticks=80)
        outs.append(_outcome(router, hub))
    ref, port = outs
    assert _tokens(port) == _tokens(ref)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    counters = port[1]
    assert counters["migrations"] == 2 and counters["fallbacks"] == 0
    assert counters["drains"][0][:3] == ("node-a-g1", "node-a",
                                         "upgrade:cordon-required")
    assert all(c == 1 for c in counters["completed"].values())
    assert len(counters["completed"]) == 12


# ---------------------------------------------- router vs router, sims


def _sim_schedule():
    """Four long requests at tick 0 (node-a takes two), then a flood of
    the two lower lanes over ticks 2-4, four at a time: once the scraped
    queues pass ``queue_high`` the router's own queue passes
    ``shed_high`` and sheds best-effort first, then batch."""
    rng = np.random.default_rng(5)
    schedule = {0: [(rng.integers(0, 500, size=int(rng.integers(2, 8)))
                     .tolist(), 12 + i, tserving.LANES[i % 3],
                     "s0" if i == 1 else None) for i in range(4)]}
    for t in (2, 3, 4):
        schedule[t] = [([7, t, i], 6, "best-effort" if i % 2 else "batch",
                        None) for i in range(4)]
    return schedule


def test_port_router_over_sims_equals_the_reference_with_faults():
    """Sims, with a forced adoption rejection (the re-prefill fallback),
    a replica crash and overload shedding: equal outcomes and counters,
    every non-shed request delivered once."""
    schedule = _sim_schedule()
    outs = []
    for pkg in (jserving, tserving):
        clock = FakeClock()
        cluster = _cluster(clock)
        runtimes = [pkg.SimReplicaRuntime(max_slots=2, tokens_per_step=2)
                    for _ in NODES]
        pool, router, hub = _fleet(pkg, runtimes, clock, cluster,
                                   queue_high=2.0, shed_high=3.0)
        # node-b refuses every adoption: node-a's first in-flight request
        # migrates to node-c's free slot, its second falls back to a
        # re-prefill; node-c crashes at tick 6
        runtimes[1].reject_adoptions = 100
        _drive(pool, router, cluster, schedule, drain_tick=0, ticks=200,
               fail=(6, "node-c-g1"))
        outs.append(_outcome(router, hub))
    ref, port = outs
    assert port == ref
    reqs, counters, _ = port
    assert counters["fallbacks"] == 1 and counters["migrations"] == 1
    assert counters["lanes"]["best-effort"]["shed"] >= 1
    assert counters["lanes"]["interactive"]["shed"] == 0
    assert any(r[5] >= 1 for r in reqs.values())        # re-placed
    for rid, r in reqs.items():
        if r[0] == "completed":
            assert counters["completed"][rid] == 1
        else:
            assert r[0] == "shed" and rid not in counters["completed"]


# ------------------------------------------------------------ autoscaler


class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, obj, event_type, reason, message):
        self.events.append((obj.kind, event_type, reason, message))


@dataclasses.dataclass
class _Workload:
    name: str


class _Scheduler:
    def __init__(self):
        self.placed = []

    def place(self, workload, prefer=None):
        self.placed.append((workload.name, prefer is not None))
        return {"workload": workload.name}


class _Market:
    def leased_slice_ids(self):
        return {"slice-1"}


class _Burning:
    """An SLO engine's last evaluation: the TTFT objective's page pair
    burning (the port has no SLO engine; the autoscaler reads ``last``)."""

    def __init__(self):
        self.last = {"serving-ttft-p99": {"burn": [
            {"triggered": False, "severity": "page"},
            {"triggered": True, "severity": "page", "long_rate": 20.5,
             "long": "1h", "short_rate": 31.25, "short": "5m",
             "factor": 14.4}]}}


def _autoscale(pkg, engine):
    """Queue-depth (or burn) scale-up, then sustained idle scale-down to
    the floor, on sims: every decision, event and gauge."""
    clock = FakeClock(5_000.0)
    pool = pkg.ReplicaPool(component="libtpu", clock=clock)
    a = pool.register(pkg.Replica("a", "node-a",
                                  pkg.SimReplicaRuntime(max_slots=2)))
    router = pkg.RequestRouter(pool, clock=clock)
    recorder, scheduler = _Recorder(), _Scheduler()
    hub = (tmetrics.MetricsHub() if pkg is tserving
           else jmetrics.MetricsHub())
    released = []
    scaler = pkg.Autoscaler(
        pool, router, slo_engine=engine, scheduler=scheduler,
        workload_template=_Workload("serve"),
        replica_factory=lambda placement: pkg.Replica(
            "b", "node-b", pkg.SimReplicaRuntime(max_slots=2)),
        release=released.append, recorder=recorder, metrics=hub,
        clock=clock, market=_Market(),
        config=pkg.AutoscalerConfig(min_replicas=1, max_replicas=2,
                                    queue_high=2.0, idle_occupancy=0.1,
                                    idle_seconds=120.0,
                                    cooldown_seconds=60.0))
    for i in range(8):
        a.runtime.submit([i], 2)
    pool.scrape()
    decisions = [scaler.tick(), scaler.tick()]
    if engine is not None:
        engine.last = {}        # the burn is over
    for _ in range(20):
        a.runtime.step()
    a.runtime.poll()
    pool.scrape()
    for dt in (61.0, 119.0, 2.0, 0.0):
        clock.advance(dt)
        decisions.append(scaler.tick())
    router.tick()
    decisions.append(scaler.tick())
    clock.advance(600.0)
    decisions.append(scaler.tick())
    return (decisions, recorder.events, scheduler.placed,
            [r.id for r in released], sorted(pool.replicas),
            hub.render(prefix="tpu_router"))


@pytest.mark.parametrize("signal", ["queue", "burn"])
def test_autoscaler_decides_as_the_reference(signal):
    """Scale-up on a burn or on queue depth, then idle scale-down to the
    floor: the same decisions, events, placements, releases and gauges."""
    def engine():
        return _Burning() if signal == "burn" else None
    ref, port = _autoscale(jserving, engine()), _autoscale(tserving, engine())
    assert port == ref
    decisions = [d and d["action"] for d in port[0]]
    assert decisions == ["scale-up", None, None, None, "scale-down", None,
                         None, None]
    reason = port[0][0]["reason"]
    assert ("burning" in reason) if signal == "burn" else \
        ("queue depth" in reason)
    assert port[2] == [("serve-1", True)]     # placed, market preferred
    assert port[3] == [port[0][4]["replica"]] and len(port[4]) == 1
    assert "tpu_router_scale_ups 1" in port[5]


# ------------------------------- a rolling upgrade over port replicas
#
# The port's mirror of tests/test_serve_upgrade_e2e.py::
# test_n_replica_rolling_upgrade_zero_loss: the JAX package's operator
# (the cluster the tier runs in, not the code under test) rolls libtpu
# across three nodes that host port replicas under the port's router and
# pool, through the wrapped client. It holds what the reference holds:
# zero lost and zero duplicated requests, tokens equal to a solo decode
# (the port's contiguous generate), at least one live migration, the
# forced adoption rejection taking the re-prefill fallback, the admitting
# fleet never below 2, and each replica drained before its cordon.

NS = "kube-system"
N_HOSTS = [f"fleet-{c}-host" for c in "abc"]


def _slice_labels(pool):
    return {GKE_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
            GKE_TOPOLOGY_LABEL: "1x1", GKE_NODEPOOL_LABEL: pool}


def _solo(params, prompt, n):
    return generate(params, torch.as_tensor(prompt[None].astype(np.int64)),
                    TCFG, max_new_tokens=n)[0].tolist()


@pytest.fixture
def router_fleet(cluster):
    """Three serving nodes, all running the managed driver, each with a
    serve pod the wait-for-jobs gate watches."""
    ds = cluster.add_daemonset("libtpu", namespace=NS,
                               labels={"app": "libtpu"}, revision_hash="v1")
    for i, host in enumerate(N_HOSTS):
        cluster.add_node(host, labels=_slice_labels(f"fleet-pool-{i}"))
        cluster.add_pod(f"libtpu-{host}", host, namespace=NS, owner_ds=ds,
                        revision_hash="v1")
        cluster.add_pod(f"serve-{i}", host, labels={"job": "serve"})
    return ds


def test_port_replicas_rolling_upgrade_zero_loss(cluster, clock, weights,
                                                 router_fleet):
    keys = TKeys("libtpu")
    operator = TPUOperator(
        cluster.client,
        components=[ManagedComponent(
            name="libtpu", namespace=NS, driver_labels={"app": "libtpu"},
            policy=DriverUpgradePolicySpec(
                auto_upgrade=True, max_parallel_upgrades=1,
                wait_for_completion=WaitForCompletionSpec(
                    pod_selector="job=serve"),
                drain=DrainSpec(enable=True, force=True,
                                timeout_second=60)))],
        recorder=cluster.recorder, clock=clock, synchronous=True)

    params = weights[1]
    pool = tserving.ReplicaPool(client=PortClient(cluster.client),
                                component="libtpu", clock=clock)
    router = tserving.RequestRouter(pool, clock=clock)
    gen = {host: 1 for host in N_HOSTS}

    def spawn(host):
        replica = tserving.Replica(f"{host}-g{gen[host]}", host,
                                   tserving.BatcherRuntime(
                                       params, TCFG, clock=clock,
                                       **GEOMETRY))
        gen[host] += 1
        return pool.register(replica)

    for host in N_HOSTS:
        spawn(host)

    rng = np.random.default_rng(21)
    expected = {}          # rid -> (prompt, max_new)

    def submit(n, session=None):
        for _ in range(n):
            prompt = rng.integers(0, TCFG.vocab_size,
                                  size=int(rng.integers(4, 12))
                                  ).astype(np.int32)
            max_new = int(rng.integers(2, 7))
            rid = router.submit(prompt, max_new, session=session)
            expected[rid] = (prompt, max_new)

    submit(9)
    cluster.bump_daemonset_revision("libtpu", NS, "v2")

    # the first drain's migrations are refused by every peer, so the
    # re-prefill fallback is taken, not only the live splice
    for replica in pool.replicas.values():
        replica.runtime.reject_adoptions = 50

    exited = set()         # replica ids whose serve pod completed
    min_admitting = len(N_HOSTS)
    done = False
    for it in range(600):
        operator.reconcile()
        cluster.reconcile_daemonsets()
        router.tick()
        if router.migration_fallbacks >= 1:
            for replica in pool.replicas.values():
                replica.runtime.reject_adoptions = 0

        nodes = {n.metadata.name: n
                 for n in cluster.client.direct().list_nodes()}
        assert router.check_invariants(nodes) == []
        min_admitting = min(min_admitting, len(pool.admitting()))

        # a steady trickle: in-flight streamed requests exist whenever a
        # drain lands
        if it % 4 == 1 and len(expected) < 36:
            submit(1, session=f"s{it % 8}")

        for replica in list(pool.replicas.values()):
            if not replica.failed:
                replica.runtime.step()
            # a drained replica's server exits; the wait-for-jobs gate
            # sees its pod complete
            if replica.draining and replica.drained \
                    and replica.id not in exited:
                i = N_HOSTS.index(replica.node_name)
                try:
                    cluster.set_pod_status("default", f"serve-{i}",
                                           phase="Succeeded")
                except KeyError:
                    pass   # already deleted by the node drain
                exited.add(replica.id)
            # the node is back (upgrade-done, uncordoned): a fresh replica
            # generation takes over
            if replica.id in exited:
                node = nodes[replica.node_name]
                if (node.metadata.labels.get(keys.state_label)
                        == TState.DONE
                        and not node.spec.unschedulable):
                    pool.deregister(replica.id)
                    i = N_HOSTS.index(replica.node_name)
                    try:
                        cluster.set_pod_status("default", f"serve-{i}",
                                               phase="Running")
                    except KeyError:
                        cluster.add_pod(f"serve-{i}", replica.node_name,
                                        labels={"job": "serve"})
                    spawn(replica.node_name)

        all_done = all(
            n.metadata.labels.get(keys.state_label) == TState.DONE
            and not n.spec.unschedulable for n in nodes.values())
        if all_done and router.outstanding == 0:
            router.tick()   # collect the final completions
            done = True
            break

    assert done, "rolling upgrade + serving never converged"

    # zero lost, zero duplicated
    assert sorted(router.completed_counts) == sorted(expected)
    assert all(c == 1 for c in router.completed_counts.values())
    assert router.check_invariants() == []

    # the admitting fleet never dropped below N - maxUnavailable
    assert min_admitting >= len(N_HOSTS) - 1

    # every node walked, each drain begun on the pre-cordon signal while
    # the node was still schedulable
    assert {node for (_r, node, _reason, _s) in router.drains} == \
        set(N_HOSTS)
    for replica_id, node, reason, schedulable_at_drain in router.drains:
        assert reason == "upgrade:cordon-required", \
            f"{replica_id} drained on {reason}, not the pre-cordon signal"
        assert schedulable_at_drain, \
            f"{replica_id} drain started only after {node} was cordoned"

    served_by = {rid: router.requests[rid].replica_id for rid in expected}
    assert len(set(served_by.values())) >= 2

    # live migration taken; the forced rejection took the fallback and
    # lost nothing; every stream gapless and equal to its result
    assert router.migration_successes >= 1
    assert any(r.migrations >= 1 for r in router.requests.values())
    assert router.migration_fallbacks >= 1
    fallen_back = [r for r in router.requests.values()
                   if r.priority == "degraded"]
    assert fallen_back and all(r.state == "completed"
                               for r in fallen_back)
    assert router.stream_violations == []
    for rid, (prompt, max_new) in expected.items():
        req = router.requests[rid]
        assert [seq for seq, _r in req.stream_log] == \
            list(range(len(req.stream)))
        if req.stream:
            assert req.stream == req.tokens[len(prompt):]

    # no replica changed any request's output
    for rid, (prompt, max_new) in expected.items():
        assert router.result(rid) == _solo(params, prompt, max_new), \
            f"request {rid} (served by {served_by[rid]}) diverged"

    pods = cluster.client.direct().list_pods(namespace=NS)
    assert sorted(p.metadata.labels["controller-revision-hash"]
                  for p in pods) == ["v2"] * len(N_HOSTS)
    assert len(pool.admitting()) == len(N_HOSTS)
