"""The port's capacity market (``market/``) against the JAX package's.

Each scenario runs twice: the reference's arbiter on the reference's
``FakeCluster`` client, then the port's on the same kind of cluster,
reached either through a wrapper that re-raises the reference's errors
as the port's (``PortClient``, the port's client contract) or through
the port's own ``LiveClient`` over the port's ``FakeAPIServer`` and
``FakeCluster``.
Decisions, ownership, the ``tpu.dev/market.*`` labels and annotations,
the events, the fleet timeline and the rendered ``tpu_market_*`` text
must be equal.

The flash-crowd twin runs the reference's demand e2e with the port's
serving tier, arbiter, goodput ledger and elastic trainer
(``CheckpointingTrainer(elastic=True)`` with step, init and mesh
factories): it shrinks on the preempt and grows on the return, and its
ledger records equal the reference run's. ``HTTPLaneDemand`` reads the
port's router binary's ``/lanes`` as the reference's adapter does.
"""

import itertools
import json
import threading
import types
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from k8s_operator_libs_tpu import wire as jwire
from k8s_operator_libs_tpu.core.client import ApiError as JApiError
from k8s_operator_libs_tpu.core.client import ServerError as JServerError
from k8s_operator_libs_tpu.core.fakecluster import FakeCluster
from k8s_operator_libs_tpu.obs.metrics import HELP_TEXTS as JHELP
from k8s_operator_libs_tpu_torch import wire as twire
from k8s_operator_libs_tpu_torch.core.client import ApiError as TApiError
from k8s_operator_libs_tpu_torch.core.client import ServerError as TServerError
from k8s_operator_libs_tpu_torch.core.fakecluster import (
    FakeCluster as TFakeCluster)
from k8s_operator_libs_tpu_torch.core.httpapi import FakeAPIServer
from k8s_operator_libs_tpu_torch.core.liveclient import (KubeConfig,
                                                         KubeHTTP,
                                                         LiveClient)
from k8s_operator_libs_tpu_torch.obs.metrics import HELP_TEXTS as THELP
from torch_twin import ServingSLO


def _pkg(name):
    """The modules of one package a scenario runs on."""
    if name == "jax":
        from k8s_operator_libs_tpu import market, serving
        from k8s_operator_libs_tpu.obs import goodput, timeline
        from k8s_operator_libs_tpu.obs.metrics import MetricsHub
        from k8s_operator_libs_tpu.train import harness
        from k8s_operator_libs_tpu.utils.clock import FakeClock
        trainer_kw = {}
    else:
        from k8s_operator_libs_tpu_torch import market, serving
        from k8s_operator_libs_tpu_torch.obs import goodput, timeline
        from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
        from k8s_operator_libs_tpu_torch.train import harness
        from k8s_operator_libs_tpu_torch.utils.clock import FakeClock
        trainer_kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, market=market, serving=serving, goodput=goodput,
        timeline=timeline, Hub=MetricsHub, harness=harness,
        FakeClock=FakeClock, trainer_kw=trainer_kw,
        ServerError=JServerError if name == "jax" else TServerError)


class PortClient:
    """A reference ``FakeCluster`` client that raises the port's
    ``ApiError`` where the reference's would be raised."""

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


class FlakyClient:
    """Patches fail with the package's ``ServerError`` while armed."""

    def __init__(self, inner, error):
        self._inner = inner
        self._error = error
        self.fail_patches = 0

    def direct(self):
        return self._inner.direct()

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.startswith("patch_") and callable(attr):
            def call(*a, **kw):
                if self.fail_patches > 0:
                    self.fail_patches -= 1
                    raise self._error("injected patch failure")
                return attr(*a, **kw)
            return call
        return attr


class Recorder:
    def __init__(self):
        self.events = []

    def event(self, obj, event_type, reason, message):
        self.events.append((obj.kind, obj.metadata.name, event_type, reason,
                            message))


class Demand:
    """Scripted lane depths."""

    def __init__(self):
        self.depths = {"interactive": 0, "batch": 0, "best-effort": 0}
        self.admitting = 2

    def lane_depths(self):
        return dict(self.depths)

    def lane_stats(self):
        return {lane: {"queued": d, "shed": 0, "completed": 0}
                for lane, d in self.depths.items()}

    def admitting_count(self):
        return self.admitting


class World:
    """A scenario's cluster and the client its package's arbiter uses:
    the reference's client for the reference; for the port, the wrapped
    reference client or the port's LiveClient over HTTP to the port's
    apiserver and cluster."""

    def __init__(self, pkg, route, clock, nodes):
        make = TFakeCluster if (pkg.name != "jax"
                                and route == "http") else FakeCluster
        self.cluster = make(clock=None if pkg.name != "jax" else clock)
        for name in nodes:
            self.cluster.add_node(name)
        self._api = None
        if pkg.name == "jax":
            self.client = self.cluster.client
        elif route == "wrapped":
            self.client = PortClient(self.cluster.client)
        else:
            self._api = FakeAPIServer(self.cluster).start()
            self.client = LiveClient(KubeHTTP(KubeConfig(
                server=self._api.base_url)))

    @property
    def direct(self):
        return self.cluster.client.direct()

    def metadata(self):
        return {n.metadata.name: (dict(n.metadata.labels),
                                  dict(n.metadata.annotations),
                                  n.spec.unschedulable)
                for n in self.direct.list_nodes()}

    def close(self):
        if self._api is not None:
            self._api.stop()


def _arbiter(pkg, world, demand, clock, **kw):
    cfg = kw.pop("config", {})
    m = pkg.market
    return m.CapacityArbiter(
        [m.ManagedSlice("s0", kw.pop("nodes", ["n-t0"]))],
        client=None if world is None else world.client, demand=demand,
        clock=clock, config=m.MarketConfig(**cfg), **kw)


def _state(arb, hub=None):
    return {"decisions": list(arb.decisions), "ownership": arb.ownership(),
            "payload": arb.payload(), "trades": arb.trades,
            "returns": arb.returns, "rate": arb.last_rate,
            "leased": sorted(arb.leased_slice_ids()),
            "text": None if hub is None else hub.render(prefix="tpu_market")}


def scenario_hysteresis(pkg, route):
    clock = pkg.FakeClock(1000.0)
    demand = Demand()
    seen = []
    hub = pkg.Hub()
    tl = pkg.timeline.FleetTimeline(clock=clock)
    arb = _arbiter(pkg, None, demand, clock, vacated=lambda ms: True,
                   grant=lambda ms: seen.append("grant"),
                   revoke=lambda ms: True,
                   returned=lambda ms: seen.append("returned"),
                   metrics=hub, timeline=tl, recorder=Recorder(),
                   config=dict(preempt_rate=1.5, return_rate=0.4,
                               sustain_ticks=3, cooldown_seconds=120.0))
    trace = []
    demand.depths["interactive"] = 20
    for step in range(14):
        if step == 4:
            demand.depths["interactive"] = 0
        clock.sleep(120.0 if step == 8 else 15.0)
        arb.tick()
        trace.append((arb.supply[0].phase, arb.last_rate))
    return {"trace": trace, "hooks": seen, "events": arb._recorder.events,
            "timeline": tl.payload(), **_state(arb, hub)}


def scenario_pricing(pkg, route):
    clock = pkg.FakeClock()
    demand = Demand()
    arb = _arbiter(pkg, None, demand, clock, config=dict(queue_high=4.0))
    rates = [arb.exchange_rate()]
    demand.depths["interactive"] = 8
    rates.append(arb.exchange_rate())
    demand.depths = {"interactive": 0, "batch": 0, "best-effort": 8}
    rates.append(arb.exchange_rate())
    arb.slo_engine = types.SimpleNamespace(last={"serving-ttft-p99": {
        "burn": [{"triggered": True, "severity": "page",
                  "long_rate": 28.8, "factor": 14.4},
                 {"triggered": True, "severity": "ticket",
                  "long_rate": 99.0, "factor": 1.0}]}})
    rates.append(arb.exchange_rate())
    arb.goodput_fn = lambda: 2.0
    rates.append(arb.exchange_rate())
    arb.goodput_fn = lambda: 0.0
    rates.append(arb.exchange_rate())
    arb.goodput_fn = lambda: 1 / 0
    rates.append(arb.exchange_rate())
    arb.config.goodput_norm = 4.0
    arb.goodput_fn = lambda: 2.0
    rates.append(arb.exchange_rate())
    demand.lane_depths = lambda: 1 / 0
    rates.append(arb.exchange_rate())
    return {"rates": rates,
            "marginal": [pkg.market.marginal_goodput(s, n) for s, n in (
                ({"tokens_per_s": 9000.0}, 3), ({"tokens_per_s": None}, 3),
                ({}, 0))],
            "config": pkg.market.MarketConfig.from_dict(
                {"preempt_rate": 3.0, "unknown": 1}).__dict__}


def scenario_wire_and_resume(pkg, route):
    clock = pkg.FakeClock(500.0)
    world = World(pkg, route, clock, ["n-t0", "n-t1"])
    demand = Demand()
    demand.depths["interactive"] = 20
    cfg = dict(preempt_rate=1.5, sustain_ticks=1, cooldown_seconds=0.0)
    try:
        arb = _arbiter(pkg, world, demand, clock, nodes=["n-t0", "n-t1"],
                       vacated=lambda ms: False, config=cfg)
        arb.tick()
        first = world.metadata()
        # a restarted arbiter resumes the trade from the annotations
        arb2 = _arbiter(pkg, world, demand, clock, nodes=["n-t0", "n-t1"],
                        vacated=lambda ms: True, config=cfg)
        clock.sleep(5.0)
        arb2.tick()
        arb2.standby()
        arb3 = _arbiter(pkg, world, demand, clock, nodes=["n-t0", "n-t1"],
                        config=cfg)
        arb3.resume()
        return {"first": first, "after": world.metadata(),
                "arb": _state(arb), "arb2": _state(arb2),
                "arb3": _state(arb3)}
    finally:
        world.close()


def scenario_dirty_and_budget(pkg, route):
    clock = pkg.FakeClock(100.0)
    world = World(pkg, route, clock, ["n-t0", "n-x0", "n-x1"])
    demand = Demand()
    demand.depths["interactive"] = 20
    phases = []
    try:
        arb = _arbiter(pkg, world, demand, clock, vacated=lambda ms: True,
                       config=dict(preempt_rate=1.5, sustain_ticks=1,
                                   cooldown_seconds=0.0, budget=2))
        for patch in (
                lambda d: d.patch_node_unschedulable("n-t0", True),
                lambda d: d.patch_node_unschedulable("n-t0", False),
                lambda d: d.patch_node_metadata(
                    "n-t0", labels={"tpu.dev/health-quarantine": "true"}),
                lambda d: d.patch_node_metadata(
                    "n-t0", labels={"tpu.dev/health-quarantine": None}),
                lambda d: (d.patch_node_unschedulable("n-x0", True),
                           d.patch_node_unschedulable("n-x1", True)),
                lambda d: d.patch_node_unschedulable("n-x1", False)):
            patch(world.direct)
            arb.tick()
            phases.append(arb.supply[0].phase)
        return {"phases": phases, "nodes": world.metadata(),
                **_state(arb)}
    finally:
        world.close()


def scenario_failed_stamp(pkg, route):
    clock = pkg.FakeClock(10.0)
    world = World(pkg, route, clock, ["n-t0"])
    demand = Demand()
    demand.depths["interactive"] = 20
    try:
        world.client = FlakyClient(world.client, pkg.ServerError)
        arb = _arbiter(pkg, world, demand, clock, vacated=lambda ms: False,
                       config=dict(preempt_rate=1.5, sustain_ticks=1,
                                   cooldown_seconds=0.0))
        world.client.fail_patches = 2
        seen = []
        for _ in range(3):
            arb.tick()
            seen.append((arb.supply[0].stamp_pending, world.metadata()))
        return {"seen": seen, **_state(arb)}
    finally:
        world.close()


def scenario_slo_burn(pkg, route):
    """The burn signal from the package's real SLO engine (its tsdb fed
    slow, then fast first tokens) with no backlog at all: the exchange
    rate it prices, and the trade it drives and returns."""
    clock = pkg.FakeClock(1000.0)
    demand = Demand()
    engine = ServingSLO("k8s_operator_libs_tpu" if pkg.name == "jax"
                        else "k8s_operator_libs_tpu_torch")
    seen = []
    arb = _arbiter(pkg, None, demand, clock, vacated=lambda ms: True,
                   grant=lambda ms: seen.append("grant"),
                   revoke=lambda ms: True,
                   returned=lambda ms: seen.append("returned"),
                   recorder=Recorder(),
                   config=dict(preempt_rate=1.5, return_rate=0.4,
                               sustain_ticks=2, cooldown_seconds=60.0))
    arb.slo_engine = engine
    rates = [arb.exchange_rate()]
    engine.burn()
    trace = []
    for step in range(10):
        if step == 4:
            engine.cool()
        clock.sleep(45.0)
        arb.tick()
        trace.append((arb.supply[0].phase, arb.last_rate))
    return {"rates": rates, "trace": trace, "hooks": seen,
            "events": arb._recorder.events, **_state(arb)}


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_hysteresis, scenario_pricing, scenario_wire_and_resume,
    scenario_dirty_and_budget, scenario_failed_stamp, scenario_slo_burn)}


# the scenarios without a cluster run once; the others over both routes
CASES = [(name, route) for name in sorted(SCENARIOS)
         for route in (("none",) if name in ("hysteresis", "pricing",
                                             "slo_burn")
                       else ("wrapped", "live"))]


@pytest.mark.parametrize("name,route", CASES)
def test_arbiter_equals_the_reference(name, route):
    want = SCENARIOS[name](_pkg("jax"), route)
    got = SCENARIOS[name](_pkg("torch"), route)
    assert got == want


def test_scenarios_trade_as_the_reference_tests_say():
    """What the compared scenarios must show, read on the port's run."""
    pkg = _pkg("torch")
    h = scenario_hysteresis(pkg, "wrapped")
    assert [d["action"] for d in h["decisions"]] == [
        "preempt", "grant", "return", "returned"]
    assert h["hooks"] == ["grant", "returned"] and h["trades"] == 1
    assert [e[3] for e in h["events"]] == ["MarketTrade", "MarketReturn"]
    assert h["timeline"]["counts"] == {"market-trade": 4}
    w = scenario_wire_and_resume(pkg, "live")
    labels, annotations, _ = w["first"]["n-t0"]
    assert labels[twire.MARKET_OWNER_LABEL] == "draining"
    assert annotations[twire.MARKET_LEASE_ANNOTATION].startswith(
        "preempting:1@")
    assert json.loads(annotations[twire.MARKET_DECISION_ANNOTATION])[
        "action"] == "preempt"
    assert w["arb2"]["ownership"][0]["phase"] == "serving"
    assert w["arb3"]["ownership"][0]["phase"] == "serving"
    d = scenario_dirty_and_budget(pkg, "live")
    assert d["phases"] == ["training", "preempting", "serving", "serving",
                           "serving", "serving"]
    b = scenario_slo_burn(pkg, "none")
    assert b["rates"] == [0.0] and b["trace"][0][1] > 1.5
    assert [d["action"] for d in b["decisions"]] == [
        "preempt", "grant", "return", "returned"]
    assert b["hooks"] == ["grant", "returned"]
    f = scenario_failed_stamp(pkg, "live")
    # both injected failures land in the first tick (the decision's
    # stamp and its retry); the second tick's stamp lands
    assert [s[0] for s in f["seen"]] == [True, False, False]
    assert twire.MARKET_OWNER_LABEL not in f["seen"][0][1]["n-t0"][0]
    assert f["seen"][1][1]["n-t0"][0][twire.MARKET_OWNER_LABEL] == \
        "draining"


@pytest.mark.parametrize("name", ["MARKET_OWNER_LABEL",
                                  "MARKET_LEASE_ANNOTATION",
                                  "MARKET_DECISION_ANNOTATION"])
def test_market_wire_key_equals_the_reference(name):
    assert getattr(twire, name) == getattr(jwire, name)


def test_market_families_and_help_texts_equal_the_reference():
    from k8s_operator_libs_tpu import market as jmarket
    from k8s_operator_libs_tpu_torch import market as tmarket
    assert tmarket.MARKET_GAUGE_FAMILIES == jmarket.MARKET_GAUGE_FAMILIES
    assert tmarket.MARKET_PREFIX == jmarket.MARKET_PREFIX
    assert (tmarket.PHASES, tmarket.OWNER_LABELS, tmarket.LEGAL_OWNERS) == \
        (jmarket.PHASES, jmarket.OWNER_LABELS, jmarket.LEGAL_OWNERS)
    for family in tmarket.MARKET_GAUGE_FAMILIES + (
            "tpu_router_request_stage_seconds",
            "tpu_router_proxy_overhead_seconds", "tpu_router_traces_open",
            "tpu_router_traces_closed", "tpu_router_traces_dropped",
            "tpu_operator_alert_attributed_total"):
        assert THELP[family] == JHELP[family], family


# -------------------------------------------------- flash-crowd twin


def flash_crowd(pkg, tmp_path):
    """The reference's ``test_flash_crowd_demand_e2e`` on one package:
    a flash-crowd sweep over the sim replicas; the arbiter preempts the
    training slice at the peak (the elastic trainer shrinks 8 -> 4) and
    returns it after the trough (it grows back to 8)."""
    s, m = pkg.serving, pkg.market
    clock = pkg.FakeClock(10_000.0)
    ledger = pkg.goodput.GoodputLedger(str(tmp_path / "goodput.jsonl"),
                                       clock=clock)
    pool = s.ReplicaPool(component="libtpu", clock=clock)
    for i in range(2):
        pool.register(s.Replica(f"srv-{i}", f"n-s{i}", s.SimReplicaRuntime(
            max_slots=2, tokens_per_step=4)))
    router = s.RequestRouter(pool, clock=clock, shed_high=24)
    devices = [f"gpu{i}" for i in range(8)]
    burst = {"id": None, "n": 0}

    def grant(ms):
        burst["n"] += 1
        replica = s.Replica(f"burst-{burst['n']}", ms.anchor,
                            s.SimReplicaRuntime(max_slots=2,
                                                tokens_per_step=4))
        pool.register(replica)
        burst["id"] = replica.id

    def revoke(ms):
        replica = pool.replicas.get(burst["id"]) if burst["id"] else None
        if replica is None:
            return True
        if not replica.draining:
            router.drain_replica(replica, "market-return")
        if replica.drained:
            pool.deregister(replica.id)
            burst["id"] = None
            return True
        return False

    flags = {"preempted": False, "returned": False}
    trainer = None
    arb = m.CapacityArbiter(
        [m.ManagedSlice("train-0", ["n-t0"])], demand=router,
        goodput_fn=lambda: 1.0,
        preempt=lambda ms: flags.__setitem__("preempted", True),
        vacated=lambda ms: trainer._device_count == 4,
        grant=grant, revoke=revoke,
        returned=lambda ms: flags.__setitem__("returned", True),
        clock=clock,
        config=m.MarketConfig(preempt_rate=1.2, return_rate=0.3,
                              sustain_ticks=2, cooldown_seconds=25.0,
                              queue_high=4.0))
    step_i = {"n": 0}
    rid_count = {"n": 0}

    def world_tick():
        i = step_i["n"]
        for _ in range(16 if 10 <= i < 30 else 1):
            router.submit([rid_count["n"] % 311, 7], 4,
                          lane=s.LANES[rid_count["n"] % 3])
            rid_count["n"] += 1
        router.tick()
        arb.tick()
        for r in pool.replicas.values():
            if not r.failed:
                r.runtime.step()

    def step_factory(mesh):
        def step_fn(state, batch):
            clock.sleep(1.0)
            step_i["n"] += 1
            world_tick()
            return types.SimpleNamespace(step=state.step + 1), {}
        return step_fn

    h = pkg.harness
    trainer = h.CheckpointingTrainer(
        None, str(tmp_path / "ckpt"), step_fn=step_factory(None),
        init_fn=lambda rng: types.SimpleNamespace(step=0),
        step_factory=step_factory,
        init_factory=lambda mesh: (lambda rng: types.SimpleNamespace(
            step=0)),
        mesh_factory=lambda devs: ("mesh", len(devs)),
        checkpoint_interval=10_000, ledger=ledger, elastic=True,
        **pkg.trainer_kw)
    trainer.save = lambda state, wait=False: int(state.step)
    restored = types.SimpleNamespace(step=0)
    trainer.init_or_resume = lambda rng: types.SimpleNamespace(
        step=restored.step)
    trainer._device_count = 8
    sizes = []

    def reclaim_signal():
        sizes.append(trainer._device_count)
        if flags["preempted"] and trainer._device_count == 8:
            flags["preempted"] = False
            restored.step = step_i["n"]
            return h.ReclaimNotice(surviving_devices=devices[:4])
        return None

    def grow_signal():
        if flags["returned"] and trainer._device_count == 4:
            flags["returned"] = False
            restored.step = step_i["n"]
            return h.GrowNotice(devices=devices)
        return None

    batches = itertools.repeat(np.zeros((1, 3), np.int32))
    result = trainer.run(types.SimpleNamespace(step=0), batches,
                         num_steps=90, reclaim_signal=reclaim_signal,
                         grow_signal=grow_signal)
    ledger.close()
    for _ in range(100):
        router.tick()
        arb.tick()
        for r in pool.replicas.values():
            if not r.failed:
                r.runtime.step()
        clock.sleep(1.0)
        if router.outstanding == 0 and burst["id"] is None:
            break
    g = pkg.goodput
    records = g.read_ledger(ledger.path)
    delivered = {rid: (req.state, req.tokens)
                 for rid, req in router.requests.items()}
    return {
        "records": records, "runs": len(g.split_runs(records)),
        "windows": g.unavailability_windows(records),
        "summary": g.summarize(records), "decisions": arb.decisions,
        "trades": (arb.trades, arb.returns),
        "result": (result.reshards, result.device_count, result.preempted,
                   result.steps_done),
        "sizes": sizes, "shed": dict(router._lane_shed),
        "invariants": router.check_invariants(), "delivered": delivered,
        "expected": {rid: s.sim_tokens(req.prompt, req.max_new)
                     for rid, req in router.requests.items()}}


@pytest.fixture(scope="module")
def crowds(tmp_path_factory):
    return (flash_crowd(_pkg("jax"), tmp_path_factory.mktemp("jax")),
            flash_crowd(_pkg("torch"), tmp_path_factory.mktemp("torch")))


def test_flash_crowd_shrinks_and_grows_the_ports_elastic_trainer(crowds):
    _, port = crowds
    assert port["trades"] == (1, 1)
    assert port["result"] == (2, 8, False, 90)
    assert 4 in port["sizes"] and port["sizes"][-1] == 8
    assert port["runs"] == 1 and port["windows"] == []
    degraded = [r for r in port["records"] if r.get("phase") == "degraded"]
    assert len(degraded) == 1
    assert (degraded[0]["devices_before"],
            degraded[0]["devices_after"]) == (8, 4)
    assert degraded[0]["seconds_lost"] == pytest.approx(
        degraded[0]["duration_s"] * 0.5)
    assert port["shed"]["interactive"] == 0
    assert port["shed"]["best-effort"] >= max(1, port["shed"]["batch"])
    assert port["invariants"] == []
    for rid, (state, tokens) in port["delivered"].items():
        assert state in ("completed", "shed"), rid
        if state == "completed":
            assert tokens == port["expected"][rid]


@pytest.mark.parametrize("key", ["records", "runs", "windows", "summary",
                                 "decisions", "trades", "result", "sizes",
                                 "shed", "delivered"])
def test_flash_crowd_equals_the_reference_run(crowds, key):
    """Equal, but for one addition of the port's: a synchronous save's
    ledger record carries its ``fetch_s``/``write_s`` split (the port
    trainer's ``_save_phase``; here None, the save being stubbed)."""
    ref, port = crowds
    got = port[key]
    if key == "records":
        saves = [r for r in got if r.get("phase") == "drain_save"]
        assert len(saves) == 2
        assert all(r["fetch_s"] is None and r["write_s"] is None
                   for r in saves)
        got = [{k: v for k, v in r.items()
                if r.get("phase") != "drain_save"
                or k not in ("fetch_s", "write_s")} for r in got]
    assert got == ref[key]


# --------------------------------------------- the demand from /lanes


class HeldReplica:
    """A replica stand-in whose ``/generate`` waits for ``release``."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        held = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._send(200, "", "text/plain")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                held.entered.set()
                held.release.wait(30)
                self._send(200, json.dumps({"tokens": req["tokens"]}))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.release.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def test_http_lane_demand_reads_the_port_binarys_lanes(tmp_path):
    """One request held in flight on the interactive lane: the port's
    adapter and the reference's read the same depths, stats and
    admitting count off the port binary, and the port's arbiter prices
    them; ``ledger_goodput`` prices a port trainer's ledger as the
    reference operator's ``build_market`` does."""
    import importlib.util
    from pathlib import Path

    from k8s_operator_libs_tpu_torch import market as tmarket
    from k8s_operator_libs_tpu_torch import router
    from k8s_operator_libs_tpu_torch.obs.goodput import GoodputLedger
    from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

    spec = importlib.util.spec_from_file_location(
        "torch_market_cmd_operator",
        Path(__file__).resolve().parents[1] / "cmd" / "operator.py")
    op = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(op)

    rep = HeldReplica()
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=router.main, args=(
        ["--port", "0", "--tick", "0.05", "--replica",
         f"a={rep.url}@node-a"],), kwargs={"on_ready": on_ready},
        daemon=True)
    t.start()
    assert ready.wait(30)
    base = f"http://127.0.0.1:{box['httpd'].server_address[1]}"
    client = threading.Thread(target=lambda: urllib.request.urlopen(
        urllib.request.Request(base + "/generate", data=json.dumps(
            {"tokens": [1, 2], "max_new": 2}).encode(), method="POST"),
        timeout=60).read(), daemon=True)
    try:
        client.start()
        assert rep.entered.wait(30)
        port_demand = tmarket.HTTPLaneDemand(base)
        ref_demand = op.HTTPLaneDemand(base)
        got = [(d.lane_depths(), d.lane_stats(), d.admitting_count())
               for d in (port_demand, ref_demand)]
        assert got[0] == got[1]
        assert got[0][0] == {"interactive": 1, "batch": 0, "best-effort": 0}
        assert got[0][2] == 1
        arb = tmarket.CapacityArbiter(
            [tmarket.ManagedSlice("s0", ["n"])], demand=port_demand,
            clock=FakeClock(), config=tmarket.MarketConfig(queue_high=4.0))
        # 4 x 1 interactive over 1 admitting x 4 x 4
        assert arb.exchange_rate() == pytest.approx(0.25)
    finally:
        rep.close()
        client.join(timeout=30)
        box["httpd"].shutdown()
        t.join(timeout=30)
    # the goodput pricing of the reference operator's build_market, read
    # off a port trainer's ledger
    clock = FakeClock(50.0)
    ledger = GoodputLedger(str(tmp_path / "goodput.jsonl"), clock=clock)
    ledger.run_started(0)
    ledger.first_step(1, 2.0, 4096)
    clock.sleep(10.0)
    ledger.steps(11, 10, 10.0, 40960)
    ledger.run_ended(11, False)
    ledger.close()
    section = {"slices": [{"id": "s0", "nodes": ["n0", "n1"]},
                          {"id": "s1", "nodes": ["n2"]}],
               "goodputLedger": ledger.path}
    from k8s_operator_libs_tpu.obs.metrics import MetricsHub as JHub
    from k8s_operator_libs_tpu.utils.clock import FakeClock as JFakeClock
    ref = op.build_market(section, None, None, JHub(), None, JFakeClock())
    price = tmarket.ledger_goodput(ledger.path, 2)
    assert price() == ref.goodput_fn() > 0
    ledger.path = str(tmp_path / "missing.jsonl")
    assert tmarket.ledger_goodput(ledger.path, 2)() == 0.0
