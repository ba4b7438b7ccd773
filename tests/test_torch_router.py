"""The port's router binary (``router.py``) and the modules it runs on
(``utils/threads.py``, ``obs/timeline.py``, ``obs/causes.py``, the
completed ``obs/reqtrace.py``) against the JAX package's.

Module parity drives the same sequence through both packages (fake
clocks, a deterministic self clock) and compares every output with
``==``. The binary runs in-process through ``router.main(argv,
on_ready)`` in front of tiny fp32 replicas on the CPU, with
``--kubeconfig`` to the reference's ``FakeAPIServer(FakeCluster)``:

- a node's upgrade-state label turning ``cordon-required`` drains its
  replica (the drain intent stamped on the node) and the router splices
  the stream it relays onto the peer by ``/export``, ``/adopt`` and
  ``/stream``: one gapless stream equal to a solo decode, one migration,
  no fallback; for port and JAX replicas alike;
- one scenario of traffic through the reference binary
  (``cmd/router.py``) and through the port's, each over fresh port
  replicas: every endpoint body is equal, timings aside (floats and the
  timing histograms' buckets and sums are masked; the replicas' URLs
  are named by role).
"""

import ast
import importlib.util
import json
import logging
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_operator_libs_tpu.core.fakecluster import FakeCluster
from k8s_operator_libs_tpu.core.httpapi import FakeAPIServer
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu.obs import causes as jcauses
from k8s_operator_libs_tpu.obs import reqtrace as jreqtrace
from k8s_operator_libs_tpu.obs import timeline as jtimeline
from k8s_operator_libs_tpu.obs.metrics import MetricsHub as JHub
from k8s_operator_libs_tpu.upgrade.util import KeyFactory
from k8s_operator_libs_tpu.utils import threads as jthreads
from k8s_operator_libs_tpu.utils.clock import FakeClock as JFakeClock
from k8s_operator_libs_tpu_torch import convert, router, server
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.obs import causes as tcauses
from k8s_operator_libs_tpu_torch.obs import reqtrace as treqtrace
from k8s_operator_libs_tpu_torch.obs import timeline as ttimeline
from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub as THub
from k8s_operator_libs_tpu_torch.utils import threads as tthreads
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock as TFakeClock
from k8s_operator_libs_tpu_torch.wire import DRAIN_INTENT_ANNOTATION

REPO = Path(__file__).resolve().parents[1]
JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)
GEOMETRY = dict(max_slots=2, capacity=64, block_size=8)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


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


def _solo(params, prompt, n):
    return tgen.generate(params, torch.as_tensor([prompt]), TCFG,
                         max_new_tokens=n)[0].tolist()


def _load_cmd(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_router_cmd_{name}", REPO / "cmd" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ module parity


def _threads_run(mod):
    out = []
    lock = mod.make_lock("parity-lock")
    with lock:
        out.append([repr(h) for h in mod.held_locks()])
        out.append(lock.locked())
    out.append([repr(h) for h in mod.held_locks()])
    event = mod.make_event("parity-event")
    out.append((repr(event), event.wait(0.01)))
    seen = []
    go = mod.make_event("parity-go")
    t = mod.spawn("parity-worker", lambda: (go.wait(5), seen.append(1)))
    out.append([h.name for h in mod.live_threads("parity-")])
    go.set()
    t.join(5)
    out.append((seen, t.is_alive(), mod.live_threads("parity-")))
    idle = mod.spawn("parity-idle", lambda: None, start=False)
    out.append(mod.live_threads("parity-"))     # not started: not live
    idle.start()
    idle.join(5)
    with mod.use_backend(mod.RealBackend()) as backend:
        out.append(mod.get_backend() is backend)
    out.append(isinstance(mod.get_backend(), mod.RealBackend))
    return out


def test_threads_match_the_reference():
    assert _threads_run(tthreads) == _threads_run(jthreads)


def _timeline_run(mod, clock_cls):
    clock = clock_cls(1000.0)
    tl = mod.FleetTimeline(clock=clock, capacity=4, link_cap=3)
    tl.link("node/a", "slice/s0")
    tl.link("node/b", "slice/s0")
    tl.link("request/1", "lane/interactive")
    tl.link("request/2", "lane/batch")           # over the link cap
    tl.link("x", "x")
    for i, (kind, entity) in enumerate((
            ("journey-transition", "node/a"), ("router-drain", "request/1"),
            ("market-trade", "trade/1"), ("router-shed", "request/2"),
            ("health-verdict", "node/b"), ("chaos-fault", "node/a"))):
        clock.sleep(10.0)
        tl.record_event(kind=kind, entity=entity, detail=f"event {i}",
                        until=clock.now() + 5.0 if i == 5 else None)
    with pytest.raises(ValueError):
        tl.record_event(kind="not-a-kind", entity="node/a")
    return (tl.payload(), tl.ancestors("node/a"),
            [e.to_dict() for e in tl.events_for("node/a")],
            [e.to_dict() for e in tl.events_overlapping(1035.0, 1050.0)],
            tl.counts_by_kind(), tl.parent("request/2"))


def test_timeline_matches_the_reference():
    assert _timeline_run(ttimeline, TFakeClock) == \
        _timeline_run(jtimeline, JFakeClock)
    assert ttimeline.EVENT_KINDS == jtimeline.EVENT_KINDS


def _causes_run(tl_mod, causes_mod, clock_cls, hub_cls):
    clock = clock_cls(5000.0)
    tl = tl_mod.FleetTimeline(clock=clock)
    tl.link("node/a", "slice/s0")
    tl.link("request/7", "lane/interactive")
    tl.link("trade/1", "slice/s1")
    for kind, entity, span in (
            ("health-verdict", "node/a", None),
            ("router-migration", "request/7", None),
            ("market-trade", "trade/1", None),
            ("chaos-fault", "node/b", 300.0),
            ("router-shed", "request/9", None)):
        clock.sleep(60.0)
        tl.record_event(kind=kind, entity=entity, detail=kind,
                        until=None if span is None else clock.now() + span)
    hub = hub_cls()
    analyzer = causes_mod.CauseAnalyzer(
        tl, specs=[{"name": "ttft",
                    "metric": "tpu_workload_serve_ttft_seconds"}],
        clock=clock, metrics=hub, report_ring=2)
    reports = [analyzer.attribute("ttft:burn:page", "ttft", "page",
                                  fired_at=clock.now()),
               analyzer.attribute("other", "other", "ticket",
                                  fired_at=clock.now(), window_s=120.0),
               analyzer.attribute("ttft:burn:page", "ttft", "page",
                                  fired_at=clock.now() + 10.0)]
    return (reports, analyzer.latest_for("ttft"),
            causes_mod.causes_payload(analyzer, tl),
            causes_mod.causes_payload(None, tl),
            causes_mod.causes_payload(None, None),
            hub.render(prefix="tpu_operator"))


def test_causes_payload_matches_the_reference():
    assert _causes_run(ttimeline, tcauses, TFakeClock, THub) == \
        _causes_run(jtimeline, jcauses, JFakeClock, JHub)


def _reqtrace_run(mod, tl_mod, clock_cls, hub_cls):
    clock = clock_cls(100.0)
    ticks = [0.0]

    def selfclock():
        ticks[0] += 0.000125
        return ticks[0]

    hub = hub_cls()
    tl = tl_mod.FleetTimeline(clock=clock)
    rec = mod.RequestTraceRecorder(clock=clock, metrics=hub,
                                   selfclock=selfclock, timeline=tl,
                                   max_closed=3, max_open=3)

    def walk(rid, lane, stages, parent=None, tokens_at=()):
        rec.begin(rid, lane=lane, parent=parent)
        rec.overhead(rid, 0.0003, phase="accept")
        for i, stage in enumerate(stages):
            clock.sleep(0.05 * (i + 1))
            with rec.timer(rid, "route" if i == 0 else "relay"):
                pass
            if stage == "token":
                rec.token_appended(rid)
            else:
                rec.stage(rid, stage)

    walk(1, "interactive", ["queued", "assigned", "prefill", "token",
                            "token", "drain", "export", "transfer",
                            "adopt", "splice", "token", "completed"])
    walk(2, "batch", ["queued", "shed"],
         parent=mod.parse_trace_header("tabc/s0001/2"))
    walk(3, "best-effort", ["queued", "assigned", "prefill", "queued",
                            "assigned", "prefill", "token", "fallback",
                            "queued", "assigned", "prefill", "completed"])
    walk(4, "interactive", ["queued", "assigned"])
    walk(5, "batch", ["queued"])
    walk(6, "interactive", ["queued"])
    walk(7, "interactive", ["queued", "assigned", "prefill", "token"])
    rec.stage(99, "splice")                       # evicted or unknown rid
    rec.overhead(99, 1.0)
    out = [rec.payload(), rec.timelines(), rec.open_timelines(),
           [rec.trace_payload(r) for r in range(1, 9)],
           [rec.context(r) and rec.context(r).encode() for r in (1, 2, 7)],
           (rec.splices, rec.fallbacks, rec.dropped, rec.closed,
            rec.open_count()),
           tl.payload(), hub.render(prefix="tpu_router"),
           [mod.validate_timeline(t) for t in rec.timelines()]]
    return out


def test_completed_reqtrace_matches_the_reference():
    """With ``selfclock`` and ``timeline`` the recorder gives the
    reference's timelines, self-time, fleet events and ``tpu_router_*``
    text; the families it emits are the reference's."""
    got = _reqtrace_run(treqtrace, ttimeline, TFakeClock, THub)
    want = _reqtrace_run(jreqtrace, jtimeline, JFakeClock, JHub)
    assert got == want
    text = got[7]
    for family in (treqtrace.REQTRACE_HISTOGRAM_FAMILIES
                   + treqtrace.REQTRACE_GAUGE_FAMILIES):
        assert f"# TYPE {family} " in text
    assert treqtrace.REQTRACE_HISTOGRAM_FAMILIES == \
        jreqtrace.REQTRACE_HISTOGRAM_FAMILIES
    assert treqtrace.REQTRACE_GAUGE_FAMILIES == \
        jreqtrace.REQTRACE_GAUGE_FAMILIES
    assert treqtrace.STAGE_SECONDS_BUCKETS == jreqtrace.STAGE_SECONDS_BUCKETS
    assert treqtrace.OVERHEAD_SECONDS_BUCKETS == \
        jreqtrace.OVERHEAD_SECONDS_BUCKETS


def _traced_router_run(serving, reqtrace, timeline, clock_cls, hub_cls):
    clock = clock_cls(10.0)
    ticks = [0.0]

    def selfclock():
        ticks[0] += 0.00025
        return ticks[0]

    hub = hub_cls()
    tl = timeline.FleetTimeline(clock=clock)
    rec = reqtrace.RequestTraceRecorder(clock=clock, metrics=hub,
                                        selfclock=selfclock, timeline=tl)
    pool = serving.ReplicaPool(clock=clock)
    for name in ("a", "b"):
        pool.register(serving.Replica(name, f"node-{name}",
                                      serving.SimReplicaRuntime(
                                          max_slots=2, tokens_per_step=2)))
    router = serving.RequestRouter(pool, clock=clock, metrics=hub,
                                   reqtrace=rec, queue_high=2.0,
                                   shed_high=3.0)
    rids = [router.submit([i, 7, 3], 8, lane=serving.LANES[i % 3])
            for i in range(10)]
    for t in range(200):
        if t == 2:
            router.drain_replica(pool.replicas["a"], "test")
        router.tick()
        clock.sleep(1.0)
        for replica in pool.live():
            replica.runtime.step()
        if router.outstanding == 0:
            break
    return (rec.payload(), rec.timelines(), tl.payload(),
            hub.render(prefix="tpu_router"),
            [router.result(r) for r in rids])


def test_router_tier_traced_with_self_time_equals_the_reference():
    """The serving tier's router with the completed recorder (metrics,
    self clock, fleet timeline), over sims with a drain: the port's
    timelines, route self-time, fleet events and ``tpu_router_*`` text
    equal the reference's."""
    from k8s_operator_libs_tpu import serving as jserving
    from k8s_operator_libs_tpu_torch import serving as tserving
    got = _traced_router_run(tserving, treqtrace, ttimeline, TFakeClock,
                             THub)
    want = _traced_router_run(jserving, jreqtrace, jtimeline, JFakeClock,
                              JHub)
    assert got == want
    payload, timelines, events, text, results = got
    assert "tpu_router_proxy_overhead_seconds_count" in text
    assert events["counts"].get("router-drain", 0) >= 1
    assert all(t["stages"][-1][1] in ("completed", "shed")
               for t in timelines)


def _flags(path):
    tree = ast.parse(path.read_text())
    return [ast.unparse(node) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"]


def test_flags_and_defaults_are_the_reference_binarys():
    assert _flags(REPO / "k8s_operator_libs_tpu_torch" / "router.py") == \
        _flags(REPO / "cmd" / "router.py")
    ref = _load_cmd("router")
    for value in ("a=http://h:1@node-a", "b=http://u@h:2@node-b:2.5"):
        assert router.parse_replica_flag(value) == \
            ref.parse_replica_flag(value)
    import argparse
    for bad in ("a-http://h@n", "a=http://h"):
        with pytest.raises(argparse.ArgumentTypeError):
            router.parse_replica_flag(bad)


# ------------------------------------------------------------ helpers


class GatedBatcher:
    """A batcher that freezes after ``left`` more steps (None: never).
    Frozen, it reads as idle, so the runtime's stepper sleeps with its
    lock free for the HTTP handlers."""

    def __init__(self, srv):
        self.srv = srv
        self.left = None

    def __getattr__(self, name):
        return getattr(self.srv, name)

    @property
    def idle(self):
        return self.left == 0 or self.srv.idle

    def step(self, n=1):
        if self.left is not None:
            self.left -= 1
        return self.srv.step(n)


class Replica:
    """One replica of either package behind an HTTP server on port 0."""

    def __init__(self, kind, weights, **kw):
        tree, params = weights
        if kind == "jax":
            cli = _load_cmd("serve")
            self.rt = cli.ServingRuntime(
                tree, JCFG, GEOMETRY["max_slots"], GEOMETRY["capacity"],
                GEOMETRY["block_size"], 1, **kw)
            self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                             cli.make_handler(self.rt))
        else:
            self.rt = server.ServingRuntime(params, TCFG, chunk=1,
                                            **GEOMETRY, **kw)
            self.httpd = server.make_server(self.rt, "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.batcher = self.rt.srv = GatedBatcher(self.rt.srv)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.rt.stop()
        self.thread.join(timeout=10)


def _http(url, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method or (
        "POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            text, code = resp.read().decode(), resp.status
    except urllib.error.HTTPError as err:
        text, code = err.read().decode(), err.code
    try:
        return code, json.loads(text)
    except ValueError:
        return code, text


def _sse(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    events = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.strip()
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
    return events


def _kubeconfig(tmp_path, server_url):
    """A JSON kubeconfig (valid YAML too) for an http apiserver."""
    path = tmp_path / "kubeconfig.json"
    path.write_text(json.dumps({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k",
                                               "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": server_url}}],
        "users": [{"name": "u", "user": {}}]}))
    return str(path)


class Binary:
    """A router binary's ``main(argv, on_ready)`` in a thread."""

    def __init__(self, main, argv):
        ready = threading.Event()
        self.httpd = None
        self.rc = None

        def on_ready(httpd):
            self.httpd = httpd
            ready.set()

        def run():
            self.rc = main(["--port", "0"] + argv, on_ready=on_ready)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(30), "the router never came up"
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def wait_for(self, pred, what, timeout=30.0):
        deadline = time.monotonic() + timeout
        while True:
            _, text = _http(self.base + "/metrics")
            if pred(text):
                return text
            assert time.monotonic() < deadline, f"{what}: {text}"
            time.sleep(0.02)

    def stop(self):
        self.httpd.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive() and self.rc == 0


class TickFailures(logging.Handler):
    """Counts the binary's ``router tick failed`` records."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.failed = []

    def emit(self, record):
        if "router tick failed" in record.getMessage():
            self.failed.append(record)

    def __enter__(self):
        logging.getLogger("tpu-router").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("tpu-router").removeHandler(self)


def _gauge(text, name):
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return None if m is None else float(m.group(1))


# --------------------------------------------------------- the binary


@pytest.mark.parametrize("donor_kind,peer_kind", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_binary_drains_on_a_node_label_and_splices_the_stream(
        weights, tmp_path, donor_kind, peer_kind):
    """The port's binary with ``--kubeconfig`` to a fake apiserver: the
    client streams through it from replica A (frozen after 3 steps, so
    it cannot finish first); node A's upgrade-state label turns
    ``cordon-required``; the ticker drains A, stamps the drain intent
    on the node and the relay splices the stream onto B."""
    _, params = weights
    cluster = FakeCluster()
    for node in ("node-a", "node-b"):
        cluster.add_node(node)
    donor = Replica(donor_kind, weights)
    peer = Replica(peer_kind, weights)
    donor.batcher.left = 3
    state_label = KeyFactory("libtpu").state_label
    n = 12
    with FakeAPIServer(cluster) as api, TickFailures() as failures:
        binary = Binary(router.main, [
            "--kubeconfig", _kubeconfig(tmp_path, api.base_url),
            "--tick", "0.05", "--replica", f"a={donor.base}@node-a",
            "--replica", f"b={peer.base}@node-b"])
        try:
            binary.wait_for(lambda t: _gauge(t, "tpu_router_replicas") == 2,
                            "first tick")
            events = []
            req = urllib.request.Request(
                binary.base + "/generate", data=json.dumps(
                    {"tokens": PROMPT, "max_new": n,
                     "stream": True}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                for raw in resp:
                    line = raw.strip()
                    if not line.startswith(b"data: "):
                        continue
                    events.append(json.loads(line[6:]))
                    if events[-1].get("seq") == 1:
                        cluster.client.direct().patch_node_metadata(
                            "node-a",
                            labels={state_label: "cordon-required"})
            text = binary.wait_for(
                lambda t: _gauge(t, "tpu_router_migration_success") == 1,
                "the migration gauge")
            code, replicas = _http(binary.base + "/replicas")
            health_a, _ = _http(donor.base + "/healthz")
        finally:
            binary.stop()
            donor.close()
            peer.close()
        node_a = cluster.client.direct().get_node("node-a")
    toks = [e for e in events if "token" in e]
    solo = _solo(params, PROMPT, n)
    assert [e["seq"] for e in toks] == list(range(n))
    assert [e["token"] for e in toks] == solo[len(PROMPT):]
    assert events[-1] == {"done": True, "tokens": solo}
    assert _gauge(text, "tpu_router_migration_fallbacks") == 0
    assert _gauge(text, "tpu_router_replicas_draining") == 1
    assert node_a.metadata.annotations[DRAIN_INTENT_ANNOTATION].startswith(
        "upgrade:cordon-required@")
    summary = replicas["data"]["summary"]
    assert (summary["admitting"], summary["draining"]) == (1, 1)
    [a] = [r for r in replicas["data"]["replicas"] if r["id"] == "a"]
    assert a["drain_reason"] == "upgrade:cordon-required"
    assert health_a == 503
    assert not failures.failed
    assert tthreads.live_threads("router-ticker") == []


URL_ROLES = ("A", "B", "C")


def _mask(obj):
    """Floats (stamps, durations, self-times) to a marker."""
    if isinstance(obj, float):
        return "<float>"
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_mask(v) for v in obj]
    return obj


TIMED = ("tpu_router_request_stage_seconds",
         "tpu_router_proxy_overhead_seconds")


# the bodies that carry stamps and durations: their floats are masked
TIMED_BODIES = ("/requests", "/causes", "/trace?rid=1", "/trace?rid=2",
                "/trace?rid=3", "shed /causes", "shed /requests")


def _mask_metrics(text):
    out = []
    for line in text.splitlines():
        if line.startswith(TIMED) and not line.startswith(
                tuple(f + "_count" for f in TIMED)):
            line = line.rsplit(" ", 1)[0] + " <timed>"
        out.append(line)
    return out


def _scenario(main, weights, tmp_path):
    """One run of traffic through a binary over three fresh port
    replicas, then a second binary at ``--queue-high 0`` (every lane
    without headroom); the bodies of every endpoint, by name, with the
    floats of :data:`TIMED_BODIES` masked."""
    cluster = FakeCluster()
    for node in ("node-a", "node-b", "node-c"):
        cluster.add_node(node)
    reps = [Replica("torch", weights) for _ in URL_ROLES]
    out = {}

    def named(obj):
        text = json.dumps(obj, sort_keys=True)
        for rep, role in zip(reps, URL_ROLES):
            text = text.replace(rep.base, f"<url {role}>")
        return json.loads(text)

    with FakeAPIServer(cluster) as api:
        kc = _kubeconfig(tmp_path, api.base_url)
        seeds = ["--replica", f"a={reps[0].base}@node-a",
                 "--replica", f"b={reps[1].base}@node-b"]
        binary = Binary(main, ["--kubeconfig", kc, "--tick", "3600"]
                        + seeds)
        try:
            binary.wait_for(lambda t: _gauge(t, "tpu_router_replicas") == 2,
                            "first tick")
            b = binary.base
            out["healthz"] = _http(b + "/healthz")
            out["generate"] = _http(b + "/generate",
                                    {"tokens": PROMPT, "max_new": 4})
            out["generate_unknown_lane"] = _http(
                b + "/generate", {"tokens": PROMPT, "lane": "gold"})
            out["generate_bad_body"] = _http(b + "/generate", {"max_new": 2})
            out["stream"] = _sse(b + "/generate",
                                 {"tokens": PROMPT[:5], "max_new": 5,
                                  "stream": True, "lane": "batch"})
            out["register"] = _http(b + "/register", {
                "id": "c", "url": reps[2].base, "node": "node-c",
                "weight": 2})
            out["register_bad"] = _http(b + "/register", {"id": "d"})
            # A drains on its own: the router learns it from A's 503 and
            # serves the request on the next-best peer
            assert _http(reps[0].base + "/drain", {})[0] == 200
            out["retry_after_503"] = _http(
                b + "/generate", {"tokens": [7, 7, 2], "max_new": 3,
                                  "lane": "best-effort",
                                  "session": "s1"})
            for path in ("/replicas", "/lanes", "/requests", "/causes",
                         "/trace?rid=1", "/trace?rid=2", "/trace?rid=3",
                         "/trace?rid=9", "/trace?rid=x", "/nope"):
                out[path] = _http(b + path)
            out["metrics"] = _mask_metrics(_http(b + "/metrics")[1])
            out["node_c"] = {
                k: v for k, v in cluster.client.direct().get_node(
                    "node-c").metadata.labels.items()}
        finally:
            binary.stop()
        shed = Binary(main, ["--tick", "3600", "--queue-high", "0"]
                      + seeds[2:])
        try:
            shed.wait_for(lambda t: _gauge(t, "tpu_router_replicas") == 1,
                          "first tick")
            for lane in ("interactive", "batch", "best-effort"):
                out[f"shed_{lane}"] = _http(shed.base + "/generate", {
                    "tokens": PROMPT, "max_new": 2, "lane": lane})
            for path in ("/lanes", "/causes", "/requests"):
                out[f"shed {path}"] = _http(shed.base + path)
        finally:
            shed.stop()
    for rep in reps:
        rep.close()
    return {k: named(_mask(v) if k in TIMED_BODIES else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def bodies(weights, tmp_path_factory):
    ref = _load_cmd("router")
    return (_scenario(ref.main, weights, tmp_path_factory.mktemp("ref")),
            _scenario(router.main, weights, tmp_path_factory.mktemp("port")))


ENDPOINTS = ("healthz", "generate", "generate_unknown_lane",
             "generate_bad_body", "stream", "register", "register_bad",
             "retry_after_503", "/replicas", "/lanes", "/requests",
             "/causes", "/trace?rid=1", "/trace?rid=2", "/trace?rid=3",
             "/trace?rid=9", "/trace?rid=x", "/nope", "metrics", "node_c",
             "shed_interactive", "shed_batch", "shed_best-effort",
             "shed /lanes", "shed /causes", "shed /requests")


@pytest.mark.parametrize("name", ENDPOINTS)
def test_endpoint_bodies_equal_the_reference_binarys(bodies, name):
    ref, port = bodies
    assert port[name] == ref[name]


def test_the_scenario_covers_what_it_claims(bodies, weights):
    """The shared scenario did what the comparison relies on: tokens of
    a solo decode, a reroute after A's 503, the 429 shed, the router's
    own families."""
    _, params = weights
    _, port = bodies
    assert port["generate"] == [200, {"tokens": _solo(params, PROMPT, 4)}]
    stream = port["stream"]
    assert stream[-1] == {"done": True, "tokens": _solo(params,
                                                        PROMPT[:5], 5)}
    assert port["retry_after_503"] == [200, {
        "tokens": _solo(params, [7, 7, 2], 3)}]
    assert port["generate_unknown_lane"][0] == 400
    assert port["register"][0] == 200 and port["register_bad"][0] == 400
    assert port["shed_interactive"][0] == 503
    assert port["shed_batch"][0] == 429 and port["shed_batch"][1]["shed"]
    lanes = port["shed /lanes"][1]["data"]["lanes"]
    assert lanes["batch"]["shed"] == lanes["best-effort"]["shed"] == 1
    replicas = {r["id"]: r for r in port["/replicas"][1]["data"]["replicas"]}
    assert replicas["a"]["url"] == "<url A>" and replicas["c"]["weight"] == 2
    assert port["/trace?rid=3"][1]["data"]["stages"][-1][1] == "completed"
    kinds = port["/causes"][1]["data"]["timeline"]["counts"]
    assert kinds == {"router-requeue": 1}
    families = {line.split()[2] for line in port["metrics"]
                if line.startswith("# TYPE")}
    for family in ("tpu_router_request_stage_seconds",
                   "tpu_router_proxy_overhead_seconds",
                   "tpu_router_traces_closed", "tpu_router_replicas",
                   "tpu_router_migration_success"):
        assert family in families


def test_python_dash_m_runs_the_binary():
    """``python -m k8s_operator_libs_tpu_torch.router`` serves: no
    replica admits, so ``/healthz`` reads 503; SIGINT stops it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.router",
         "--port", str(port), "--tick", "0.2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                code, body = _http(f"http://127.0.0.1:{port}/healthz")
                break
            except urllib.error.URLError:
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
        assert (code, body) == (503, {"status": "no-replicas",
                                      "admitting": 0})
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    assert b"tpu-router on :%d" % port in out
    assert b"jax" not in out.lower()


# ---------------------------------------- registration during a tick


def _register_during_scrape(serving):
    pool = serving.ReplicaPool()
    for i in range(2):
        pool.register(serving.Replica(f"r{i}", f"n{i}",
                                      serving.SimReplicaRuntime()))

    def gate(replica):
        if "late" not in pool.replicas:
            pool.register(serving.Replica("late", "n9",
                                          serving.SimReplicaRuntime()))

    pool.scrape_gate = gate
    pool.scrape()
    return pool


def test_a_registration_during_a_scrape_keeps_the_scrape_whole():
    """The repair behind the binary's ``POST /register``: the handler
    registers while the ticker's scrape iterates the registry. The
    reference's pool changes its dict in place and the scrape raises;
    the port's replaces it, and the scrape finishes the replicas it
    began with."""
    from k8s_operator_libs_tpu import serving as jserving
    from k8s_operator_libs_tpu_torch import serving as tserving
    with pytest.raises(RuntimeError, match="changed size during iteration"):
        _register_during_scrape(jserving)
    pool = _register_during_scrape(tserving)
    assert sorted(pool.replicas) == ["late", "r0", "r1"]
    assert [pool.replicas[r].stats.stale for r in ("r0", "r1")] == \
        [False, False]
    pool.scrape()                       # the next scrape reads it too
    assert not pool.replicas["late"].stats.stale
    assert pool.deregister("late").id == "late"
    assert sorted(pool.replicas) == ["r0", "r1"]


class RegisteringReplica:
    """A replica stand-in whose first ``/metrics`` scrape registers
    another replica with the router before it answers: the registration
    lands while the router's ticker is inside its scrape."""

    def __init__(self):
        self.router = None
        replica = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if replica.router is not None:
                    router_url, replica.router = replica.router, None
                    code, _ = _http(router_url + "/register", {
                        "id": "late", "url": replica.url, "node": "node-z"})
                    assert code == 200
                body = b"tpu_workload_serve_queue_depth 0\n"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_binary_registers_during_its_tick_without_a_failed_tick():
    rep = RegisteringReplica()
    with TickFailures() as failures:
        binary = Binary(router.main, ["--tick", "0.05", "--replica",
                                      f"a={rep.url}@node-a"])
        try:
            binary.wait_for(lambda t: _gauge(t, "tpu_router_replicas") == 1,
                            "first tick")
            rep.router = binary.base
            binary.wait_for(lambda t: _gauge(t, "tpu_router_replicas") == 2,
                            "the registration")
            time.sleep(0.2)                  # a few more ticks
            code, body = _http(binary.base + "/replicas")
        finally:
            binary.stop()
            rep.close()
    assert code == 200
    assert sorted(r["id"] for r in body["data"]["replicas"]) == ["a", "late"]
    assert not failures.failed


def test_concurrent_registrations_lose_none_beside_a_scraper():
    """Registrations from many threads (as from the binary's handlers)
    beside a thread that scrapes and reads the registry: every replica
    lands, no scrape raises."""
    from k8s_operator_libs_tpu_torch import serving
    pool = serving.ReplicaPool()
    errors, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                pool.scrape()
                pool.admitting()
            except Exception as exc:
                errors.append(exc)

    def registrar(k):
        for i in range(25):
            pool.register(serving.Replica(f"r{k}-{i}", f"n{k}",
                                          serving.SimReplicaRuntime()))
            if i % 5 == 4:
                pool.deregister(f"r{k}-{i}")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        scan = threading.Thread(target=scraper)
        scan.start()
        workers = [threading.Thread(target=registrar, args=(k,))
                   for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        stop.set()
        scan.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not scan.is_alive() and not any(w.is_alive() for w in workers)
    assert errors == []
    assert len(pool.replicas) == 16 * 20
