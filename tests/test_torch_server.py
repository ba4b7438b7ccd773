"""The port's HTTP replica (``k8s_operator_libs_tpu_torch/server.py``) over
real sockets on the CPU: SSE streams, live migration ``/export`` ->
``/adopt`` -> ``/stream`` between two port replicas and between a port
replica and ``cmd/serve.py``'s JAX replica in both directions, the
request flight recorder (``/requests``, ``/trace``, ``X-TPU-Trace``),
``--trace-log``, ``--speculative self-int8`` and ``--ckpt`` on the CLI.

Migration is driven deterministically: the donor's batcher freezes after
a fixed number of steps, so the request is in flight when ``/drain``
arrives, and the donor's fake clock keeps the drain hold closed until
``/export`` took the request. No step of these tests races a decode."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu.obs.reqtrace import \
    validate_timeline as jax_validate_timeline
from k8s_operator_libs_tpu.utils.clock import FakeClock as JFakeClock
from k8s_operator_libs_tpu_torch import convert, server
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.obs.reqtrace import validate_timeline
from k8s_operator_libs_tpu_torch.obs.trace import JsonlSink, Tracer
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

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
        f"torch_port_cmd_{name}", REPO / "cmd" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class GatedBatcher:
    """A batcher that freezes after ``left`` more steps (None: never).
    Frozen, it reads as idle, so the runtime's stepper sleeps with its
    lock free for the HTTP handlers; everything else goes through to the
    batcher."""

    def __init__(self, srv):
        self.srv = srv
        self.left = None
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self.srv, name)

    @property
    def idle(self):
        return self.left == 0 or self.srv.idle

    def step(self, n=1):
        if self.left is not None:
            self.left -= 1
        self.steps += 1
        return self.srv.step(n)


class Replica:
    """One replica of either package behind a real HTTP server on port 0.
    ``gate(n)`` lets its batcher take ``n`` more steps and then freezes
    it."""

    def __init__(self, kind, weights, clock=None, chunk=1, **kw):
        tree, params = weights
        if kind == "jax":
            cli = _load_cmd("serve")
            self.rt = cli.ServingRuntime(
                tree, JCFG, GEOMETRY["max_slots"], GEOMETRY["capacity"],
                GEOMETRY["block_size"], chunk, clock=clock, **kw)
            self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                             cli.make_handler(self.rt))
        else:
            self.rt = server.ServingRuntime(params, TCFG, chunk=chunk,
                                            clock=clock, **GEOMETRY, **kw)
            self.httpd = server.make_server(self.rt, "127.0.0.1", 0)
        self.kind = kind
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.batcher = self.rt.srv = GatedBatcher(self.rt.srv)

    def gate(self, n):
        self.batcher.left = n

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.rt.stop()
        self.thread.join(timeout=10)


def _http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            text = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as err:
        text, code = err.read().decode(), err.code
    try:
        return code, json.loads(text)
    except ValueError:
        return code, text


class SSEClient(threading.Thread):
    """Reads one SSE response to its end into ``events``."""

    def __init__(self, url, body=None, headers=None):
        super().__init__(daemon=True)
        data = None if body is None else json.dumps(body).encode()
        self.req = urllib.request.Request(
            url, data=data, headers=headers or {},
            method="POST" if data is not None else "GET")
        self.events = []
        self.content_type = None
        self.start()

    def run(self):
        with urllib.request.urlopen(self.req, timeout=120) as resp:
            self.content_type = resp.headers["Content-Type"]
            for raw in resp:
                line = raw.strip()
                if line.startswith(b"data: "):
                    self.events.append(json.loads(line[6:]))

    def tokens(self):
        return [e for e in self.events if "token" in e]

    def wait_tokens(self, n, timeout=60.0):
        deadline = time.monotonic() + timeout
        while len(self.tokens()) < n:
            assert time.monotonic() < deadline, self.events
            time.sleep(0.005)


@pytest.mark.parametrize("draft", [None, "self-int8"])
def test_sse_stream_is_gapless_and_ends_in_done(weights, draft):
    _, params = weights
    rep = Replica("torch", weights, chunk=2, draft=draft, spec_k=3)
    try:
        n = 11
        client = SSEClient(rep.base + "/generate",
                           {"tokens": PROMPT, "max_new": n, "stream": True})
        client.join(timeout=120)
        assert client.content_type == "text/event-stream"
        ev = client.events
        assert "rid" in ev[0] and "trace" in ev[0]
        assert [e["seq"] for e in client.tokens()] == list(range(n))
        solo = _solo(params, PROMPT, n)
        assert [e["token"] for e in client.tokens()] == solo[len(PROMPT):]
        assert ev[-1] == {"done": True, "tokens": solo}
        # blocking /generate beside it, then the request records
        code, body = _http(rep.base + "/generate",
                           {"tokens": PROMPT[:5], "max_new": 4})
        assert code == 200 and body["tokens"] == _solo(params, PROMPT[:5], 4)
        code, body = _http(rep.base + "/requests")
        assert code == 200 and body["kind"] == "requests"
        assert body["data"]["closed"] == 2 and body["data"]["open"] == 0
        for timeline in body["data"]["last"]:
            assert validate_timeline(timeline) == []
    finally:
        rep.close()


def test_trace_endpoint_and_trace_header(weights):
    rep = Replica("torch", weights)
    try:
        assert _http(rep.base + "/trace")[0] == 400
        assert _http(rep.base + "/trace?rid=x")[0] == 400
        assert _http(rep.base + "/trace?rid=99")[0] == 404
        assert _http(rep.base + "/stream?rid=99")[0] == 404
        assert _http(rep.base + "/stream")[0] == 400
        rids = {}
        for name, header in (("joined", "tabc/s0001/2"),
                             ("garbled", "not a/trace//header"),
                             ("none", None)):
            headers = {} if header is None else {"X-TPU-Trace": header}
            client = SSEClient(rep.base + "/generate",
                               {"tokens": PROMPT, "max_new": 3,
                                "stream": True}, headers=headers)
            client.join(timeout=120)
            rids[name] = client.events[0]["rid"]
        timelines = {}
        for name, rid in rids.items():
            code, body = _http(rep.base + f"/trace?rid={rid}")
            assert code == 200 and body["kind"] == "trace"
            timelines[name] = body["data"]
            assert body["data"]["open"] is False
            assert validate_timeline(body["data"]) == []
            assert jax_validate_timeline(body["data"]) == []
        assert timelines["joined"]["trace_id"] == "tabc"
        assert timelines["joined"]["hop"] == 3
        for name in ("garbled", "none"):
            assert timelines[name]["hop"] == 0
            assert timelines[name]["trace_id"] not in ("tabc", "not a")
        assert timelines["garbled"]["trace_id"] != \
            timelines["none"]["trace_id"]
    finally:
        rep.close()


def _migrate(donor, peer, params, n=12, after=3):
    """Stream a request from ``donor``, freeze it after ``after`` steps,
    POST /drain and /export to the donor, /adopt on the peer, and read
    the rest on the peer's /stream. Returns the donor's and the peer's
    trace timelines after checking the spliced stream."""
    donor.gate(after)
    client = SSEClient(donor.base + "/generate",
                       {"tokens": PROMPT, "max_new": n, "stream": True})
    client.wait_tokens(after)
    rid = client.events[0]["rid"]
    code, body = _http(donor.base + "/drain", {})
    assert code == 200 and body == {"handoff": []}
    code, body = _http(donor.base + "/export", {"rid": rid})
    assert code == 200, body            # not the re-submit fallback
    assert body["kind"] == "migration"
    payload = body["data"]
    assert len(payload["generated"]) == after
    code, body = _http(peer.base + "/adopt", payload)
    assert code == 200, body
    new_rid = body["data"]["rid"]
    assert body["data"]["generated"] == payload["generated"]
    rest = SSEClient(peer.base + f"/stream?rid={new_rid}")
    rest.join(timeout=120)
    client.join(timeout=120)
    assert client.events[-1] == {"detached": True}
    assert {"draining": True} in client.events
    spliced = client.tokens() + rest.tokens()
    solo = _solo(params, PROMPT, n)
    assert [e["seq"] for e in spliced] == list(range(n))
    assert [e["token"] for e in spliced] == solo[len(PROMPT):]
    assert rest.events[-1] == {"done": True, "tokens": solo}
    code, dtrace = _http(donor.base + f"/trace?rid={rid}")
    assert code == 200
    code, ptrace = _http(peer.base + f"/trace?rid={new_rid}")
    assert code == 200
    return dtrace["data"], ptrace["data"]


@pytest.mark.parametrize("donor_kind,peer_kind", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_live_migration_over_http(weights, donor_kind, peer_kind):
    """The drain hold keeps the streamed request in flight (the donor's
    fake clock never lets it expire), so /export answers 200; the
    spliced stream is gapless and equals a solo decode; both hops'
    timelines carry one trace id and pass the reference's checks."""
    _, params = weights
    clock = JFakeClock() if donor_kind == "jax" else FakeClock()
    donor = Replica(donor_kind, weights, clock=clock, drain_hold_s=60.0)
    peer = Replica(peer_kind, weights)
    try:
        dtl, ptl = _migrate(donor, peer, params)
        assert dtl["trace_id"] == ptl["trace_id"]
        assert ptl["hop"] == dtl["hop"] + 1
        assert [s[1] for s in dtl["stages"]][-2:] == ["drain", "export"]
        for check in (validate_timeline, jax_validate_timeline):
            assert check(dtl, closed=False) == []
            assert check(ptl) == []
        # the donor is draining and the peer still serves
        assert _http(donor.base + "/healthz")[0] == 503
        assert _http(peer.base + "/healthz")[0] == 200
    finally:
        donor.close()
        peer.close()


@pytest.mark.parametrize("donor_kind,peer_kind", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_router_live_migrates_a_stream(weights, donor_kind, peer_kind):
    """``cmd/router.py`` in front of two replicas: the client streams
    through the router, the serving replica (the first registered; its
    batcher frozen after 3 steps, so it cannot finish first) is drained
    at the client's third token, and the router's relay exports the
    request, adopts it on the peer and reattaches there. The client sees
    one gapless stream equal to a solo decode, the router counts one
    migration and no fallback, and both replicas' timelines join the
    router's trace."""
    from k8s_operator_libs_tpu.obs.metrics import MetricsHub as JHub
    from k8s_operator_libs_tpu.serving.pool import Replica as PoolReplica
    from k8s_operator_libs_tpu.serving.pool import ReplicaPool

    _, params = weights
    routercli = _load_cmd("router")
    donor = Replica(donor_kind, weights)
    peer = Replica(peer_kind, weights)
    donor.gate(3)
    pool = ReplicaPool(component="libtpu")
    for i, rep in enumerate((donor, peer)):
        pool.register(PoolReplica(f"r{i}", f"node-{i}",
                                  routercli.HTTPRuntime(rep.base),
                                  url=rep.base))
    front = routercli.RouterFront(pool, metrics=JHub(), proxy_timeout=60.0)
    front.tick()
    try:
        n = 12
        events = []

        def emit(event):
            events.append(event)
            if event.get("seq") == 2:
                with front.lock:
                    busy = [k for k, v in front._outstanding.items() if v]
                assert busy == ["r0"]
                code, _ = _http(donor.base + "/drain", {})
                assert code == 200

        assert front.generate_stream(PROMPT, n, emit=emit) == 200
        toks = [e for e in events if "token" in e]
        solo = _solo(params, PROMPT, n)
        assert [e["seq"] for e in toks] == list(range(n))
        assert [e["token"] for e in toks] == solo[len(PROMPT):]
        assert events[-1] == {"done": True, "tokens": solo}
        assert front._migrations == 1 and front._migration_fallbacks == 0
        trace_id = events[0]["trace"].split("/")[0]
        hops = []
        for rep in (donor, peer):
            code, body = _http(rep.base + "/trace?rid=0")
            assert code == 200
            assert body["data"]["trace_id"] == trace_id
            hops.append(body["data"]["hop"])
        assert hops[1] == hops[0] + 1
    finally:
        donor.close()
        peer.close()


def test_adopt_and_export_refusals(weights):
    rep = Replica("torch", weights)
    try:
        assert _http(rep.base + "/export", {"rid": 999})[0] == 404
        assert _http(rep.base + "/export", {"nope": 1})[0] == 400
        bad = {"version": 99, "kind": "batcher", "prompt": [1],
               "max_new": 4, "generated": [], "last_token": 0,
               "sampler": {"kind": "greedy"},
               "kv": {"version": 99, "block_size": 8, "start": 0,
                      "length": 1, "quantized": False, "dtype": "float32"}}
        assert _http(rep.base + "/adopt", bad)[0] == 409
        assert _http(rep.base + "/nowhere", {})[0] == 404
        _http(rep.base + "/drain", {})
        assert _http(rep.base + "/adopt", bad)[0] == 503
    finally:
        rep.close()


def test_trace_log_writes_one_serve_step_record_per_step(weights, tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = Tracer(sink=JsonlSink(str(path)))
    rep = Replica("torch", weights, chunk=2, tracer=tracer)
    try:
        code, _ = _http(rep.base + "/generate",
                        {"tokens": PROMPT, "max_new": 7})
        assert code == 200
    finally:
        rep.close()
        tracer.sink.close()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == rep.batcher.steps > 0
    for rec in records:
        assert rec["name"] == "serve-step" and rec["attrs"]["chunk"] == 2
        assert rec["duration_s"] >= 0 and rec["error"] is None
    assert any(rec["attrs"].get("ticks") for rec in records)


def test_trace_sinks_and_rotation(tmp_path):
    """The span sinks: a list in memory, nothing, and a JSONL file that
    rotates to one ``.1`` sibling past its cap. Nested spans share the
    root's trace id and name their parent."""
    from k8s_operator_libs_tpu_torch.obs.trace import ListSink, NullSink

    clock = FakeClock(5.0)
    sink = ListSink()
    tracer = Tracer(sink=sink, clock=clock)
    with tracer.span("serve-step", chunk=2) as root:
        with tracer.span("inner") as inner:
            clock.sleep(0.25)
            inner.set("ticks", 2)
        root.set("running", 1)
    with pytest.raises(ValueError):
        with tracer.span("failing"):
            raise ValueError("boom")
    a, b, c = sink.records
    assert (a["name"], a["parent"], a["attrs"]) == ("inner", b["span"],
                                                    {"ticks": 2})
    assert a["trace"] == b["trace"] != c["trace"] and b["parent"] is None
    assert a["duration_s"] == 0.25 and a["start"] == 5.0
    assert c["error"] == "ValueError" and b["error"] is None
    Tracer(sink=NullSink()).span("x").__enter__()
    path = tmp_path / "spans.jsonl"
    jsonl = JsonlSink(str(path), max_bytes=200)
    for i in range(6):
        jsonl.emit({"name": "serve-step", "i": i, "pad": "x" * 40})
    jsonl.close()
    live = [json.loads(x) for x in path.read_text().splitlines()]
    old = [json.loads(x) for x in
           (tmp_path / "spans.jsonl.1").read_text().splitlines()]
    assert [r["i"] for r in old + live] == list(range(6))[-len(old + live):]
    assert live and old and path.stat().st_size <= 200


# ------------------------------------------------------------ the CLI

def _start_cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.server",
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--max-slots", "2", "--capacity", "64", "--block-size", "8",
         *args], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc


def _cli_port(proc, lines=None, timeout=120.0):
    """The port from the server's start-up line; the lines read on the
    way go to ``lines``."""
    deadline = time.monotonic() + timeout
    lines = [] if lines is None else lines
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "torch-serve on :" in line:
            return int(line.split("torch-serve on :")[1].split()[0])
    proc.kill()
    raise AssertionError("server did not start:\n" + "".join(lines))


def _stop_cli(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, out


def test_cli_speculative_serves_stream_and_blocking(tmp_path):
    """``--speculative self-int8`` on the CPU: a streamed and a blocking
    /generate, /metrics with the speculative families, and the
    ``--trace-log`` file of serve-step spans after a SIGTERM drain."""
    log = tmp_path / "trace.jsonl"
    proc = _start_cli(["--model", "tiny", "--speculative", "self-int8",
                       "--spec-k", "3", "--chunk", "2", "--trace-log",
                       str(log)])
    try:
        base = f"http://127.0.0.1:{_cli_port(proc)}"
        client = SSEClient(base + "/generate",
                           {"tokens": PROMPT, "max_new": 9, "stream": True})
        client.join(timeout=120)
        toks = [e["token"] for e in client.tokens()]
        assert [e["seq"] for e in client.tokens()] == list(range(9))
        assert client.events[-1] == {"done": True, "tokens": PROMPT + toks}
        code, body = _http(base + "/generate",
                           {"tokens": PROMPT, "max_new": 9})
        assert code == 200 and body["tokens"][:len(PROMPT)] == PROMPT
        assert len(body["tokens"]) == len(PROMPT) + 9
        code, text = _http(base + "/metrics")
        assert code == 200
        for family in ("tpu_workload_spec_accept_ratio_bucket",
                       "tpu_workload_weight_stream_gbs ",
                       "# HELP tpu_workload_spec_accept_ratio Accepted",
                       'tpu_workload_build_info{model="tiny"'):
            assert family in text, family
    finally:
        rc, out = _stop_cli(proc)
    assert rc == 0, out
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert records and all(r["name"] == "serve-step" for r in records)
    assert any(r["attrs"].get("spec_k") == 3 for r in records)


def test_cli_ckpt_fails_fast_without_a_checkpoint(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for ckpt in (empty, tmp_path / "missing"):
        proc = _start_cli(["--model", "tiny", "--ckpt", str(ckpt)])
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert "no checkpoint found" in out
    assert not (tmp_path / "missing").exists()


def test_cli_serves_a_port_trainer_checkpoint(tmp_path):
    """A checkpoint the port's trainer wrote (seed 3, one step) is what
    ``--ckpt`` serves: the same tokens as the batcher over the restored
    parameters, not those of the seeded random weights."""
    from k8s_operator_libs_tpu_torch.parallel.fsdp import init_train_state
    from k8s_operator_libs_tpu_torch.train.harness import \
        CheckpointingTrainer

    cfg = TConfig.tiny()
    trainer = CheckpointingTrainer(cfg, str(tmp_path / "ck"), device="cpu")
    state = init_train_state(cfg, 3, device="cpu")
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    result = trainer.run(state, iter([batch]), 1)
    assert trainer.save(result.state) == 1
    restored = trainer.init_or_resume().params

    def served_by(p):
        srv = ContinuousBatcher(p, cfg, max_slots=2, capacity_per_slot=64,
                                block_size=8)
        rid = srv.submit(np.asarray(PROMPT, np.int32), 6)
        out = {}
        while rid not in out:
            srv.step(4)
            out.update(srv.poll())
        return out[rid].tolist()

    want = served_by(restored)
    proc = _start_cli(["--model", "tiny", "--ckpt", str(tmp_path / "ck")])
    head = []
    try:
        base = f"http://127.0.0.1:{_cli_port(proc, head)}"
        code, body = _http(base + "/generate", {"tokens": PROMPT,
                                                "max_new": 6})
    finally:
        rc, out = _stop_cli(proc)
    assert code == 200 and body["tokens"] == want
    assert "serving checkpoint step 1" in "".join(head)
    assert rc == 0
    from k8s_operator_libs_tpu_torch.models.llama import init_params as tinit
    assert served_by(tinit(cfg, seed=0, device="cpu")) != want
