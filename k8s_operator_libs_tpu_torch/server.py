"""HTTP inference server over the port's continuous batcher.

Port of ``cmd/serve.py`` (kept out of ``cmd/``: this package stands
alone). One background stepper thread owns the batcher; request handlers
only touch host state under the runtime's lock. ``--chunk N`` runs N
decode ticks per ``step`` to amortize the readback. The wire formats are
the reference's, so ``cmd/router.py`` can live-migrate a stream between
a port replica and a JAX replica in either direction.

HTTP surface (stdlib ``ThreadingHTTPServer``, JSON):

- ``POST /generate`` ``{"tokens": [int...], "max_new": N}`` -> blocks until
  the request completes: ``{"tokens": [prompt + generated]}``; 503 once
  draining, 422 when the request exceeds the slot capacity. With
  ``"stream": true`` the answer is SSE (``text/event-stream``): a
  ``{"rid", "trace"}`` header event, one ``{"seq": i, "token": t}`` event
  per generated token (gapless per-request sequence numbers), a
  ``{"draining": true}`` notice when the server begins draining, and a
  final ``{"done": true, "tokens": [...]}``, or ``{"detached": true}``
  when the request was exported to a peer.
- ``POST /export`` ``{"rid": N}`` -> freeze one in-flight request at a step
  boundary and return its migration payload (``{"kind": "migration",
  "data": ...}``, KV in the ``models/paged.py`` wire encoding); the
  request leaves this server. 404 for a rid not running here.
- ``POST /adopt`` payload -> ``{"kind": "adopted", "data": {"rid",
  "generated", "trace"}}``: the request continues here and streams on
  ``GET /stream?rid=``. 409 when the payload cannot be adopted.
- ``GET /stream?rid=N`` -> attach to a running request's SSE stream.
- ``POST /drain`` -> stop admission and return ``{"handoff": [[rid,
  [tokens...], max_new], ...]}``, the queue a peer replica takes over.
  In-flight requests still finish; streamed ones first wait, for at most
  ``drain_hold_s``, so that an ``/export`` can take them to a peer.
- ``GET /requests`` -> the request flight recorder's ring and aggregate;
  ``GET /trace?rid=N`` -> one request's stage timeline (400 without a
  parseable rid, 404 for an unknown one). An ``X-TPU-Trace`` header (or
  a ``"trace"`` field) joins the caller's trace; a garbled one starts a
  fresh root.
- ``GET /healthz`` -> 200 ``{"status": "ok"}``, or 503 once draining or
  failed.
- ``GET /metrics`` -> Prometheus text under the ``tpu_workload`` prefix.

Run: ``python -m k8s_operator_libs_tpu_torch.server --model tiny --device
cuda --port 8200 [--speculative self-int8 --spec-k 4] [--trace-log PATH]
[--ckpt DIR]``. Weights are seeded random unless ``--ckpt`` names a
checkpoint directory of the port's trainer (``python -m
k8s_operator_libs_tpu_torch.train``), whose latest step is served; with
no checkpoint there the server exits non-zero. SIGTERM drains, waits for
in-flight requests up to ``--grace`` seconds, and exits.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import __version__
from .models.llama import LlamaConfig, init_params
from .models.paged import decode_kv_payload, encode_kv_payload
from .models.serve import ContinuousBatcher
from .obs.metrics import MetricsHub, render_gauges
from .obs.reqtrace import (TRACE_HEADER, RequestTraceRecorder,
                           parse_trace_header)
from .obs.trace import JsonlSink, Tracer
from .utils.clock import RealClock

logger = logging.getLogger("torch-serve")

MODELS = {"tiny": LlamaConfig.tiny, "small": LlamaConfig.small}


class ServingRuntime:
    """Batcher + stepper thread + completion events + SSE buffers."""

    def __init__(self, params, cfg, max_slots, capacity, block_size, chunk,
                 hub=None, tracer=None, draft=None, spec_k=4, clock=None,
                 drain_hold_s=2.0):
        self.hub = hub if hub is not None else MetricsHub()
        self._clock = clock or RealClock()
        # drain barrier: once draining, streamed in-flight requests pause
        # for up to this long so that a router's /export reaches them
        # before they finish; with no router they complete afterwards
        self.drain_hold_s = drain_hold_s
        self._drain_hold_until = None
        self.reqtrace = RequestTraceRecorder(clock=self._clock)
        self.srv = ContinuousBatcher(params, cfg, max_slots=max_slots,
                                     capacity_per_slot=capacity,
                                     block_size=block_size,
                                     metrics=self.hub, tracer=tracer,
                                     draft=draft, spec_k=spec_k)
        self.chunk = chunk
        self.lock = threading.Lock()
        self.results = {}
        self.events = {}
        # rid -> SSE event dicts ({"seq", "token"} per token, drain
        # notices), for requests submitted or adopted as streams
        self.streams = {}
        self._stream_seq = {}
        self.draining = False
        self.failed = False
        self.handoff = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, name="serve-stepper",
                                       daemon=True)
        self.thread.start()

    def submit(self, tokens, max_new, stream=False, trace=None):
        """(rid, completion event), or None while draining/failed.
        ``trace`` (a parsed context) joins the caller's trace."""
        with self.lock:
            if self.draining or self.failed:
                return None
            rid = self.srv.submit(np.asarray(tokens, np.int32), max_new)
            ev = self.events[rid] = threading.Event()
            if stream:
                self.streams[rid] = []
                self._stream_seq[rid] = 0
            # the batcher admits from its own queue, so queued, assigned
            # and prefill are one edge at this hop; open the timeline
            # before the stepper can finish the request
            self.reqtrace.begin(rid, parent=trace)
            for stage in ("queued", "assigned", "prefill"):
                self.reqtrace.stage(rid, stage)
        return rid, ev

    def result(self, rid):
        with self.lock:
            return self.results.pop(rid, None)

    def export(self, rid):
        """Freeze one in-flight request and return its migration payload
        (KV already wire-encoded, the trace context beside it). Its waiter
        unblocks with the detached signal. KeyError if ``rid`` is not
        running here."""
        with self.lock:
            payload = self.srv.export_slot(rid)
            self.reqtrace.stage(rid, "drain")
            payload["kv"] = encode_kv_payload(payload["kv"])
            self.results[rid] = None
            ev = self.events.pop(rid, None)
            if ev:
                ev.set()
        self.reqtrace.stage(rid, "export")
        ctx = self.reqtrace.context(rid)
        if ctx is not None:
            payload["trace"] = ctx.encode()
        return payload

    def adopt(self, obj):
        """Restore a migration payload; the request streams on
        ``/stream?rid=``. (rid, generated so far), or None while
        draining/failed; a rejection raises (409 over HTTP)."""
        with self.lock:
            if self.draining or self.failed:
                return None
            payload = dict(obj)
            # the donor's trace context; garbled or missing parses to None
            parent = parse_trace_header(payload.pop("trace", None))
            payload["kv"] = decode_kv_payload(payload["kv"])
            rid = self.srv.adopt_slot(payload)
            generated = [int(t) for t in payload["generated"]]
            self.events[rid] = threading.Event()
            self.streams[rid] = []
            # sequence numbers continue from the donor's splice point
            self._stream_seq[rid] = len(generated)
            self.reqtrace.begin(rid, parent=parent)
            for stage in ("queued", "assigned", "prefill"):
                self.reqtrace.stage(rid, stage)
        return rid, generated

    def stream_state(self, rid):
        """(copy of the rid's SSE events, done?), (None, False) for an
        unknown rid. Done means the terminal result (tokens, or None for
        detached) waits in :meth:`result`."""
        with self.lock:
            buf = self.streams.get(rid)
            return (list(buf) if buf is not None else None,
                    rid in self.results)

    def stream_close(self, rid):
        with self.lock:
            self.streams.pop(rid, None)
            self._stream_seq.pop(rid, None)

    def drain(self):
        """Stop admission; return the untouched queue for a peer. Open
        streams get a ``{"draining": true}`` notice and the stepper holds
        them (bounded by ``drain_hold_s``) for a peer's export; the
        other in-flight requests finish here."""
        with self.lock:
            if self.handoff is None:
                self.draining = True
                if self.streams:
                    self._drain_hold_until = (self._clock.now()
                                              + self.drain_hold_s)
                self.srv.drain()
                self.handoff = [(rid, [int(t) for t in prompt], max_new)
                                for rid, prompt, max_new
                                in self.srv.handoff()]
                # queued-but-never-admitted requests will not complete
                # here: release their waiters with a None result
                for rid, _, _ in self.handoff:
                    self.results[rid] = None
                    ev = self.events.pop(rid, None)
                    if ev:
                        ev.set()
                for buf in self.streams.values():
                    buf.append({"draining": True})
            return self.handoff

    def idle(self):
        with self.lock:
            return self.srv.idle

    def delivered(self):
        with self.lock:
            return not self.events and not self.results

    def undelivered(self):
        with self.lock:
            return sorted(set(self.results) | set(self.events))

    def metrics_text(self):
        with self.lock:
            gauges = {"serve_up": 1.0,
                      "serve_failed": 1.0 if self.failed else 0.0}
        return (render_gauges({"serve": gauges}, prefix="tpu_workload")
                + self.hub.render(prefix="tpu_workload"))

    def _held(self):
        """True while the drain barrier holds streamed requests."""
        return (self.draining and bool(self.streams)
                and self._drain_hold_until is not None
                and self._clock.now() < self._drain_hold_until)

    def _step_locked(self):
        """One batcher step, then the SSE buffers and completions."""
        self.srv.step(self.chunk)
        if self.streams:
            for rid, toks in self.srv.poll_stream().items():
                buf = self.streams.get(rid)
                if buf is None:
                    continue
                seq = self._stream_seq.get(rid, 0)
                for tok in toks:
                    buf.append({"seq": seq, "token": int(tok)})
                    seq += 1
                self._stream_seq[rid] = seq
                self.reqtrace.token_appended(rid)
        for rid, toks in self.srv.poll().items():
            self.results[rid] = [int(t) for t in toks]
            self.reqtrace.stage(rid, "completed")
            ev = self.events.pop(rid, None)
            if ev:
                ev.set()

    def _loop(self):
        while not self._stop.is_set():
            try:
                with self.lock:
                    busy = not self.srv.idle and not self._held()
                    if busy:
                        self._step_locked()
            except Exception:  # a dead stepper must fail the server, not hang its waiters
                logger.exception("stepper crashed; failing the server")
                with self.lock:
                    self.failed = True
                    for rid, ev in list(self.events.items()):
                        self.results[rid] = None
                        ev.set()
                    self.events.clear()
                return
            # a lock is not handed to its waiters on release: without a
            # pause after a busy step the stepper takes it straight back
            # and requests waiting in submit() miss step after step
            self._stop.wait(0.0005 if busy else 0.005)

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=30)


def _query_rid(path):
    """The ``rid`` query parameter as an int, or None."""
    try:
        return int(parse_qs(urlparse(path).query)["rid"][0])
    except (KeyError, ValueError, IndexError):
        return None


class Handler(BaseHTTPRequestHandler):
    """Reads its runtime from the server (``make_server`` sets
    ``httpd.rt``); a class that closed over the runtime would sit in a
    reference cycle and keep the weights alive after shutdown until a
    garbage collection."""

    def log_message(self, *a):  # quiet
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _sse(self, obj):
        self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        self.wfile.flush()

    def _sse_pump(self, rid, poll_sleep=0.005):
        """Relay one request's SSE events until its terminal state:
        ``{"done", "tokens"}`` when it completed here, ``{"detached"}``
        when it was exported (or drained past). A vanished client just
        ends the pump."""
        rt = self.server.rt
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            head = {"rid": rid}
            ctx = rt.reqtrace.context(rid)
            if ctx is not None:
                head["trace"] = ctx.encode()
            self._sse(head)
            sent = 0
            while True:
                buf, done = rt.stream_state(rid)
                if buf is None:
                    return
                for item in buf[sent:]:
                    self._sse(item)
                sent = len(buf)
                if done:
                    break
                time.sleep(poll_sleep)
            final = rt.result(rid)
            self._sse({"detached": True} if final is None
                      else {"done": True, "tokens": final})
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            rt.stream_close(rid)

    def do_GET(self):
        rt = self.server.rt
        path = urlparse(self.path).path
        if path == "/stream":
            rid = _query_rid(self.path)
            if rid is None:
                self._json(400, {"error": "want /stream?rid=N"})
            elif rt.stream_state(rid)[0] is None:
                self._json(404, {"error": f"no stream for rid {rid}"})
            else:
                self._sse_pump(rid)
        elif path == "/requests":
            self._json(200, {"kind": "requests",
                             "data": rt.reqtrace.payload()})
        elif path == "/trace":
            rid = _query_rid(self.path)
            timeline = None if rid is None else rt.reqtrace.trace_payload(rid)
            if rid is None:
                self._json(400, {"error": "want /trace?rid=N"})
            elif timeline is None:
                self._json(404, {"error": f"no trace for rid {rid}"})
            else:
                self._json(200, {"kind": "trace", "data": timeline})
        elif path == "/healthz":
            if rt.failed:
                self._json(503, {"status": "failed"})
            elif rt.draining:
                self._json(503, {"status": "draining"})
            else:
                self._json(200, {"status": "ok"})
        elif path == "/metrics":
            body = rt.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        rt = self.server.rt
        if self.path == "/drain":
            self._json(200, {"handoff": rt.drain()})
            return
        if self.path not in ("/generate", "/export", "/adopt"):
            self._json(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
        except (ValueError, TypeError) as exc:
            self._json(400, {"error": f"bad request: {exc}"})
            return
        if self.path == "/export":
            self._export(rt, req)
        elif self.path == "/adopt":
            self._adopt(rt, req)
        else:
            self._generate(rt, req)

    def _export(self, rt, req):
        try:
            rid = int(req["rid"])
        except (ValueError, KeyError, TypeError) as exc:
            self._json(400, {"error": f"bad export: {exc}"})
            return
        try:
            payload = rt.export(rid)
        except KeyError:
            self._json(404, {"error": f"rid {rid} is not running here"})
            return
        self._json(200, {"kind": "migration", "data": payload})

    def _adopt(self, rt, req):
        try:
            adopted = rt.adopt(req)
        except (ValueError, KeyError, TypeError) as exc:
            # KVPayloadError is a ValueError: a rejection, not a fault;
            # the caller falls back to a re-prefill
            self._json(409, {"error": f"adoption rejected: {exc}"})
            return
        if adopted is None:
            self._json(503, {"error": "draining or failed; adopt on a "
                                      "peer"})
            return
        rid, generated = adopted
        ctx = rt.reqtrace.context(rid)
        self._json(200, {"kind": "adopted",
                         "data": {"rid": rid, "generated": generated,
                                  "trace": (None if ctx is None
                                            else ctx.encode())}})

    def _generate(self, rt, req):
        try:
            tokens = [int(t) for t in req["tokens"]]
            max_new = int(req.get("max_new", 32))
            stream = bool(req.get("stream", False))
        except (ValueError, KeyError, TypeError) as exc:
            self._json(400, {"error": f"bad request: {exc}"})
            return
        # a missing or garbled context parses to None: a fresh root
        trace = (parse_trace_header(req.get("trace"))
                 or parse_trace_header(self.headers.get(TRACE_HEADER)))
        try:
            sub = rt.submit(tokens, max_new, stream=stream, trace=trace)
        except (ValueError, TypeError) as exc:   # over capacity etc.
            self._json(422, {"error": str(exc)})
            return
        if sub is None:
            self._json(503, {"error": "draining or failed; submit to a "
                                      "peer"})
            return
        rid, ev = sub
        if stream:
            self._sse_pump(rid)
            return
        ev.wait()
        toks = rt.result(rid)
        if toks is None:
            self._json(503, {"error": "not served here; resubmit to a "
                                      "peer"})
        else:
            self._json(200, {"tokens": toks})


def make_server(rt: ServingRuntime, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """The HTTP server over ``rt`` (port 0 picks a free port; read it
    back from ``server_address``). The caller runs ``serve_forever``."""
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.rt = rt
    httpd.daemon_threads = True
    return httpd


def drain_then_shutdown(rt, httpd, grace, poll=0.05, settle=0.5):
    """The SIGTERM drain, bounded by the grace period: finish in-flight
    requests, hand the queue off, then stop the HTTP server."""
    clock = RealClock()
    logger.info("SIGTERM: draining (finish in-flight, hand off queue)")
    handoff = rt.drain()
    if handoff:
        logger.info("handoff queue: %d requests", len(handoff))
    deadline = clock.now() + max(0.0, grace - settle)
    while not (rt.idle() and rt.delivered()):
        if clock.now() >= deadline:
            lost = rt.undelivered()
            logger.warning("drain deadline (%.1fs grace) hit with %d "
                           "undelivered request(s): %s", grace, len(lost),
                           ",".join(map(str, lost)) or "<none>")
            break
        clock.sleep(poll)
    else:
        clock.sleep(settle)
    httpd.shutdown()


def build_params(args):
    """(params, cfg): the latest checkpoint of the port's trainer under
    ``--ckpt``, or seeded random weights. A ``--ckpt`` with no checkpoint
    exits: serving random weights behind a green healthz is not a
    fallback."""
    cfg = MODELS[args.model]()
    if not args.ckpt:
        return init_params(cfg, seed=args.seed, device=args.device), cfg
    from .train.harness import CheckpointingTrainer
    if not Path(args.ckpt).is_dir():
        raise SystemExit(f"--ckpt {args.ckpt}: no checkpoint found")
    trainer = CheckpointingTrainer(cfg, args.ckpt, device=args.device)
    try:
        if trainer.latest_step is None:
            raise SystemExit(f"--ckpt {args.ckpt}: no checkpoint found")
        state = trainer.init_or_resume(args.seed)
    finally:
        trainer.close()
    logger.info("serving checkpoint step %d from %s", state.step, args.ckpt)
    return state.params, cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=sorted(MODELS))
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="serve the latest checkpoint the port's trainer "
                         "wrote under DIR (exit if there is none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode ticks per batcher step")
    ap.add_argument("--speculative", default="off",
                    choices=("off", "self-int8"),
                    help="speculative decoding: self-int8 drafts with the "
                         "target's own weights quantized to int8")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculation depth: draft tokens per verify round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grace", type=float, default=30.0,
                    help="termination grace period (s) for the SIGTERM "
                         "drain")
    ap.add_argument("--trace-log", default=None, metavar="PATH",
                    help="append one serve-step span record (a JSON "
                         "object per line) per batcher step to PATH")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    params, cfg = build_params(args)
    hub = MetricsHub()
    hub.set_gauge("build_info", 1.0, labels={"version": __version__,
                                             "model": args.model})
    tracer = Tracer(sink=JsonlSink(args.trace_log)) if args.trace_log \
        else None
    draft = "self-int8" if args.speculative == "self-int8" else None
    rt = ServingRuntime(params, cfg, args.max_slots, args.capacity,
                        args.block_size, args.chunk, hub=hub, tracer=tracer,
                        draft=draft, spec_k=args.spec_k)
    httpd = make_server(rt, args.host, args.port)

    def on_term(signum, frame):
        threading.Thread(target=drain_then_shutdown,
                         args=(rt, httpd, args.grace), daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    logger.info("torch-serve on :%d (%s, %s, %d slots, chunk %d, "
                "speculative %s)", httpd.server_address[1], args.model,
                args.device, args.max_slots, args.chunk, args.speculative)
    httpd.serve_forever()
    rt.stop()
    if tracer is not None:
        tracer.sink.close()
    logger.info("drained; exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
