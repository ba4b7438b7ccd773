"""HTTP inference server over the port's continuous batcher.

Port of ``cmd/serve.py`` (kept out of ``cmd/``: this package stands
alone). One background stepper thread owns the batcher; request handlers
only touch host state under the runtime's lock. ``--chunk N`` runs N
decode ticks per ``step`` to amortize the readback.

HTTP surface (stdlib ``ThreadingHTTPServer``, JSON):

- ``POST /generate`` ``{"tokens": [int...], "max_new": N}`` -> blocks until
  the request completes: ``{"tokens": [prompt + generated]}``; 503 once
  draining, 422 when the request exceeds the slot capacity.
- ``POST /drain`` -> stop admission and return ``{"handoff": [[rid,
  [tokens...], max_new], ...]}``, the queue a peer replica takes over.
  In-flight requests still finish.
- ``GET /healthz`` -> 200 ``{"status": "ok"}``, or 503 once draining or
  failed.
- ``GET /metrics`` -> Prometheus text under the ``tpu_workload`` prefix.

Run: ``python -m k8s_operator_libs_tpu_torch.server --model tiny --device
cuda --port 8200``. Weights are seeded random. SIGTERM drains, waits for
in-flight requests up to ``--grace`` seconds, and exits.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import __version__
from .models.llama import LlamaConfig, init_params
from .models.serve import ContinuousBatcher
from .obs.metrics import MetricsHub, render_gauges
from .utils.clock import RealClock

logger = logging.getLogger("torch-serve")

MODELS = {"tiny": LlamaConfig.tiny, "small": LlamaConfig.small}


class ServingRuntime:
    """Batcher + stepper thread + completion events."""

    def __init__(self, params, cfg, max_slots, capacity, block_size, chunk,
                 hub=None):
        self.hub = hub if hub is not None else MetricsHub()
        self.srv = ContinuousBatcher(params, cfg, max_slots=max_slots,
                                     capacity_per_slot=capacity,
                                     block_size=block_size, metrics=self.hub)
        self.chunk = chunk
        self.lock = threading.Lock()
        self.results = {}
        self.events = {}
        self.draining = False
        self.failed = False
        self.handoff = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, name="serve-stepper",
                                       daemon=True)
        self.thread.start()

    def submit(self, tokens, max_new):
        """(rid, completion event), or None while draining/failed."""
        with self.lock:
            if self.draining or self.failed:
                return None
            rid = self.srv.submit(np.asarray(tokens, np.int32), max_new)
            ev = self.events[rid] = threading.Event()
        return rid, ev

    def result(self, rid):
        with self.lock:
            return self.results.pop(rid, None)

    def drain(self):
        """Stop admission; return the untouched queue for a peer. The
        stepper keeps running until in-flight requests finish."""
        with self.lock:
            if self.handoff is None:
                self.draining = True
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

    def _loop(self):
        while not self._stop.is_set():
            try:
                with self.lock:
                    busy = not self.srv.idle
                    if busy:
                        self.srv.step(self.chunk)
                        for rid, toks in self.srv.poll().items():
                            self.results[rid] = [int(t) for t in toks]
                            ev = self.events.pop(rid, None)
                            if ev:
                                ev.set()
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

    def do_GET(self):
        rt = self.server.rt
        if self.path == "/healthz":
            if rt.failed:
                self._json(503, {"status": "failed"})
            elif rt.draining:
                self._json(503, {"status": "draining"})
            else:
                self._json(200, {"status": "ok"})
        elif self.path == "/metrics":
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
        if self.path != "/generate":
            self._json(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            tokens = [int(t) for t in req["tokens"]]
            max_new = int(req.get("max_new", 32))
        except (ValueError, KeyError, TypeError) as exc:
            self._json(400, {"error": f"bad request: {exc}"})
            return
        try:
            sub = rt.submit(tokens, max_new)
        except (ValueError, TypeError) as exc:   # over capacity etc.
            self._json(422, {"error": str(exc)})
            return
        if sub is None:
            self._json(503, {"error": "draining or failed; submit to a "
                                      "peer"})
            return
        rid, ev = sub
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=sorted(MODELS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode ticks per batcher step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grace", type=float, default=30.0,
                    help="termination grace period (s) for the SIGTERM "
                         "drain")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = MODELS[args.model]()
    params = init_params(cfg, seed=args.seed, device=args.device)
    hub = MetricsHub()
    hub.set_gauge("build_info", 1.0, labels={"version": __version__,
                                             "model": args.model})
    rt = ServingRuntime(params, cfg, args.max_slots, args.capacity,
                        args.block_size, args.chunk, hub=hub)
    httpd = make_server(rt, args.host, args.port)

    def on_term(signum, frame):
        threading.Thread(target=drain_then_shutdown,
                         args=(rt, httpd, args.grace), daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    logger.info("torch-serve on :%d (%s, %s, %d slots, chunk %d)",
                httpd.server_address[1], args.model, args.device,
                args.max_slots, args.chunk)
    httpd.serve_forever()
    rt.stop()
    logger.info("drained; exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
