"""The operator binary: the reconcile-loop driver over the port's libraries.

The port's twin of the JAX package's ``cmd/operator.py``, with the same
flags, the same config YAML and the same endpoint bodies; it imports
nothing of that package. Run it as a module (a top-level ``operator.py``
run by path would shadow the standard library's ``operator``)::

    python -m k8s_operator_libs_tpu_torch.operator --config operator.yaml \
        --kubeconfig ~/.kube/config [--watch] [--leader-elect] [--profile]

The reference ships no control loop — its consumers (GPU/Network Operator)
own Reconcile() and call BuildState/ApplyState per tick. This is that
consumer for GPU fleets: a deployable process that

1. loads a YAML config naming the managed driver components (the NVIDIA
   driver, the device plugin) and their DriverUpgradePolicySpec,
2. connects via the stdlib live client (kubeconfig or in-cluster
   serviceaccount — core/liveclient.py),
3. optionally bootstraps the shipped CRDs (the Helm-hook equivalent),
4. runs GPUOperator.reconcile() every --interval seconds with
   clique-atomic grouping, and
5. serves /metrics (Prometheus text) and /healthz on --metrics-port.

The metric families keep the reference's ``tpu_operator_*`` and
``tpu_market_*`` names, so dashboards read either binary.

Config YAML shape (keys follow the CRD camelCase convention):

    components:
      - name: gpu
        namespace: gpu-operator
        driverLabels: {app: nvidia-driver}
        policy:
          autoUpgrade: true
          maxParallelUpgrades: 1
          maxUnavailable: "25%"
          drain: {enable: true, force: true, timeoutSecond: 300}

SIGTERM/SIGINT finish the current tick, then exit 0 (upgrade progress lives
in node labels, so the next instance resumes mid-flight — reference
upgrade_state.go:68-72 semantics).
"""

import argparse
import json
import logging
import signal
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import __version__
from .api.v1alpha1 import DriverUpgradePolicySpec
from .gpu.operator import GPUOperator, ManagedComponent
from .health import metrics as health_metrics
from .health.monitor import HealthOptions
from .market.demand import build_market
from .obs.causes import causes_payload
from .obs.metrics import MetricsHub
from .obs.profile import TickProfiler, counting_client
from .obs.slo import SLOOptions
from .obs.trace import JsonlSink, Tracer
from .upgrade import metrics as metrics_mod
from .utils import threads
from .utils.clock import RealClock

logger = logging.getLogger("tpu-operator")

# the prefix of the operator's families (the port's hub renders under the
# serving workload's prefix unless told)
PREFIX = "tpu_operator"


def _read_config(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_components(path: str):
    cfg = _read_config(path)
    comps = []
    for c in cfg.get("components") or []:
        comps.append(ManagedComponent(
            name=c["name"],
            namespace=c.get("namespace", "kube-system"),
            driver_labels=dict(c.get("driverLabels") or {}),
            policy=DriverUpgradePolicySpec.from_dict(c.get("policy") or {}),
        ))
    if not comps:
        raise ValueError(f"{path}: no components defined")
    return comps


def load_health(path: str):
    """Optional top-level ``health:`` section → HealthOptions (None when
    absent or explicitly disabled — the health subsystem is opt-in)."""
    cfg = _read_config(path)
    section = cfg.get("health")
    if not section or section.get("enabled") is False:
        return None
    return HealthOptions.from_dict(section)


def load_slo(path: str):
    """Optional top-level ``slo:`` section → SLOOptions (None when absent
    or explicitly disabled — like health, the SLO engine is opt-in;
    ``slo: {}`` turns it on with the shipped default objectives)."""
    cfg = _read_config(path)
    if "slo" not in cfg:
        return None
    section = cfg.get("slo") or {}
    if section.get("enabled") is False:
        return None
    return SLOOptions.from_dict(section)


def load_resilience(path: str):
    """Optional top-level ``resilience:`` section → ResilienceOptions.
    ON BY DEFAULT — a long-running operator without a breaker turns a
    sustained apiserver outage into a retry storm; ``resilience:
    {enabled: false}`` opts out, any other shape tunes the knobs:

        resilience:
          retries: 3                    # idempotent-read retries
          retryBaseSeconds: 0.5         #   jittered exponential backoff
          breakerFailureThreshold: 8    # consecutive failures -> open
          breakerOpenSeconds: 30        # shed window before probing
    """
    from .core.resilience import ResilienceOptions
    cfg = _read_config(path)
    section = cfg.get("resilience")
    if section is not None and section.get("enabled") is False:
        return None
    return ResilienceOptions.from_dict(section or {})


def load_reconcile(path: str) -> dict:
    """Optional top-level ``reconcile:`` section — the scale knobs:

        reconcile:
          shardWorkers: 8          # per-slice-group workers (0 = serial)
          verifyIncremental: false # incremental-vs-rebuild oracle per tick

    Defaults keep the serial, oracle-off behavior."""
    cfg = _read_config(path)
    section = cfg.get("reconcile") or {}
    return {
        "shard_workers": int(section.get("shardWorkers", 0)),
        "verify_incremental": bool(section.get("verifyIncremental", False)),
    }


def load_usage(path: str):
    """Optional top-level ``usage:`` section (utilization and cost
    accounting). ON BY DEFAULT — the meter is O(nodes) integer
    bookkeeping per tick; ``usage: {enabled: false}`` opts out. The
    durable billing ledger needs an explicit path:

        usage:
          ledger: /var/lib/gpu-operator/usage.jsonl  # rotated JSONL
          goodputLedger: /ckpt/goodput.jsonl  # training goodput pricing
          maxWasteBuckets: 32

    Returns the raw dict ({} = defaults), or None when disabled."""
    cfg = _read_config(path)
    section = cfg.get("usage")
    if section is not None and section.get("enabled") is False:
        return None
    return section or {}


def build_usage(section, hub):
    """``usage:`` section → a wired UsageMeter (billing attached when a
    ledger path is configured)."""
    from .obs.usage import UsageMeter
    billing = None
    if section.get("ledger"):
        from .obs.billing import BillingEngine, UsageLedger
        from .serving.router import LANE_WEIGHTS
        billing = BillingEngine(
            UsageLedger(section["ledger"]),
            lane_weights=LANE_WEIGHTS,
            goodput_path=section.get("goodputLedger"))
    return UsageMeter(metrics=hub, billing=billing,
                      max_waste_buckets=int(
                          section.get("maxWasteBuckets", 32)))


def load_market(path: str):
    """Optional top-level ``market:`` section (the capacity market):

        market:
          routerUrl: http://router:8300       # lane-demand poll (/lanes)
          goodputLedger: /ckpt/goodput.jsonl  # marginal-goodput pricing
          slices:                             # tradeable training slices
            - id: pool-7
              nodes: [h100-7-0, h100-7-1]
          config: {preempt_rate: 2.0, sustain_ticks: 3}

    Returns the raw dict (the arbiter is built in main once the client
    and SLO engine exist), or None when absent/disabled."""
    cfg = _read_config(path)
    section = cfg.get("market")
    if not section or section.get("enabled") is False:
        return None
    if not section.get("slices"):
        raise ValueError(f"{path}: market: needs at least one slices "
                         f"entry (id + nodes)")
    return section


def build_client(args, components, resilience_opts=None):
    """The reference's two-client split (upgrade_state.go:127-135): a
    long-running operator reads through an informer cache (CachedClient)
    whose ``direct()`` is the raw LiveClient; ``--once`` ticks (Helm hooks,
    smoke tests) skip the informers — one tick can't amortize them. The
    Pod/DaemonSet informers are scoped to the component namespaces, never
    cluster-wide.

    The resilient boundary (retry / rate limit / circuit breaker) wraps
    the live client UNDER the informer cache, so list/watch traffic
    passes the breaker gate while store reads stay free; returns the
    ResilientClient handle (or None) so the operator can drive its
    fail-static degraded mode off the breaker."""
    from .core.cachedclient import CachedClient
    from .core.client import ClientEventRecorder
    from .core.liveclient import KubeConfig, KubeHTTP, LiveClient
    kc = (KubeConfig.in_cluster() if args.in_cluster else
          KubeConfig.from_kubeconfig(args.kubeconfig, args.context))
    http = KubeHTTP(kc)
    client = LiveClient(http)
    resilient = None
    if resilience_opts is not None:
        resilient = resilience_opts.build(client)
        client = resilient
    if not args.once and not args.uncached:
        client = CachedClient(
            client,
            namespaces=[c.namespace for c in components],
            watch_window_seconds=max(args.interval, 5.0))
        if not args.leader_elect:
            client.start()
        # with --leader-elect the informers start on first leadership win:
        # permanent standbys must not hold watch streams for caches nobody
        # reads (controller-runtime starts caches after winning, too)
    # events go through the injected client (ClientEventRecorder falls back
    # to direct() for the cached wrapper), so the same wiring records real
    # Events in production and assertable ones under the fake apiserver
    return client, ClientEventRecorder(client), resilient


class MetricsServer:
    """Serves /metrics (Prometheus text), /healthz, and — when the SLO
    engine is on — the /slo and /alerts JSON views the status dashboard
    reads. The handler reads a snapshot dict the reconcile loop
    refreshes after every tick, so ``status --slo`` and ``/alerts``
    always show the same numbers the gauges carry."""

    def __init__(self, port: int):
        self.snapshot = {"text": "", "healthy": False,
                         "slo": None, "alerts": None, "profile": None,
                         "market": None, "resilience": None,
                         "causes": None, "usage": None}
        snapshot = self.snapshot

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):
                pass

            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    body = snapshot["text"].encode()
                    ctype = "text/plain; version=0.0.4"
                    code = 200
                elif self.path == "/healthz":
                    body = b"ok" if snapshot["healthy"] else b"not ready"
                    ctype = "text/plain"
                    code = 200 if snapshot["healthy"] else 503
                elif self.path in ("/slo", "/alerts", "/profile",
                                   "/market", "/resilience", "/causes",
                                   "/usage"):
                    payload = snapshot[self.path[1:]]
                    if payload is None:
                        body = {
                            "/profile": b'{"error": "profiler disabled"}',
                            "/market":
                                b'{"error": "market arbiter disabled"}',
                            "/resilience":
                                b'{"error": "resilience disabled"}',
                            "/causes":
                                b'{"error": "no tick completed yet"}',
                            "/usage":
                                b'{"error": "usage accounting disabled"}',
                        }.get(self.path,
                              b'{"error": "slo engine disabled"}')
                        ctype, code = "application/json", 404
                    else:
                        body = payload.encode()
                        ctype, code = "application/json", 200
                else:
                    body, ctype, code = b"not found", "text/plain", 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threads.spawn("operator-metrics-server",
                                     self._server.serve_forever)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


def render_metrics(operator: GPUOperator, states, hub: MetricsHub) -> str:
    """Prometheus text from the states the tick just acted on — no second
    round of apiserver LISTs per scrape interval. Upgrade gauges for every
    component are grouped into one exposition block (HELP/TYPE once per
    metric family), followed by the fleet-health gauges when the health
    subsystem is on, then the obs families (duration histograms, stuck
    gauges, build/leader identity) from the hub."""
    per_component = {}
    for comp in operator.components:
        state = states.get(comp.name)
        if state is None:
            continue
        per_component[comp.name] = metrics_mod.collect(
            operator.managers[comp.name], state)
    text = metrics_mod.render_prometheus_multi(per_component)
    if operator.last_health is not None:
        text += health_metrics.render(operator.health_component,
                                      operator.last_health)
    text += hub.render(prefix=PREFIX)
    return text


def slo_payload(operator: GPUOperator) -> str:
    """The /slo JSON: every SLO status the engine computed this tick plus
    budget-history samples from the tsdb — the sparkline feed for
    ``status --slo --watch``. Envelope {"kind": ..., "data": ...} like
    every machine-readable status surface."""
    names = sorted(operator.last_slo)
    history = {}
    for name in names:
        samples = operator.tsdb.samples(
            "tpu_operator_slo_error_budget_remaining", {"slo": name})
        history[name] = [[t, v] for t, v in samples[-90:]]
    return json.dumps({"kind": "slo", "data": {
        "slos": [operator.last_slo[name] for name in names],
        "history": history}})


def alerts_payload(operator: GPUOperator) -> str:
    return json.dumps({"kind": "alerts",
                       "data": operator.alert_manager.status()})


def usage_payload(operator: GPUOperator, waste_top: int = 5) -> dict:
    """The /usage data body: the meter's conservation-checked account,
    with each top waste bucket joined to the fleet-timeline events
    overlapping its window — every large waste window arrives with its
    'why' attached (the fleet black box)."""
    data = operator.usage.payload(waste_top=waste_top)
    for bucket in data["waste"]:
        events = operator.timeline.events_overlapping(
            bucket["start"], bucket["end"])
        bucket["events"] = [
            {"t": ev.t, "kind": ev.kind, "entity": ev.entity,
             "detail": ev.detail}
            for ev in events[-5:]]
    return data


def main(argv=None, stop=None, on_ready=None, clock=None) -> int:
    """``stop`` (an Event), ``on_ready(metrics_server)`` and ``clock``
    (bounds the shutdown joins) are injection points for embedding and
    tests; production runs use signals and real time."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="operator config YAML (components + policies)")
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("--context", default=None)
    p.add_argument("--in-cluster", action="store_true")
    p.add_argument("--interval", type=float, default=30.0,
                   help="seconds between reconcile ticks")
    p.add_argument("--watch", action="store_true",
                   help="watch nodes and reconcile immediately on change "
                        "(controller-runtime style; --interval becomes the "
                        "resync fallback)")
    p.add_argument("--once", action="store_true",
                   help="run a single reconcile tick and exit")
    p.add_argument("--uncached", action="store_true",
                   help="read straight from the apiserver instead of the "
                        "informer cache (the cache is on by default for "
                        "long-running mode; --once is always uncached)")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="/metrics + /healthz port (0 = ephemeral, "
                        "-1 = disabled)")
    p.add_argument("--trace-log", default=None, metavar="PATH",
                   help="append reconcile span records (one JSON object "
                        "per line) to PATH — the Dapper-style tick trace "
                        "(docs/observability.md)")
    p.add_argument("--profile", action="store_true",
                   help="tick flight recorder: per-handler self-time "
                        "profiles with apiserver-call attribution "
                        "(CountingClient), served as the /profile "
                        "envelope (docs/observability.md)")
    p.add_argument("--ensure-crds", default=None, metavar="DIR",
                   help="apply CRDs from DIR before the first tick")
    p.add_argument("--leader-elect", action="store_true",
                   help="coordinate HA replicas through a "
                        "coordination.k8s.io Lease: only the holder "
                        "reconciles (client-go-style acquire/renew/CAS)")
    p.add_argument("--leader-elect-lease", default="tpu-operator",
                   metavar="NAME", help="Lease name (namespace = the first "
                                        "component's namespace)")
    p.add_argument("--leader-elect-identity", default=None,
                   help="candidate identity (default: hostname-pid)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    try:
        components = load_components(args.config)
        health = load_health(args.config)
        slo = load_slo(args.config)
        market_section = load_market(args.config)
        usage_section = load_usage(args.config)
        reconcile_opts = load_reconcile(args.config)
        resilience_opts = load_resilience(args.config)
        client, recorder, resilient = build_client(args, components,
                                                   resilience_opts)
    except Exception as exc:  # exc: allow — CLI startup: any config/build failure becomes exit 2 with its message
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.ensure_crds:
        from .core.liveclient import LiveCRDClient
        from .crdutil import crdutil
        n = crdutil.ensure_crds(LiveCRDClient(client.direct().http),
                                [args.ensure_crds])
        logger.info("bootstrapped %d CRDs", n)

    hub = MetricsHub()
    if resilient is not None:
        resilient.bind_metrics(hub)
        logger.info("resilient client boundary on (retries=%d, breaker "
                    "opens after %d failures, sheds for %.0fs before "
                    "probing)", resilience_opts.retries,
                    resilience_opts.failure_threshold,
                    resilience_opts.open_seconds)
    trace_sink = JsonlSink(args.trace_log) if args.trace_log else None
    profiler = TickProfiler(inner=trace_sink) if args.profile else None
    tracer = Tracer(sink=profiler or trace_sink) \
        if (profiler or trace_sink) else Tracer()
    if args.profile:
        # apiserver-call accounting at the client boundary: every call
        # the operator (and its elector) issues is counted per verb/kind
        # and attributed to the span that issued it
        client = counting_client(client, metrics=hub, tracer=tracer)
        logger.info("tick profiling on (apiserver-call accounting at the "
                    "client boundary)")
    # identity metrics: dashboards tell replicas and builds apart even
    # before the first reconcile (and on permanent standbys)
    hub.set_gauge("build_info", 1.0, labels={
        "version": __version__,
        "components": ",".join(c.name for c in components)})
    hub.set_gauge("leader", 0.0 if args.leader_elect else 1.0)
    usage_meter = (build_usage(usage_section, hub)
                   if usage_section is not None else None)
    operator = GPUOperator(client, components, recorder=recorder,
                           health=health, tracer=tracer, metrics=hub,
                           slo=slo,
                           shard_workers=reconcile_opts["shard_workers"],
                           verify_incremental=reconcile_opts[
                               "verify_incremental"],
                           resilience=resilient, usage=usage_meter)
    if usage_meter is not None and usage_meter.billing is not None:
        logger.info("usage billing ledger at %s",
                    usage_meter.billing.ledger.path)
    if reconcile_opts["shard_workers"] > 1:
        logger.info("sharded reconcile on (%d per-slice-group workers)",
                    reconcile_opts["shard_workers"])
    if health is not None:
        logger.info("fleet health monitoring on (repair component %s)",
                    operator.health_component)
    if slo is not None:
        logger.info("SLO engine on (%d objectives: %s)", len(slo.specs),
                    ", ".join(s.name for s in slo.specs))
    if args.trace_log:
        logger.info("tracing reconcile spans to %s", args.trace_log)
    stop = stop or threads.make_event("operator-stop")
    clock = clock or RealClock()
    arbiter = None
    market_hub = None
    if market_section is not None:
        market_hub = MetricsHub()
        arbiter = build_market(market_section, client,
                               operator.slo_engine, market_hub, recorder,
                               clock)
        logger.info("capacity market on (%d managed slices%s)",
                    len(arbiter.supply),
                    ", router " + market_section["routerUrl"]
                    if market_section.get("routerUrl") else "")
    elector = None
    cache_started = not args.leader_elect  # see build_client
    if args.leader_elect and args.once:
        logger.warning("--leader-elect is ignored with --once: a one-shot "
                       "tick cannot hold a lease; it may interleave with a "
                       "running HA leader")
    if args.leader_elect and not args.once:
        import os
        import socket
        from .core.leaderelection import LeaderElector
        identity = (args.leader_elect_identity
                    or f"{socket.gethostname()}-{os.getpid()}")
        elector = LeaderElector(client, args.leader_elect_lease,
                                components[0].namespace, identity)

        def on_lost():
            # client-go's OnStoppedLeading: an in-flight reconcile cannot
            # be aborted, so stop the process — the supervisor restarts it
            # as a standby and the new leader proceeds alone
            logger.error("leadership lost; stopping so the new leader "
                         "reconciles alone")
            stop.set()

        # renewal runs on its own thread so a reconcile longer than the
        # lease duration (e.g. a drain waiting out PDB retries) cannot let
        # the lease lapse mid-tick
        elector.run_background(stop, on_lost=on_lost)
        logger.info("leader election on (lease %s/%s, identity %s)",
                    components[0].namespace, args.leader_elect_lease,
                    identity)
    prev_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread — caller controls the injected stop event

    server = (MetricsServer(args.metrics_port)
              if args.metrics_port >= 0 else None)
    if on_ready is not None:
        on_ready(server)
    dirty = threads.make_event("operator-dirty")  # watch events request an early tick
    watch_threads = []  # joined on shutdown — daemon threads still drain

    def _is_driver_pod(obj) -> bool:
        labels = obj.metadata.labels or {}
        return any(all(labels.get(k) == v
                       for k, v in comp.driver_labels.items())
                   for comp in components)

    if args.watch and not args.once:
        if hasattr(client, "set_event_hook"):
            # Cached mode: the informers already watch everything the loop
            # cares about, so the tick trigger rides their post-apply hook —
            # no duplicate watch streams, and the woken tick is guaranteed
            # to read a cache that reflects the event. Unrelated workload
            # pods in the component namespaces don't tick the loop.
            def on_event(kind, _etype, obj):
                if kind in ("Node", "DaemonSet") or _is_driver_pod(obj):
                    dirty.set()
            client.set_event_hook(on_event)
        else:
            # Uncached mode: dedicated watch threads. Nodes drive admission/
            # cordon/uncordon; each component's DRIVER pods (scoped by
            # namespace + selector — never a cluster-wide pod watch, which
            # would tick on unrelated workload churn) drive the
            # driver-restart transitions.
            def watch_loop(source_name, watch_fn):
                while not stop.is_set():
                    try:
                        for _etype, _obj in watch_fn(
                                timeout_seconds=args.interval):
                            dirty.set()
                            if stop.is_set():
                                return
                    except Exception as exc:  # exc: allow — watch threads survive any transport failure and re-watch after backoff
                        logger.warning("%s watch dropped (%s); retrying",
                                       source_name, exc)
                        stop.wait(1.0)
            import functools
            sources = [("node", client.watch_nodes)]
            for comp in components:
                sources.append((
                    f"pod:{comp.name}",
                    functools.partial(client.watch_pods,
                                      namespace=comp.namespace,
                                      label_selector=comp.driver_labels)))
            for name, fn in sources:
                watch_threads.append(threads.spawn(
                    f"operator-watch-{name}", watch_loop, args=(name, fn)))
    logger.info("managing %s every %.0fs%s",
                [c.name for c in components], args.interval,
                f", metrics on :{server.port}" if server else "")
    ticks = 0
    last_ok = False
    try:
        while not stop.is_set():
            t0 = time.monotonic()
            if elector is not None and not elector.is_leader:
                # standby replica: stay healthy (probes must not restart a
                # hot spare) but do not reconcile. It still serves its
                # identity metrics — tpu_operator_leader 0 is how
                # dashboards tell a hot spare from the leader (both
                # replicas' /metrics used to be indistinguishable)
                hub.set_gauge("leader", 0.0)
                if arbiter is not None:
                    # a promoted standby must resume trades from the
                    # durable annotations, not this process's stale view
                    arbiter.standby()
                if server:
                    server.snapshot["text"] = hub.render(prefix=PREFIX)
                    server.snapshot["healthy"] = True
                stop.wait(min(args.interval, elector.retry_period))
                continue
            if not cache_started:
                # first leadership win: start the informers now (standbys
                # never held watch streams)
                if hasattr(client, "start"):
                    client.start()
                cache_started = True
            hub.set_gauge("leader", 1.0)
            states = operator.reconcile()
            ticks += 1
            last_ok = all(s is not None for s in states.values())
            if arbiter is not None and not operator.degraded:
                # the market trades under the leader only (standby
                # replicas resumed from the durable annotations above,
                # via the elector gate's `continue`) — and NEVER while
                # degraded: no new trades off a stale view (fail-static)
                try:
                    arbiter.tick()
                except Exception:  # exc: allow — tick isolation: a market failure must not stop reconcile; next tick retries
                    logger.exception("market arbiter tick failed; "
                                     "retrying next tick")
            if server:
                text = render_metrics(operator, states, hub)
                if market_hub is not None:
                    text += market_hub.render(prefix="tpu_market")
                server.snapshot["text"] = text
                # healthy = the last tick reconciled every component.
                # DEGRADED mode stays healthy: the apiserver is down,
                # not us — a kubelet restart would only churn a process
                # that is deliberately failing static (the /resilience
                # envelope and the degraded gauges carry the real state)
                server.snapshot["healthy"] = last_ok or operator.degraded
                if operator.slo_engine is not None:
                    server.snapshot["slo"] = slo_payload(operator)
                    server.snapshot["alerts"] = alerts_payload(operator)
                # the fleet black box is always on (like journey
                # annotations); without the SLO engine the reports list
                # is empty but the timeline still serves
                server.snapshot["causes"] = json.dumps(
                    {"kind": "causes",
                     "data": causes_payload(operator.cause_analyzer,
                                            operator.timeline)})
                if profiler is not None:
                    server.snapshot["profile"] = json.dumps(
                        {"kind": "profile", "data": profiler.payload()})
                if arbiter is not None:
                    server.snapshot["market"] = json.dumps(
                        {"kind": "market", "data": arbiter.payload()})
                if operator.usage is not None:
                    server.snapshot["usage"] = json.dumps(
                        {"kind": "usage",
                         "data": usage_payload(operator)})
                if resilient is not None:
                    server.snapshot["resilience"] = json.dumps(
                        {"kind": "resilience", "data": dict(
                            resilient.payload(),
                            degraded=operator.degraded,
                            staleness_s=round(
                                operator.staleness_seconds(), 1))})
            if args.once:
                break
            remaining = max(0.0, args.interval - (time.monotonic() - t0))
            if args.watch:
                # wake on the first watch event OR at the resync interval,
                # still honoring stop promptly; then coalesce the burst a
                # state transition causes
                deadline = time.monotonic() + remaining
                while (not stop.is_set() and not dirty.is_set()
                       and time.monotonic() < deadline):
                    dirty.wait(0.25)
                dirty.clear()
                stop.wait(0.05)
            else:
                stop.wait(remaining)
    finally:
        if elector is not None:
            # clean shutdown: release so the successor doesn't wait out the
            # full lease duration
            elector.release()
        if server:
            server.stop()
        if hasattr(client, "stop"):  # CachedClient informers
            client.stop()
        # shutdown hygiene: the uncached watch threads used to be
        # fire-and-forget daemons — join them under one bounded deadline
        # on the injected clock (a watch window ends within --interval,
        # so a clean exit arrives inside interval + slack; a wedged
        # socket is reported, never waited on forever)
        if watch_threads:
            deadline = clock.now() + args.interval + 5.0
            for t in watch_threads:
                t.join(timeout=max(0.0, deadline - clock.now()))
            stuck = [t.name for t in watch_threads if t.is_alive()]
            if stuck:
                logger.warning("watch threads still running at shutdown "
                               "deadline: %s", ", ".join(stuck))
        if trace_sink is not None:
            trace_sink.close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    logger.info("exiting after %d ticks", ticks)
    print(json.dumps({"ticks": ticks, "last_tick_ok": last_ok}))
    # a single-tick run (bootstrap/CI Job) must fail loudly if nothing
    # reconciled; the long-running loop reports through /healthz instead
    return 0 if (last_ok or not args.once) else 1


if __name__ == "__main__":
    sys.exit(main())
