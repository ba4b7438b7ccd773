"""GPU operator status: day-2 visibility into a rolling driver upgrade.

The port's twin of the JAX package's ``cmd/status.py``, with its flags,
exit codes and ``--json`` envelopes. Prints one row per managed node —
upgrade state label, schedulability, upgrade group (the node's NVLink
clique, ``clique/<id>``, or the node itself when it is in none, as
``gpu/topology.py:GPUNodeGrouper`` groups it), health, driver-pod
revision vs the DaemonSet's — plus a summary line per component,
straight from the cluster (the same reads the state machine makes; no
controller required to be running).

    python -m k8s_operator_libs_tpu_torch.status --kubeconfig kc.yaml \
        --component gpu --namespace gpu-operator \
        --selector app=nvidia-driver-daemonset

``--timeline <node>`` instead renders the node's full upgrade JOURNEY —
every state it moved through with entered-at timestamps and per-phase
durations, read from the durable journey annotation the state machine
maintains:

    python -m k8s_operator_libs_tpu_torch.status --component gpu \
        --timeline gpu-t

``--goodput <ledger>`` renders the WORKLOAD side: the goodput/badput
decomposition of a training job's goodput.jsonl ledger (written next to
its checkpoints by the trainer, ``python -m
k8s_operator_libs_tpu_torch.train``), and — with ``--goodput-node`` — joins
each cross-restart unavailability window against that node's journey,
splitting it into the named operator phases (window_to_gate /
window_gate_to_restart / window_after_restart) plus the workload's own
drain-save / restore / re-warmup badput:

    python -m k8s_operator_libs_tpu_torch.status --component gpu \
        --goodput /ckpt/run1/goodput.jsonl --goodput-node gpu-t

``--slo`` / ``--alerts`` render the SLO ENGINE's view (error budgets,
burn rates, alert states) fetched from a running operator's ``/slo`` and
``/alerts`` endpoints (``--operator-url``) — the exact numbers the
gauges carry, no cluster access needed. ``--watch`` turns it into a
live-refresh fleet dashboard with budget-history sparklines from the
operator's in-process tsdb:

    python -m k8s_operator_libs_tpu_torch.status --slo \
        --operator-url http://operator:8080 --watch

``--replicas`` renders the SERVING ROUTER's replica registry fetched
from a running router binary's (``router.py``) ``/replicas`` endpoint
(``--router-url``): one row per replica — node, admission state, drain
reason, scraped queue depth and slot usage — plus the autoscaler's last
decision:

    python -m k8s_operator_libs_tpu_torch.status --replicas \
        --router-url http://router:8300

``--profile`` renders the TICK FLIGHT RECORDER's view fetched from a
running operator's ``/profile`` endpoint (operator started with
``--profile``): the last reconcile tick decomposed into per-handler
self-times plus attributed apiserver calls, its critical path, and the
ring aggregate:

    python -m k8s_operator_libs_tpu_torch.status --profile \
        --operator-url http://operator:8080

``--market`` renders the CAPACITY ARBITER's view fetched from a running
operator's ``/market`` endpoint (operator config with a ``market:``
section): current lane queue depths, the slice ownership table, and the
last N arbiter decisions with their burn-vs-goodput rationale:

    python -m k8s_operator_libs_tpu_torch.status --market \
        --operator-url http://operator:8080

``--incident <alert-or-rule>`` renders the ROOT-CAUSE ENGINE's newest
CauseReport for that alert rule (or SLO name) fetched from the
operator's ``/causes`` endpoint: the ranked candidate causes (score =
burn-window overlap × entity-distance decay × kind prior) with the raw
fleet-timeline evidence behind the leading cause:

    python -m k8s_operator_libs_tpu_torch.status \
        --incident serving-ttft-p99 \
        --operator-url http://operator:8080

The ``--watch`` dashboard additionally shows the top firing alert's
leading cause as a one-line banner (next to the DEGRADED banner), e.g.
``PAGE serving-ttft-p99 ← health-verdict node/gpu-7 (crashloop)``.

``--json`` always emits one ``{"kind": <view>, "data": ...}`` envelope
(kinds: ``timeline``, ``goodput``, ``slo``, ``alerts``, ``replicas``,
``profile``, ``market``; ``--incident`` emits the operator's
``causes`` envelope verbatim).

Exit code: 0 when every managed node is upgrade-done (or unmanaged), 3
while an upgrade is in flight, 4 if any node is upgrade-failed — so CI
gates and scripts can wait on it. ``--timeline``, ``--goodput``,
``--slo``, ``--alerts``, ``--replicas``, ``--profile``, ``--market``,
and ``--incident`` always exit 0 (except 2 when the endpoint is
unreachable).
"""

import argparse
import datetime
import json
import sys
import time

from .gpu.topology import GPUNodeGrouper
from .health import consts as health_consts
from .obs.attribution import attribute_downtime
from .obs.goodput import read_ledger, summarize
from .obs.journey import parse_journey, parse_journey_full
from .upgrade.consts import UpgradeState
from .upgrade.util import KeyFactory, parse_selector

IN_FLIGHT_RC = 3
FAILED_RC = 4


def build_client(args):
    from .core.liveclient import KubeConfig, KubeHTTP, LiveClient
    kc = (KubeConfig.in_cluster() if args.in_cluster else
          KubeConfig.from_kubeconfig(args.kubeconfig, args.context))
    return LiveClient(KubeHTTP(kc))


def collect_status(client, component: str, namespace: str, selector):
    """Join driver pods with their nodes, like BuildState does."""
    from .core.client import NotFoundError
    from .upgrade.pod_manager import daemonset_revision_hash

    keys = KeyFactory(component)
    daemonsets = {d.metadata.uid: d for d in client.list_daemonsets(
        namespace=namespace, label_selector=selector)}
    revisions = client.list_controller_revisions(namespace=namespace)
    ds_hash = {}
    for ds in daemonsets.values():
        try:
            ds_hash[ds.metadata.uid] = daemonset_revision_hash(
                client, ds, revisions=revisions)
        except (ValueError, KeyError):
            pass  # no revisions / unlabeled revision — rendered as "?"
    rows = []
    for pod in client.list_pods(namespace=namespace, label_selector=selector):
        if not pod.spec.node_name:
            continue
        try:
            node = client.get_node(pod.spec.node_name)
        except NotFoundError:
            # node deleted mid-scale-down while its driver pod terminates;
            # report rather than crash (exit codes must stay 0/3/4)
            print(f"warning: pod {pod.metadata.name} references missing "
                  f"node {pod.spec.node_name}; skipping", file=sys.stderr)
            continue
        owner = pod.metadata.owner_references[0].uid \
            if pod.metadata.owner_references else None
        group = GPUNodeGrouper().group_key(node)
        pod_rev = pod.metadata.labels.get("controller-revision-hash", "?")
        want_rev = ds_hash.get(owner, "?") if owner else "(orphan)"
        # health column degrades gracefully: "-" when the health subsystem
        # never ran (no labels) or the node is simply healthy (labels
        # removed); a quarantined node shows "<verdict>/Q"
        quarantine = node.metadata.labels.get(health_consts.QUARANTINE_LABEL)
        verdict = node.metadata.labels.get(health_consts.VERDICT_LABEL)
        health = f"{quarantine}/Q" if quarantine else (verdict or "-")
        rows.append({
            "node": node.metadata.name,
            "state": node.metadata.labels.get(keys.state_label, "") or "unknown",
            "schedulable": not node.spec.unschedulable,
            "group": group,
            "health": health,
            "quarantined": quarantine is not None,
            "pod_revision": pod_rev,
            "target_revision": want_rev,
            "in_sync": pod_rev == want_rev,
        })
    return sorted(rows, key=lambda r: r["node"])


def render_table(component: str, rows) -> str:
    headers = ("NODE", "STATE", "SCHED", "GROUP", "HEALTH", "REVISION")
    table = [(r["node"], r["state"], "yes" if r["schedulable"] else "no",
              r["group"], r["health"],
              r["pod_revision"] + ("" if r["in_sync"]
                                   else f" -> {r['target_revision']}"))
             for r in rows]
    widths = [max(len(h), *(len(t[i]) for t in table)) if table else len(h)
              for i, h in enumerate(headers)]
    lines = [f"component: {component}"]
    lines.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    done = sum(1 for r in rows if r["state"] == UpgradeState.DONE)
    failed = sum(1 for r in rows if r["state"] == UpgradeState.FAILED)
    in_flight = sum(1 for r in rows if r["state"] not in
                    ("unknown", UpgradeState.DONE, UpgradeState.FAILED))
    quarantined = sum(1 for r in rows if r["quarantined"])
    lines.append(f"{len(rows)} nodes: {done} done, {in_flight} in flight, "
                 f"{failed} failed, {quarantined} quarantined")
    return "\n".join(lines)


def collect_timeline(client, component: str, node_name: str, now=None):
    """The node's journey for one component, as duration-annotated rows
    plus the count of size-guard-truncated older entries. ``now`` closes
    the open-ended last phase (defaults to wall clock; injectable for
    deterministic tests)."""
    now = time.time() if now is None else now
    keys = KeyFactory(component)
    node = client.get_node(node_name)
    entries, truncated = parse_journey_full(
        node.metadata.annotations.get(keys.journey_annotation))
    rows = []
    for i, (state, entered) in enumerate(entries):
        ongoing = i + 1 >= len(entries)
        end = now if ongoing else entries[i + 1][1]
        rows.append({
            "state": state or "unknown",
            "entered": entered,
            "duration_s": max(0.0, end - entered),
            "ongoing": ongoing,
        })
    stuck = node.metadata.annotations.get(keys.stuck_reported_annotation)
    return rows, stuck, truncated


def collect_goodput(ledger_path: str, client=None, components=(),
                    node_name=None, now=None):
    """Ledger summary plus (when a node is named) the per-component
    attribution of every cross-restart unavailability window against
    that node's journey."""
    now = time.time() if now is None else now
    records = read_ledger(ledger_path)
    summary = summarize(records)
    attributions = {}
    if node_name and client is not None:
        node = client.get_node(node_name)
        for comp in components:
            keys = KeyFactory(comp)
            entries = parse_journey(
                node.metadata.annotations.get(keys.journey_annotation))
            attributions[comp] = attribute_downtime(records, entries,
                                                    now=now)
    return summary, attributions


def render_goodput(ledger_path: str, summary, attributions,
                   node_name=None) -> str:
    lines = [f"goodput ledger: {ledger_path}  ({summary['runs']} run(s), "
             f"{summary['steps']} steps)"]
    frac = summary["goodput_fraction"]
    tps = summary["tokens_per_s"]
    lines.append(
        f"goodput {_fmt_duration(summary['goodput_s'])}"
        + (f" ({frac:.1%} of accounted time)" if frac is not None else "")
        + (f"  tokens/s {tps:.1f}" if tps else "")
        + (f"  mfu {summary['mfu']:.3f}" if summary["mfu"] else ""))
    badput = summary["badput_s"]
    if any(v for v in badput.values()):
        lines.append("badput: " + "  ".join(
            f"{name} {_fmt_duration(secs)}"
            for name, secs in badput.items() if secs))
    for comp, reports in attributions.items():
        for i, rep in enumerate(reports):
            lines.append(f"unavailability window #{i + 1} "
                         f"({_fmt_duration(rep['total_s'])}, component "
                         f"{comp}, node {node_name}):")
            lines.append("  " + "  ".join(
                f"{name} {_fmt_duration(secs)}"
                for name, secs in sorted(rep["phases"].items(),
                                         key=lambda kv: -kv[1])))
        if not reports:
            lines.append(f"component {comp}: no unavailability window in "
                         f"the ledger (no preempted run)")
    if not attributions and summary["unavailability_windows"]:
        lines.append(f"{len(summary['unavailability_windows'])} "
                     "unavailability window(s) — pass --goodput-node to "
                     "attribute them against a node's journey")
    return "\n".join(lines)


def _fmt_duration(seconds: float) -> str:
    if seconds >= 3600:
        return f"{seconds / 3600:.1f}h"
    if seconds >= 60:
        return f"{seconds / 60:.1f}m"
    return f"{seconds:.1f}s"


# ------------------------------------------------- SLO / alert dashboard


SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 24, lo: float = 0.0,
              hi: float = 1.0) -> str:
    """Unicode sparkline over a FIXED [lo, hi] scale (budget history must
    compare across refreshes, so no per-frame autoscaling)."""
    out = []
    span = hi - lo
    for v in values[-width:]:
        frac = 0.0 if span <= 0 else (v - lo) / span
        frac = min(1.0, max(0.0, frac))
        out.append(SPARK_CHARS[round(frac * (len(SPARK_CHARS) - 1))])
    return "".join(out)


def fetch_view(operator_url: str, path: str):
    """GET the operator's /slo or /alerts JSON envelope."""
    import urllib.request
    url = operator_url.rstrip("/") + path
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read().decode())


def _fmt_rate(rate) -> str:
    return "-" if rate is None else f"{rate:.1f}x"


def render_slo(data) -> str:
    """One row per SLO: budget remaining, fastest burn pair, breach
    state, and the budget-history sparkline (fixed 0..1 scale)."""
    slos = data.get("slos") or []
    history = data.get("history") or {}
    if not slos:
        return "no SLOs evaluated yet (engine warming up?)"
    headers = ("SLO", "TARGET", "WINDOW", "BUDGET", "BURN", "STATE",
               "HISTORY")
    table = []
    for s in slos:
        burn = s.get("burn") or []
        fastest = burn[0] if burn else {}
        hot = next((b for b in burn if b.get("triggered")), None)
        shown = hot or fastest
        burn_txt = "-"
        if shown:
            burn_txt = (f"{_fmt_rate(shown.get('long_rate'))}/"
                        f"{shown['long']}")
        if s.get("no_data"):
            state = "no-data"
        elif s.get("breach"):
            state = s["breach"].upper()
        else:
            state = "ok"
        spark = sparkline([v for _, v in history.get(s["name"], [])])
        table.append((s["name"], f"{s['target']:.2%}", s["window"],
                      f"{s['error_budget_remaining']:.1%}", burn_txt,
                      state, spark))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    breaches = [s["name"] for s in slos if s.get("breach")]
    lines.append(f"{len(slos)} SLOs, "
                 f"{len(breaches)} burning ({', '.join(breaches) or '-'})")
    return "\n".join(lines)


def render_alerts(data) -> str:
    """One row per alert rule, firing first (the server pre-sorts)."""
    if not data:
        return "no alert rules evaluated yet"
    headers = ("RULE", "SEVERITY", "STATE", "SINCE", "MESSAGE")
    table = []
    for a in data:
        since = a.get("firing_since") or a.get("pending_since")
        since_txt = "-"
        if since:
            since_txt = datetime.datetime.fromtimestamp(
                since, tz=datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%S")
        table.append((a["rule"], a["severity"], a["state"], since_txt,
                      (a.get("message") or "-")[:60]))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    firing = sum(1 for a in data if a["state"] == "firing")
    pending = sum(1 for a in data if a["state"] == "pending")
    lines.append(f"{len(data)} rules: {firing} firing, {pending} pending")
    return "\n".join(lines)


def degraded_banner(operator_url: str, fetch=fetch_view):
    """The fail-static banner: one loud line when
    the operator reports DEGRADED over its /resilience envelope; None
    when healthy, unreachable, or resilience is off — every status view
    prepends it best-effort, never fails on it."""
    try:
        data = fetch(operator_url, "/resilience").get("data") or {}
    except Exception:  # exc: allow — the banner is best-effort; unreachable just means no banner
        return None
    if not data.get("degraded"):
        return None
    return (f"*** DEGRADED (fail-static): apiserver unreachable — "
            f"breaker {data.get('breaker', '?')}, reads "
            f"{data.get('staleness_s', 0):g}s stale, state-advancing "
            f"writes suspended, health verdicts masked, serving tier "
            f"unaffected ***")


def render_resilience(data) -> str:
    lines = [
        "resilient client boundary",
        f"  breaker:            {data.get('breaker', '?')}"
        + ("  [DEGRADED: fail-static]" if data.get("degraded") else ""),
        f"  breaker opened:     {data.get('breaker_opened_total', 0)}x "
        f"since start",
        f"  stale reads age:    {data.get('staleness_s', 0):g}s",
        f"  reads retried:      {data.get('retried_total', 0)}",
        f"  calls shed:         {data.get('shed_total', 0)}",
        f"  429 rate-limited:   {data.get('rate_limited_total', 0)}",
    ]
    return "\n".join(lines)


def run_resilience_view(args, fetch=fetch_view) -> int:
    try:
        env = fetch(args.operator_url, "/resilience")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.operator_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_resilience(env.get("data") or {}))
    return 0


def cause_banner(alerts_data, operator_url: str, fetch=fetch_view):
    """The root-cause banner: one line naming the top firing alert's
    leading cause from the operator's /causes report ring (the server
    pre-sorts alerts firing-first, so the first firing row IS the top
    one). Best-effort exactly like degraded_banner — unreachable
    endpoint, no report, or an empty cause list just means no banner."""
    firing = [a for a in alerts_data or [] if a.get("state") == "firing"]
    if not firing:
        return None
    rule = firing[0].get("rule")
    try:
        data = fetch(operator_url, "/causes").get("data") or {}
    except Exception:  # exc: allow — the banner is best-effort; unreachable just means no banner
        return None
    for report in reversed(data.get("reports") or []):
        if report.get("rule") != rule:
            continue
        causes = report.get("causes") or []
        if not causes:
            return None
        top = causes[0]
        return (f"{(report.get('severity') or 'page').upper()} "
                f"{report.get('slo') or rule} ← {top['kind']} "
                f"{top['entity']} ({(top.get('detail') or '-')[:60]})")
    return None


def efficiency_banner(operator_url: str, fetch=fetch_view):
    """The fleet-ledger banner: one line with the productive fraction,
    the goodput headline, and the top waste kinds from the operator's
    /usage envelope. Best-effort like every banner — unreachable
    endpoint or no attributed tick yet means no banner."""
    try:
        data = fetch(operator_url, "/usage").get("data") or {}
    except Exception:  # exc: allow — the banner is best-effort; unreachable just means no banner
        return None
    if not data.get("ticks") or not data.get("capacity_s"):
        return None
    kinds = data.get("kinds") or {}
    waste = sorted(((k, s) for k, s in kinds.items()
                    if k not in ("serving", "training") and s > 0),
                   key=lambda kv: -kv[1])
    top = ", ".join(f"{k} {_fmt_duration(s)}" for k, s in waste[:2])
    line = f"efficiency {data.get('efficiency', 0):.1%} productive"
    billing = data.get("billing") or {}
    if billing.get("fleet_goodput_fraction") is not None:
        line += (f", fleet goodput "
                 f"{billing['fleet_goodput_fraction']:.1%}")
    return line + (f" — top waste: {top}" if top else "")


def banner_lines(operator_url: str, fetch=fetch_view, alerts_data=None,
                 stale_line=None):
    """Every dashboard banner, composed in ONE place with a fixed
    precedence order (highest first — a render test pins it):

        DEGRADED > STALE > leading cause > efficiency

    Each banner stays best-effort and independent: one failing fetch
    drops that line only. ``stale_line`` is passed pre-rendered by the
    watch loop (only it knows the last good fetch time)."""
    lines = []
    degraded = degraded_banner(operator_url, fetch=fetch)
    if degraded:
        lines.append(degraded)
    if stale_line:
        lines.append(stale_line)
    cause = cause_banner(alerts_data, operator_url, fetch=fetch)
    if cause:
        lines.append(cause)
    efficiency = efficiency_banner(operator_url, fetch=fetch)
    if efficiency:
        lines.append(efficiency)
    return lines


def render_dashboard(slo_data, alerts_data, operator_url: str,
                     fetch=fetch_view, stale_line=None) -> str:
    stamp = datetime.datetime.now(tz=datetime.timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S UTC")
    return "\n".join(
        banner_lines(operator_url, fetch=fetch, alerts_data=alerts_data,
                     stale_line=stale_line)
        + [
            f"tpu-operator fleet SLOs  ({operator_url}, {stamp})",
            "",
            render_slo(slo_data),
            "",
            render_alerts(alerts_data),
        ])


def run_slo_view(args, fetch=fetch_view, sleep=time.sleep, now=None) -> int:
    """--slo / --alerts (one-shot or --watch live dashboard). Data comes
    from the operator's HTTP endpoints so this view, the gauges, and the
    Events all agree.

    ``--watch`` survives transient metrics-endpoint failures: a fetch
    error keeps the last good frame on screen under a "STALE since <t>"
    banner and retries on the normal interval — a dashboard must outlive
    the operator's rolling restart, not traceback-exit in the middle of
    the incident it is being watched for. One-shot mode still exits 2
    (scripts need the error). ``fetch``/``sleep``/``now`` are injectable
    for tests."""
    now = now or time.time
    iterations = 0
    last_slo_env = None
    last_alerts_env = None
    stale_since = None
    while True:
        fetch_error = None
        try:
            slo_env = (fetch(args.operator_url, "/slo")
                       if (args.slo or args.watch) else None)
            alerts_env = (fetch(args.operator_url, "/alerts")
                          if (args.alerts or args.watch) else None)
        except Exception as exc:  # exc: allow — watch mode renders the error inline; one-shot exits 2
            if not args.watch:
                print(f"error: cannot read {args.operator_url}: {exc}",
                      file=sys.stderr)
                return 2
            # watch mode: keep the last good frame, banner the staleness
            fetch_error = exc
            if stale_since is None:
                stale_since = now()
            slo_env, alerts_env = last_slo_env, last_alerts_env
        else:
            stale_since = None
            last_slo_env, last_alerts_env = slo_env, alerts_env
        if args.watch:
            stale_line = None
            if fetch_error is not None:
                stamp = datetime.datetime.fromtimestamp(
                    stale_since, tz=datetime.timezone.utc).strftime(
                    "%Y-%m-%d %H:%M:%S UTC")
                stale_line = (f"STALE since {stamp} — cannot read "
                              f"{args.operator_url}: {fetch_error} "
                              f"(retrying every {args.watch_interval:g}s)")
            # banner_lines() owns the precedence: DEGRADED > STALE >
            # cause > efficiency — the STALE text rides through it
            body = render_dashboard(
                (slo_env or {}).get("data") or {},
                (alerts_env or {}).get("data") or [], args.operator_url,
                fetch=fetch, stale_line=stale_line)
            # ANSI clear + home: repaint in place like `watch(1)`
            print("\x1b[2J\x1b[H" + body, flush=True)
        elif args.as_json:
            # the server already speaks the {"kind", "data"} envelope;
            # emit it verbatim so /slo and --slo can never disagree
            for env in (slo_env, alerts_env):
                if env is not None:
                    print(json.dumps(env, indent=2))
        else:
            if slo_env is not None:
                print(render_slo(slo_env["data"]))
            if alerts_env is not None:
                if slo_env is not None:
                    print()
                print(render_alerts(alerts_env["data"]))
        iterations += 1
        if not args.watch or (args.watch_count
                              and iterations >= args.watch_count):
            return 0
        sleep(args.watch_interval)


# ------------------------------------------------------ profile dashboard


def _fmt_ms(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    return f"{seconds * 1000:.1f}ms"


def render_profile(data) -> str:
    """The tick flight recorder's view: the last profiled tick's
    decomposition (self time + attributed apiserver time per handler),
    its critical path, and the ring aggregate."""
    last = data.get("last") or []
    if not last:
        return ("no ticks profiled yet (operator warming up, or running "
                "without --profile?)")
    tick = last[-1]
    lines = [f"{data.get('ticks_profiled', len(last))} ticks profiled "
             f"(ring keeps {data.get('ring_capacity', '?')})",
             "",
             f"last tick (trace {tick['trace']}): "
             f"{_fmt_ms(tick['duration_s'])} = "
             f"self {_fmt_ms(tick['self_total_s'])} + "
             f"apiserver {_fmt_ms(tick['api_total_s'])} "
             f"({tick['api_call_count']} calls)"]
    path = " -> ".join(
        f"{hop['name']}"
        + (f"[{hop['component']}]" if hop["component"] else "")
        + f" {_fmt_ms(hop['duration_s'])}"
        for hop in tick.get("critical_path") or [])
    lines.append(f"critical path: {path}")
    lines.append("")
    headers = ("COMPONENT", "HANDLER", "STATE", "SELF", "API", "CALLS",
               "%TICK")
    total = tick["duration_s"] or 1.0
    table = []
    for e in tick["entries"]:
        spent = e["self_s"] + e["api_s"]
        calls = sum(e["api_calls"].values())
        table.append((e["component"] or "-", e["handler"],
                      e["state"] or "-", _fmt_ms(e["self_s"]),
                      _fmt_ms(e["api_s"]), str(calls),
                      f"{spent / total:.0%}"))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    agg = data.get("aggregate") or {}
    calls = agg.get("api_calls") or {}
    if agg.get("ticks"):
        lines.append("")
        lines.append(
            f"ring aggregate over {agg['ticks']} tick(s): "
            f"{_fmt_ms(agg['duration_s'])} total "
            f"(apiserver {_fmt_ms(agg['api_total_s'])}); calls: "
            + (", ".join(f"{name} x{n}" for name, n in
                         sorted(calls.items(), key=lambda kv: -kv[1])[:8])
               or "-"))
    return "\n".join(lines)


def run_profile_view(args, fetch=fetch_view) -> int:
    """--profile: fetch the operator's /profile envelope and render the
    last tick's decomposition + critical path (exit 2 when the endpoint
    is unreachable, like the other HTTP views)."""
    try:
        env = fetch(args.operator_url, "/profile")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.operator_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_profile(env.get("data") or {}))
    return 0


def render_market(data) -> str:
    """The capacity arbiter's view: exchange rate, per-lane queue
    depths, the slice ownership table, and the last N decisions with
    their burn-vs-goodput rationale ."""
    lines = [f"exchange rate {data.get('rate', 0)} (serving pressure "
             f"{data.get('pressure', 0):.2f} / training value "
             f"{data.get('value', 0):.2f})  "
             f"trades {data.get('trades', 0)}  "
             f"returns {data.get('returns', 0)}"]
    lanes = data.get("lanes")
    if lanes:
        headers = ("LANE", "QUEUED", "SHED", "COMPLETED")
        table = [(lane, str(s.get("queued", 0)), str(s.get("shed", 0)),
                  str(s.get("completed", 0)))
                 for lane, s in lanes.items()]
        widths = [max(len(h), *(len(t[i]) for t in table))
                  for i, h in enumerate(headers)]
        lines.append("")
        lines.append("  ".join(h.ljust(w)
                               for h, w in zip(headers, widths)))
        for t in table:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(t, widths)))
    else:
        lines.append("(no lane demand wired — router unreachable or "
                     "market running on SLO burn alone)")
    ownership = data.get("ownership") or []
    if ownership:
        headers = ("SLICE", "OWNER", "PHASE", "NODES", "DECISION")
        table = [(o["slice"], o["owner"], o.get("phase", "-"),
                  ",".join(o.get("nodes") or []),
                  f"#{o.get('decision_id', 0)}"
                  + ("*" if o.get("stamp_pending") else ""))
                 for o in ownership]
        widths = [max(len(h), *(len(t[i]) for t in table))
                  for i, h in enumerate(headers)]
        lines.append("")
        lines.append("  ".join(h.ljust(w)
                               for h, w in zip(headers, widths)))
        for t in table:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(t, widths)))
        if any(o.get("stamp_pending") for o in ownership):
            lines.append("(* durable stamp pending — retrying)")
    decisions = data.get("decisions") or []
    if decisions:
        lines.append("")
        lines.append(f"last {len(decisions)} decision(s):")
        for d in decisions:
            stamp = datetime.datetime.fromtimestamp(
                d.get("t", 0), tz=datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%S")
            lines.append(f"  #{d.get('id')} {stamp} {d.get('action')} "
                         f"{d.get('slice')} rate={d.get('rate')} — "
                         f"{d.get('reason')}")
    else:
        lines.append("")
        lines.append("no decisions yet (the market holds)")
    return "\n".join(lines)


def run_market_view(args, fetch=fetch_view) -> int:
    """--market: fetch the operator's /market envelope (exit 2 when the
    endpoint is unreachable, like --profile)."""
    try:
        env = fetch(args.operator_url, "/market")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.operator_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_market(env.get("data") or {}))
    return 0


def render_usage(data) -> str:
    """The fleet ledger's view: the efficiency headline, the per-kind
    attribution table (conservation means the SECONDS column sums to
    capacity exactly), the per-lane serving split, per-tenant billing,
    and the top waste windows each joined to the timeline events that
    overlapped them."""
    if not data or not data.get("ticks"):
        return ("no usage attributed yet (operator warming up, or "
                "running with usage accounting disabled?)")
    capacity = data.get("capacity_s") or 0.0
    lines = [f"fleet efficiency {data.get('efficiency', 0):.1%} "
             f"productive over {_fmt_duration(capacity)} capacity "
             f"({data.get('ticks', 0)} ticks)"]
    billing = data.get("billing") or {}
    if billing.get("fleet_goodput_fraction") is not None:
        lines.append(f"fleet goodput fraction "
                     f"{billing['fleet_goodput_fraction']:.1%} "
                     f"(training goodput vs badput folded in)")
    kinds = data.get("kinds") or {}
    if kinds:
        headers = ("KIND", "SECONDS", "%CAP")
        table = [(kind, _fmt_duration(seconds),
                  f"{seconds / capacity:.1%}" if capacity else "-")
                 for kind, seconds in sorted(
                     kinds.items(), key=lambda kv: -kv[1])
                 if seconds > 0]
        widths = [max(len(h), *(len(t[i]) for t in table))
                  for i, h in enumerate(headers)]
        lines.append("")
        lines.append("  ".join(h.ljust(w)
                               for h, w in zip(headers, widths)))
        for t in table:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(t, widths)))
    lanes = data.get("lanes") or {}
    if lanes:
        lines.append("")
        lines.append("serving by lane: " + ", ".join(
            f"{lane} {_fmt_duration(seconds)}"
            for lane, seconds in sorted(
                lanes.items(), key=lambda kv: -kv[1])))
    tenants = billing.get("tenants") or {}
    if tenants:
        headers = ("TENANT", "SECONDS", "COST", "TOKENS")
        table = []
        for name, rec in sorted(tenants.items()):
            table.append((name, _fmt_duration(rec.get("seconds", 0.0)),
                          f"{rec.get('cost', 0.0):.1f}",
                          str(int(rec.get("tokens", 0)))
                          if rec.get("tokens") else "-"))
        widths = [max(len(h), *(len(t[i]) for t in table))
                  for i, h in enumerate(headers)]
        lines.append("")
        lines.append("  ".join(h.ljust(w)
                               for h, w in zip(headers, widths)))
        for t in table:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(t, widths)))
    waste = data.get("waste") or []
    if waste:
        lines.append("")
        lines.append(f"top {len(waste)} waste window(s):")
        for bucket in waste:
            stamp = datetime.datetime.fromtimestamp(
                bucket["start"], tz=datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%S")
            span = _fmt_duration(bucket["end"] - bucket["start"])
            lines.append(f"  {stamp} (+{span})  {bucket['waste']:<20} "
                         f"{_fmt_duration(bucket['node_s'])} node-time")
            for ev in bucket.get("events") or []:
                estamp = datetime.datetime.fromtimestamp(
                    ev["t"], tz=datetime.timezone.utc).strftime(
                    "%H:%M:%S")
                lines.append(f"      {estamp}  {ev['kind']:<18} "
                             f"{ev['entity']}  {ev.get('detail') or '-'}")
    return "\n".join(lines)


def run_usage_view(args, fetch=fetch_view) -> int:
    """--usage: fetch the operator's /usage envelope (exit 2 when the
    endpoint is unreachable, like --market)."""
    try:
        env = fetch(args.operator_url, "/usage")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.operator_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_usage(env.get("data") or {}))
    return 0


def render_incident(report) -> str:
    """One CauseReport: the header (rule/slo/severity/burn window), the
    ranked candidate-cause table (score = overlap × distance decay ×
    kind prior), then the raw timeline evidence behind the leading
    cause."""
    fired = datetime.datetime.fromtimestamp(
        report["fired_at"], tz=datetime.timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S UTC")
    lines = [f"incident {report['id']}  "
             f"({report['severity'].upper()} {report['rule']})",
             f"slo: {report['slo']}  fired: {fired}  burn window: "
             f"{_fmt_duration(report['window_s'])}  families: "
             f"{', '.join(report.get('families') or []) or '-'}"]
    causes = report.get("causes") or []
    if not causes:
        lines.append("no candidate causes inside the burn window "
                     "(timeline empty, or nothing touched the alert's "
                     "entity scope)")
        return "\n".join(lines)
    headers = ("RANK", "SCORE", "KIND", "ENTITY", "OVERLAP", "HOPS",
               "DETAIL")
    table = []
    for c in causes:
        hops = "-" if c.get("distance", -1) < 0 else str(c["distance"])
        table.append((str(c["rank"]), f"{c['score']:.3f}", c["kind"],
                      c["entity"], f"{c['overlap']:.2f}", hops,
                      (c.get("detail") or "-")[:48]))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines.append("")
    lines.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    evidence = causes[0].get("evidence") or []
    if evidence:
        lines.append("")
        lines.append(f"evidence behind the leading cause "
                     f"({causes[0]['kind']} {causes[0]['entity']}):")
        for ev in evidence:
            stamp = datetime.datetime.fromtimestamp(
                ev["t"], tz=datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%S")
            span = ("" if ev.get("until") is None else
                    f" (+{_fmt_duration(ev['until'] - ev['t'])})")
            lines.append(f"  {stamp}{span}  {ev['kind']:<18} "
                         f"{ev['entity']}  {ev.get('detail') or '-'}")
    return "\n".join(lines)


def run_incident_view(args, fetch=fetch_view) -> int:
    """--incident: fetch the operator's /causes envelope and render the
    newest CauseReport whose rule or SLO matches the query (exit 2 when
    the endpoint is unreachable, like the other HTTP views; exit 0 with
    a hint when no report matches — an incident view must not fail the
    pipeline that is trying to debug one)."""
    try:
        env = fetch(args.operator_url, "/causes")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.operator_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
        return 0
    reports = (env.get("data") or {}).get("reports") or []
    query = args.incident
    match = None
    for report in reversed(reports):
        if (query in (report.get("rule"), report.get("slo"))
                or (report.get("rule") or "").startswith(query + ":")):
            match = report
            break
    if match is None:
        known = sorted({r["rule"] for r in reports if r.get("rule")})
        print(f"no cause report for {query!r}"
              + (f" (rules with reports: {', '.join(known)})" if known
                 else " (no alert has fired yet)"))
        return 0
    print(render_incident(match))
    return 0


def render_replicas(data) -> str:
    """One row per serving replica from the router's /replicas view."""
    replicas = data.get("replicas") or []
    if not replicas:
        return "no replicas registered with the router"
    headers = ("REPLICA", "NODE", "STATE", "QUEUE", "SLOTS", "WEIGHT")
    table = []
    for r in replicas:
        if r.get("failed"):
            state = "failed"
        elif r.get("drained"):
            state = "drained"
        elif r.get("draining"):
            state = f"draining({r.get('drain_reason') or '?'})"
        else:
            state = "admitting"
        queue = "?" if r.get("stale") else f"{r.get('queue_depth', 0):g}"
        slots = (f"{r.get('slots_busy', 0):g}/"
                 f"{r.get('slots_total', 0):g}")
        table.append((r["id"], r["node"], state, queue, slots,
                      f"{r.get('weight', 1.0):g}"))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    summary = data.get("summary") or {}
    lines.append(f"{summary.get('total', len(replicas))} replicas: "
                 f"{summary.get('admitting', '?')} admitting, "
                 f"{summary.get('draining', '?')} draining, "
                 f"{summary.get('failed', '?')} failed")
    scaler = data.get("autoscaler")
    if scaler:
        last = scaler.get("last_decision") or {}
        lines.append(f"autoscaler: {scaler.get('scale_ups', 0)} up / "
                     f"{scaler.get('scale_downs', 0)} down"
                     + (f", last: {last.get('action')} "
                        f"({last.get('reason')})" if last else ""))
    return "\n".join(lines)


def run_replicas_view(args, fetch=fetch_view) -> int:
    try:
        env = fetch(args.router_url, "/replicas")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.router_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_replicas(env.get("data") or {}))
    return 0


def render_request(data) -> str:
    """One request's stage timeline from the router's /trace?rid= view:
    the trace context it carries across hops, then one row per stage
    with the dwell time spent there (the rows partition the request's
    measured latency)."""
    rid = data.get("rid", "?")
    state = "open" if data.get("open") else "closed"
    lines = [f"request {rid} ({state})  lane: {data.get('lane', '?')}",
             f"trace: {data.get('trace_id', '?')}  "
             f"span: {data.get('span_id', '?')}  "
             f"hop: {data.get('hop', '?')}"]
    stages = data.get("stages") or []
    durations = data.get("durations") or {}
    headers = ("SEQ", "STAGE", "AT", "DWELL")
    table = []
    for seq, stage, ts in stages:
        dwell = durations.get(stage)
        table.append((str(seq), stage, f"{ts:.6f}",
                      "-" if dwell is None else _fmt_ms(dwell)))
    if not table:
        lines.append("  (no stages recorded)")
        return "\n".join(lines)
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    lines.append(f"{len(stages)} stages, "
                 f"{_fmt_ms(data.get('latency_s', 0.0))} measured latency "
                 f"(stage dwells partition it exactly)")
    overhead = (data.get("self") or {})
    if overhead:
        parts = ", ".join(f"{k} {_fmt_ms(v)}"
                          for k, v in sorted(overhead.items()))
        lines.append(f"router self-time: {parts}")
    return "\n".join(lines)


def run_request_view(args, fetch=fetch_view) -> int:
    try:
        env = fetch(args.router_url, f"/trace?rid={args.request}")
    except Exception as exc:  # exc: allow — an unreachable endpoint of any shape is exit 2 with the message
        print(f"error: cannot read {args.router_url}: {exc}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(env, indent=2))
    else:
        print(render_request(env.get("data") or {}))
    return 0


def render_timeline(component: str, node_name: str, rows, stuck,
                    truncated: int = 0) -> str:
    lines = [f"component: {component}  node: {node_name}"]
    if not rows:
        lines.append("  (no journey recorded — the node never transitioned "
                     "under this component's state machine)")
        return "\n".join(lines)
    if truncated:
        lines.append(f"  ({truncated} older entr"
                     f"{'y' if truncated == 1 else 'ies'} truncated by the "
                     f"journey size guard)")
    headers = ("STATE", "ENTERED", "DURATION")
    table = []
    for r in rows:
        entered = datetime.datetime.fromtimestamp(
            r["entered"], tz=datetime.timezone.utc).strftime(
            "%Y-%m-%d %H:%M:%S")
        dur = _fmt_duration(r["duration_s"]) + ("+" if r["ongoing"] else "")
        table.append((r["state"], entered, dur))
    widths = [max(len(h), *(len(t[i]) for t in table))
              for i, h in enumerate(headers)]
    lines.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for t in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(t, widths)))
    total = sum(r["duration_s"] for r in rows[:-1])
    lines.append(f"{len(rows)} transitions, {_fmt_duration(total)} in "
                 f"completed phases")
    if stuck:
        state, _, entered = stuck.partition("@")
        lines.append(f"STUCK reported: state {state} (entered-at {entered})")
    return "\n".join(lines)


def main(argv=None, client=None, now=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--component", action="append", default=None,
                   help="managed component name (repeatable; required for "
                        "the fleet/timeline/goodput views)")
    p.add_argument("--namespace", default="kube-system")
    p.add_argument("--selector", default=None,
                   help='driver-pod label selector, "k=v,k2=v2"')
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("--context", default=None)
    p.add_argument("--in-cluster", action="store_true")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output ({kind, data} envelope)")
    p.add_argument("--timeline", default=None, metavar="NODE",
                   help="render NODE's upgrade journey (per-phase "
                        "durations) instead of the fleet table")
    p.add_argument("--goodput", default=None, metavar="LEDGER",
                   help="render a workload goodput ledger (goodput.jsonl) "
                        "instead of the fleet table")
    p.add_argument("--goodput-node", default=None, metavar="NODE",
                   help="with --goodput: attribute each unavailability "
                        "window against NODE's upgrade journey")
    p.add_argument("--slo", action="store_true",
                   help="render the SLO engine's error budgets and burn "
                        "rates from a running operator")
    p.add_argument("--alerts", action="store_true",
                   help="render the alert rule states from a running "
                        "operator")
    p.add_argument("--operator-url", default="http://127.0.0.1:8080",
                   metavar="URL",
                   help="operator metrics server for --slo/--alerts "
                        "(default %(default)s)")
    p.add_argument("--watch", action="store_true",
                   help="with --slo/--alerts: live-refresh fleet "
                        "dashboard (sparkline budget history)")
    p.add_argument("--watch-interval", type=float, default=2.0,
                   metavar="SECONDS")
    p.add_argument("--watch-count", type=int, default=0, metavar="N",
                   help="stop after N refreshes (0 = forever)")
    p.add_argument("--profile", action="store_true",
                   help="render the tick flight recorder's last-tick "
                        "decomposition and critical path from a running "
                        "operator's /profile endpoint")
    p.add_argument("--resilience", action="store_true",
                   help="render the resilient client boundary's breaker "
                        "state, retry/shed counters, and degraded-mode "
                        "posture from a running operator's /resilience "
                        "endpoint")
    p.add_argument("--market", action="store_true",
                   help="render the capacity arbiter's lane depths, "
                        "slice ownership and recent decisions from a "
                        "running operator's /market endpoint")
    p.add_argument("--usage", action="store_true",
                   help="render the fleet ledger's utilization "
                        "accounting (per-kind/per-lane attribution, "
                        "efficiency, per-tenant billing, top waste "
                        "windows) from a running operator's /usage "
                        "endpoint")
    p.add_argument("--incident", default=None, metavar="ALERT",
                   help="render the root-cause engine's newest "
                        "CauseReport for this alert rule or SLO name "
                        "from a running operator's /causes endpoint")
    p.add_argument("--replicas", action="store_true",
                   help="render the serving router's replica registry "
                        "from a running router binary (router.py)")
    p.add_argument("--request", default=None, metavar="RID",
                   help="render one request's flight-recorder stage "
                        "timeline from a running router binary's "
                        "/trace?rid= endpoint")
    p.add_argument("--router-url", default="http://127.0.0.1:8300",
                   metavar="URL",
                   help="router endpoint for --replicas/--request "
                        "(default %(default)s)")
    args = p.parse_args(argv)

    if args.request is not None:
        # the flight recorder lives in the router process; one request's
        # timeline is its HTTP view (GET /trace?rid=)
        return run_request_view(args)
    if args.replicas:
        # the replica registry is the router's HTTP view, never the
        # cluster's (the router owns the authoritative in-memory state)
        return run_replicas_view(args)
    if args.market:
        # the arbiter lives in the operator process; its ledger is the
        # authoritative state, so this is an HTTP view like --profile
        return run_market_view(args)
    if args.usage:
        # the usage meter lives in the operator process; its ledger is
        # the authoritative state, so this is an HTTP view like --market
        return run_usage_view(args)
    if args.resilience:
        # breaker state + degraded-mode posture: the operator's HTTP
        # view
        return run_resilience_view(args)
    if args.incident is not None:
        # the cause engine lives in the operator process; its report
        # ring is the authoritative state, so this is an HTTP view too
        return run_incident_view(args)
    if args.profile:
        # the flight recorder lives in the operator process; its ring is
        # the authoritative state, so this is an HTTP view too
        return run_profile_view(args)
    if args.slo or args.alerts or args.watch:
        # SLO views read the operator's HTTP endpoints, never the cluster
        return run_slo_view(args)
    if not args.component:
        p.error("--component is required (except with --slo/--alerts)")
    # --goodput without a node never touches the cluster — the ledger is
    # a local file
    if client is None and not (args.goodput and not args.goodput_node):
        client = build_client(args)
    selector = parse_selector(args.selector) if args.selector else None

    if args.goodput:
        summary, attributions = collect_goodput(
            args.goodput, client=client, components=args.component,
            node_name=args.goodput_node, now=now)
        if args.as_json:
            print(json.dumps({"kind": "goodput", "data": {
                "ledger": args.goodput, "summary": summary,
                "attribution": attributions}}, indent=2))
        else:
            print(render_goodput(args.goodput, summary, attributions,
                                 node_name=args.goodput_node))
        return 0

    if args.timeline:
        out = {}
        for comp in args.component:
            rows, stuck, truncated = collect_timeline(
                client, comp, args.timeline, now=now)
            out[comp] = {"node": args.timeline, "timeline": rows,
                         "stuck_reported": stuck, "truncated": truncated}
            if not args.as_json:
                print(render_timeline(comp, args.timeline, rows, stuck,
                                      truncated))
                print()
        if args.as_json:
            print(json.dumps({"kind": "timeline", "data": out}, indent=2))
        return 0

    rc = 0
    out = {}
    for comp in args.component:
        rows = collect_status(client, comp, args.namespace,
                              selector or {"app": comp})
        out[comp] = rows
        if any(r["state"] == UpgradeState.FAILED for r in rows):
            rc = max(rc, FAILED_RC)
        elif any(r["state"] not in ("unknown", UpgradeState.DONE)
                 for r in rows):
            rc = max(rc, IN_FLIGHT_RC)
        if not args.as_json:
            print(render_table(comp, rows))
            print()
    if args.as_json:
        print(json.dumps(out, indent=2))
    return rc


if __name__ == "__main__":
    sys.exit(main())
