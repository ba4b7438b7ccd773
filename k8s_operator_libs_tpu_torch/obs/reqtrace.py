"""Request flight recorder: per-request stage timelines and trace context.

A copy of the JAX package's ``obs/reqtrace.py``, with the same wire
format, stage catalog and metric families, so one trace id spans the
router binary (``router.py``), a JAX replica and a port replica alike:

- **stage timeline**: each request walks the closed catalog
  :data:`STAGES` (``admitted -> queued -> assigned -> prefill ->
  first_token -> streaming -> completed``, with the live-migration detour
  ``drain -> export -> transfer -> adopt -> splice`` and the failure
  edges ``fallback`` and ``shed``). Transitions are stamped on the
  injected clock, so the per-stage durations sum to the request's
  latency by construction;
- **trace context**: a trace id plus per-hop span ids, carried as the
  ``X-TPU-Trace`` header and a ``"trace"`` field of the generate, export
  and adopt payloads. A garbled header parses to None and the caller
  starts a fresh root trace: never an error to the client;
- **router self-time**: the relay's own work on a request (accept,
  route, relay, reseq, splice), measured on an optional performance
  counter (``selfclock``) and observed per completed request in
  ``tpu_router_proxy_overhead_seconds``: the latency the router adds,
  replica compute excluded. The self clock is separate from the stage
  clock, so runs on a fake clock stay deterministic (``selfclock=None``
  turns it off);
- **fixed memory**: a ring of the last N closed timelines plus a bounded
  table of open ones;
- **observational**: recording changes no router state and draws no
  random numbers. With ``timeline`` given, the disruption edges (drain,
  shed, splice, crash requeue) are also recorded as fleet events
  (``obs/timeline.py``).

A serving replica (``server.py``) constructs it with neither ``metrics``
nor ``selfclock``: it records timelines only.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import threads
from ..utils.clock import Clock, RealClock

# last-N closed timelines kept (a timeline is a few hundred bytes of
# plain lists; 256 requests of history)
DEFAULT_TRACE_RING = 256
# abandoned-request backstop: an open timeline whose request never
# reaches a terminal stage (lost client, crashed runtime chain) must not
# leak its transitions forever
DEFAULT_MAX_OPEN_TRACES = 1024

# the families the recorder emits through the hub (full exposed names)
REQTRACE_HISTOGRAM_FAMILIES = (
    "tpu_router_request_stage_seconds",
    "tpu_router_proxy_overhead_seconds",
)
REQTRACE_GAUGE_FAMILIES = (
    "tpu_router_traces_open",
    "tpu_router_traces_closed",
    "tpu_router_traces_dropped",
)

# The closed stage catalog, in canonical order. The happy path runs the
# first seven; the live-migration detour inserts drain..splice between
# streaming visits; fallback/crash edges re-enter queued; shed is the
# overload terminal.
STAGES = (
    "admitted",      # submit() accepted the request onto a lane
    "queued",        # waiting (weighted-fair) for a replica with headroom
    "assigned",      # placement decision made
    "prefill",       # replica is processing the prompt
    "first_token",   # the first generated token reached the client stream
    "streaming",     # tokens flowing
    "drain",         # donor replica draining; live migration begins
    "export",        # KV state exported at a step boundary
    "transfer",      # payload in flight to the chosen peer
    "adopt",         # peer adopted the slot
    "splice",        # stream spliced at the last acked sequence number
    "completed",     # delivered exactly once (terminal)
    "shed",          # dropped by overload policy (terminal)
    "fallback",      # migration budget exhausted; re-prefill from prompt
)
TERMINAL_STAGES = ("completed", "shed")
MIGRATION_STAGES = ("drain", "export", "transfer", "adopt", "splice")

# Legal stage transitions; validate_timeline checks every recorded
# timeline against them. Same-stage repeats are recorder no-ops, so they never
# appear as transitions. queued re-entries model crash requeues
# (prefill/streaming -> queued) and the fallback re-prefill
# (fallback -> queued); prefill/splice -> completed covers requests that
# finish without streaming another token.
LEGAL_STAGE_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    "admitted": ("queued",),
    "queued": ("assigned", "shed"),
    "assigned": ("prefill",),
    "prefill": ("first_token", "completed", "drain", "queued"),
    "first_token": ("streaming",),
    "streaming": ("completed", "drain", "queued"),
    "drain": ("export", "fallback", "completed", "queued"),
    "export": ("transfer", "fallback"),
    "transfer": ("adopt", "fallback"),
    "adopt": ("splice",),
    "splice": ("streaming", "completed", "drain", "queued"),
    "fallback": ("queued",),
    "completed": (),
    "shed": (),
}

# stage durations span sub-ms relay hops to multi-second queue waits —
# the apiserver ms-range ladder fits
STAGE_SECONDS_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0)
# router-added latency is micro- to milliseconds; the stage ladder's
# first bucket (1 ms) would flatten every healthy request into one bin
OVERHEAD_SECONDS_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
    2.5e-2, 0.1, 0.5, 1.0)

# ------------------------------------------------------------ wire format

# X-TPU-Trace: <trace_id>/<span_id>/<hop> — ids are [A-Za-z0-9_.:-],
# hop a small decimal. Anything else is garbled and degrades to a fresh
# root trace (parse returns None; never an error to the client).
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")
TRACE_HEADER = "X-TPU-Trace"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's identity inside a request trace."""

    trace_id: str
    span_id: str
    hop: int = 0

    def encode(self) -> str:
        return f"{self.trace_id}/{self.span_id}/{self.hop}"


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``X-TPU-Trace`` header (or a payload ``"trace"`` field).

    Returns None for anything missing or malformed — the caller then
    mints a fresh root trace, so a dropped or corrupted header degrades
    to a broken-but-served trace, never a 5xx."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("/")
    if len(parts) != 3:
        return None
    trace_id, span_id, hop_s = parts
    if not (_TRACE_ID_RE.match(trace_id) and _TRACE_ID_RE.match(span_id)):
        return None
    try:
        hop = int(hop_s)
    except ValueError:
        return None
    if not 0 <= hop < 1000:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, hop=hop)


def stage_durations(stages: List[Any]) -> Dict[str, float]:
    """Per-stage dwell from a ``[(seq, stage, t), ...]`` transition list.

    Stage i's dwell is ``t[i+1] - t[i]``; the final (terminal or
    still-open) stage contributes zero — so the values sum back to
    ``t[-1] - t[0]``, the measured latency, by construction."""
    out: Dict[str, float] = {}
    for i in range(len(stages) - 1):
        _, stage, t = stages[i]
        nxt_t = stages[i + 1][2]
        out[stage] = out.get(stage, 0.0) + max(0.0, nxt_t - t)
    return out


def durations_partition_latency(timeline: Dict[str, Any],
                                rel_tol: float = 1e-9) -> bool:
    """The sums-to-the-window law: a closed timeline's stage durations
    must sum to its measured latency (within float telescoping noise)."""
    durations = timeline.get("durations") or stage_durations(
        timeline["stages"])
    total = math.fsum(durations.values())
    latency = float(timeline.get("latency_s",
                                 timeline["stages"][-1][2]
                                 - timeline["stages"][0][2]))
    return abs(total - latency) <= rel_tol * max(1.0, abs(latency))


class RequestTraceRecorder:
    """Per-request stage timelines in fixed memory.

    Purely observational: hooks in ``serving/router.py``, ``router.py``
    and ``server.py`` call :meth:`begin` / :meth:`stage` at each
    lifecycle edge; the recorder never mutates router state, never
    raises into the request path (unknown rids are no-ops), and consumes
    no randomness — trace/span ids are minted from a counter, so
    same-seed runs replay identical timelines.

    ``selfclock`` (e.g. ``time.perf_counter``) enables router self-time
    accounting; the default None keeps timelines free of wall-clock
    values so injected-clock runs stay deterministic."""

    def __init__(self, clock: Optional[Clock] = None, metrics=None,
                 max_closed: int = DEFAULT_TRACE_RING,
                 max_open: int = DEFAULT_MAX_OPEN_TRACES,
                 selfclock: Optional[Callable[[], float]] = None,
                 timeline=None):
        self._clock = clock or RealClock()
        self._metrics = metrics
        # fleet black box (obs/timeline.py): the disruption edges —
        # drain, shed, migration splice, crash requeue — are recorded as
        # FleetEvents under this recorder's own lock (the timeline
        # itself is lock-free single-writer). Happy-path stage churn
        # stays out: only the edges that can CAUSE a latency burn
        # matter to the root-cause engine.
        self._timeline = timeline
        self._max_closed = int(max_closed)
        self._max_open = int(max_open)
        self._selfclock = selfclock
        self._lock = threads.make_lock("reqtrace")
        self._open: Dict[Any, Dict[str, Any]] = {}
        self._ring: List[Dict[str, Any]] = []
        self._minted = 0
        self.closed = 0          # timelines that reached a terminal stage
        self.dropped = 0         # open entries evicted by the backstop
        self.spliced = 0         # closed timelines that recorded a splice
        # cumulative stage counters that survive ring/open-table
        # eviction, to reconcile against the router's own migration
        # counts
        self.splices = 0         # splice transitions (one per migration)
        self.fallbacks = 0       # fallback transitions (one per fallback)
        # per-stage dwell totals over every closed timeline (survives
        # ring eviction; the /requests aggregate renders it)
        self._stage_totals: Dict[str, Dict[str, float]] = {}

    # ---------------------------------------------------------- lifecycle

    def begin(self, rid, lane: str = "interactive",
              parent: Optional[TraceContext] = None) -> TraceContext:
        """Open a timeline at stage ``admitted``. With a ``parent``
        context (propagated header/payload) the new hop joins that
        trace; otherwise a fresh root trace is minted."""
        with self._lock:
            self._minted += 1
            span_id = f"s{self._minted:06x}"
            if parent is not None:
                ctx = TraceContext(trace_id=parent.trace_id,
                                   span_id=span_id, hop=parent.hop + 1)
            else:
                ctx = TraceContext(trace_id=f"t{self._minted:08x}",
                                   span_id=span_id, hop=0)
            if rid in self._open:     # re-begin: keep the first timeline
                return self._context_locked(self._open[rid])
            self._open[rid] = {
                "rid": rid, "trace_id": ctx.trace_id,
                "span_id": ctx.span_id, "hop": ctx.hop, "lane": lane,
                "stages": [(0, "admitted", self._clock.now())],
                "overhead_s": 0.0, "self": {},
            }
            while len(self._open) > self._max_open:
                victim = next(iter(self._open))
                del self._open[victim]
                self.dropped += 1
            self._gauges_locked()
            return ctx

    def stage(self, rid, stage: str) -> None:
        """Record a stage transition for ``rid``. Unknown rids and
        same-stage repeats are no-ops; a terminal stage closes the
        timeline into the ring and observes its per-stage histograms."""
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                # evicted open entry: keep the cumulative migration
                # counters truthful anyway
                if stage == "splice":
                    self.splices += 1
                elif stage == "fallback":
                    self.fallbacks += 1
                return
            stages = entry["stages"]
            if stages[-1][1] == stage:
                return
            prev = stages[-1][1]
            stages.append((len(stages), stage, self._clock.now()))
            if stage == "splice":
                self.splices += 1
            elif stage == "fallback":
                self.fallbacks += 1
            if self._timeline is not None:
                entity = f"request/{rid}"
                lane = entry["lane"]
                if stage == "drain":
                    self._timeline.link(entity, f"lane/{lane}")
                    self._timeline.record_event(
                        kind="router-drain", entity=entity,
                        detail=f"lane {lane}: donor draining")
                elif stage == "shed":
                    self._timeline.link(entity, f"lane/{lane}")
                    self._timeline.record_event(
                        kind="router-shed", entity=entity,
                        detail=f"lane {lane}: shed at {prev}")
                elif stage == "splice":
                    self._timeline.link(entity, f"lane/{lane}")
                    self._timeline.record_event(
                        kind="router-migration", entity=entity,
                        detail=f"lane {lane}: stream spliced")
                elif stage == "queued" and prev in ("prefill",
                                                    "streaming",
                                                    "drain", "splice"):
                    self._timeline.link(entity, f"lane/{lane}")
                    self._timeline.record_event(
                        kind="router-requeue", entity=entity,
                        detail=f"lane {lane}: crash requeue "
                               f"from {prev}")
            if stage in TERMINAL_STAGES:
                self._close_locked(rid, entry)

    def token_appended(self, rid) -> None:
        """A token just reached the request's client-visible stream.
        From ``prefill`` this is the first-token edge (``first_token``
        then ``streaming``); from ``splice`` the stream resumes
        (``streaming``); while already streaming — or during a drain
        sync — it is a no-op, so callers can invoke it per token."""
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                return
            stages = entry["stages"]
            last = stages[-1][1]
            now = self._clock.now()
            if last == "prefill":
                stages.append((len(stages), "first_token", now))
                stages.append((len(stages), "streaming", now))
            elif last == "splice":
                stages.append((len(stages), "streaming", now))

    def overhead(self, rid, seconds: float,
                 phase: Optional[str] = None) -> None:
        """Fold ``seconds`` of router self-time (work the relay itself
        did on this request's behalf — accept/route/relay/reseq/splice)
        into the request's proxy-overhead total."""
        if seconds <= 0.0:
            return
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                return
            entry["overhead_s"] += seconds
            if phase:
                entry["self"][phase] = entry["self"].get(phase, 0.0) \
                    + seconds

    def timer(self, rid, phase: str):
        """Context manager measuring one self-time segment on the
        recorder's ``selfclock``; a no-op (zero cost, no wall reads)
        when self-timing is disabled."""
        return _SelfTimer(self, rid, phase)

    def _close_locked(self, rid, entry: Dict[str, Any]) -> None:
        del self._open[rid]
        stages = entry["stages"]
        entry["durations"] = stage_durations(stages)
        entry["latency_s"] = max(0.0, stages[-1][2] - stages[0][2])
        entry["terminal"] = stages[-1][1]
        self.closed += 1
        if any(s == "splice" for _, s, _ in stages):
            self.spliced += 1
        for stage, dur in entry["durations"].items():
            tot = self._stage_totals.setdefault(
                stage, {"count": 0, "total_s": 0.0})
            tot["count"] += 1
            tot["total_s"] += dur
            if self._metrics is not None:
                self._metrics.observe(
                    "request_stage_seconds", dur,
                    labels={"stage": stage, "lane": entry["lane"]},
                    buckets=STAGE_SECONDS_BUCKETS)
        if self._metrics is not None and self._selfclock is not None:
            self._metrics.observe(
                "proxy_overhead_seconds", entry["overhead_s"],
                labels={"lane": entry["lane"]},
                buckets=OVERHEAD_SECONDS_BUCKETS)
        self._ring.append(entry)
        if len(self._ring) > self._max_closed:
            self._ring.pop(0)
        self._gauges_locked()

    def _gauges_locked(self) -> None:
        if self._metrics is None:
            return
        self._metrics.set_gauge("traces_open", len(self._open))
        self._metrics.set_gauge("traces_closed", self.closed)
        self._metrics.set_gauge("traces_dropped", self.dropped)  # thr: allow — every caller holds self._lock (the _locked suffix contract)

    def _context_locked(self, entry: Dict[str, Any]) -> TraceContext:
        return TraceContext(trace_id=entry["trace_id"],
                            span_id=entry["span_id"],
                            hop=entry["hop"])

    # --------------------------------------------------------------- reads

    def context(self, rid) -> Optional[TraceContext]:
        """The trace context to forward to the next hop (header /
        payload ``"trace"`` field), or None for an unknown rid."""
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                entry = next((e for e in reversed(self._ring)
                              if e["rid"] == rid), None)
            return None if entry is None else self._context_locked(entry)

    def timeline(self, rid) -> Optional[Dict[str, Any]]:
        """A copy of ``rid``'s timeline — closed (with durations) or
        still open (without) — or None if never seen / evicted."""
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                entry = next((e for e in reversed(self._ring)
                              if e["rid"] == rid), None)
            return None if entry is None else _copy_timeline(entry)

    def timelines(self) -> List[Dict[str, Any]]:
        """Copies of every retained closed timeline, oldest first."""
        with self._lock:
            return [_copy_timeline(e) for e in self._ring]

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def open_timelines(self) -> List[Dict[str, Any]]:
        """Copies of every still-open timeline (insertion order)."""
        with self._lock:
            return [_copy_timeline(e) for e in self._open.values()]

    def payload(self, last: int = 8) -> Dict[str, Any]:
        """The ``/requests`` endpoint's data: recent closed timelines
        plus the cumulative per-stage aggregate."""
        with self._lock:
            ring = [_copy_timeline(e) for e in self._ring]
            return {
                "open": len(self._open), "closed": self.closed,
                "dropped": self.dropped, "spliced": self.spliced,
                "ring_capacity": self._max_closed,
                "last": ring[-max(1, int(last)):],
                "stage_totals": {
                    s: dict(t)
                    for s, t in sorted(self._stage_totals.items())},
            }

    def trace_payload(self, rid) -> Optional[Dict[str, Any]]:
        """The ``/trace?rid=`` envelope data: one request's timeline
        with durations computed even while open."""
        timeline = self.timeline(rid)
        if timeline is None:
            return None
        if "durations" not in timeline:
            timeline["durations"] = stage_durations(timeline["stages"])
            timeline["latency_s"] = max(
                0.0, timeline["stages"][-1][2] - timeline["stages"][0][2])
            timeline["open"] = True
        else:
            timeline["open"] = False
        return timeline


def validate_timeline(timeline: Dict[str, Any],
                      closed: bool = True) -> List[str]:
    """Defects in one recorded timeline, as strings (empty = clean):
    gapless stage seqs, transitions legal per
    :data:`LEGAL_STAGE_TRANSITIONS`, timestamps monotone, exactly one
    terminal stage (the last, required when ``closed``), and — for
    closed timelines — stage durations partitioning the measured
    latency."""
    msgs: List[str] = []
    stages = timeline.get("stages") or []
    rid = timeline.get("rid")
    if not stages:
        return [f"request {rid}: empty timeline"]
    if stages[0][1] != "admitted":
        msgs.append(f"request {rid}: timeline starts at "
                    f"{stages[0][1]!r}, not 'admitted'")
    for i, (seq, stage, _t) in enumerate(stages):
        if seq != i:
            msgs.append(f"request {rid}: stage seq {seq} at position "
                        f"{i} (gap or duplicate)")
            break
        if stage not in STAGES:
            msgs.append(f"request {rid}: unknown stage {stage!r}")
    for i in range(len(stages) - 1):
        _, a, ta = stages[i]
        _, b, tb = stages[i + 1]
        legal = LEGAL_STAGE_TRANSITIONS.get(a, ())
        if b not in legal:
            msgs.append(f"request {rid}: illegal stage transition "
                        f"{a!r} -> {b!r} (legal: "
                        f"{', '.join(legal) or 'none — terminal'})")
        if tb < ta:
            msgs.append(f"request {rid}: stage time regressed "
                        f"{a!r}@{ta:.6f} -> {b!r}@{tb:.6f}")
    terminals = sum(1 for _, s, _ in stages if s in TERMINAL_STAGES)
    if closed:
        if stages[-1][1] not in TERMINAL_STAGES:
            msgs.append(f"request {rid}: closed timeline ends at "
                        f"non-terminal {stages[-1][1]!r}")
        elif terminals != 1:
            msgs.append(f"request {rid}: {terminals} terminal stages "
                        f"(exactly-once demands 1)")
        if not durations_partition_latency(timeline):
            msgs.append(f"request {rid}: stage durations do not sum to "
                        f"the measured latency (attribution law)")
    elif terminals != 0:
        msgs.append(f"request {rid}: open timeline already passed a "
                    f"terminal stage")
    return msgs


class _SelfTimer:
    """One measured self-time segment (see RequestTraceRecorder.timer)."""

    __slots__ = ("_recorder", "_rid", "_phase", "_t0")

    def __init__(self, recorder: RequestTraceRecorder, rid, phase: str):
        self._recorder = recorder
        self._rid = rid
        self._phase = phase
        self._t0 = 0.0

    def __enter__(self):
        if self._recorder._selfclock is not None:
            self._t0 = self._recorder._selfclock()
        return self

    def __exit__(self, exc_type, exc, tb):
        sc = self._recorder._selfclock
        if sc is not None:
            self._recorder.overhead(self._rid, sc() - self._t0,
                                    phase=self._phase)
        return False


def _copy_timeline(entry: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(entry)
    out["stages"] = [list(s) for s in entry["stages"]]
    out["self"] = dict(entry["self"])
    if "durations" in entry:
        out["durations"] = dict(entry["durations"])
    return out
