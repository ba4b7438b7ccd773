"""Request flight recorder: per-request stage timelines and trace context.

A copy of what a serving replica uses from
the JAX package's ``obs/reqtrace.py``, with the same wire format and
stage catalog, so one trace id spans a JAX replica and a port replica
alike:

- **stage timeline**: each request walks the closed catalog
  :data:`STAGES` (``admitted -> queued -> assigned -> prefill ->
  first_token -> streaming -> completed``, with the live-migration detour
  ``drain -> export -> transfer -> adopt -> splice``). Transitions are
  stamped on the injected clock, so the per-stage durations sum to the
  request's latency by construction;
- **trace context**: a trace id plus per-hop span ids, carried as the
  ``X-TPU-Trace`` header and a ``"trace"`` field of the generate, export
  and adopt payloads. A garbled header parses to None and the caller
  starts a fresh root trace: never an error to the client;
- **fixed memory**: a ring of the last N closed timelines plus a bounded
  table of open ones.

The reference's router-only parts (the metrics hub families, router
self-time, the fleet timeline hooks) stay behind: a replica records no
metrics families of its own.
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.clock import Clock, RealClock

# last-N closed timelines kept
DEFAULT_TRACE_RING = 256
# an open timeline whose request never reaches a terminal stage must not
# stay forever
DEFAULT_MAX_OPEN_TRACES = 1024

# The closed stage catalog, in canonical order.
STAGES = (
    "admitted",      # submit() accepted the request
    "queued",        # waiting for a slot
    "assigned",      # placement decision made
    "prefill",       # the replica is processing the prompt
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

# Legal stage transitions. Same-stage repeats are recorder no-ops, so
# they never appear as transitions.
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

# ------------------------------------------------------------ wire format

# X-TPU-Trace: <trace_id>/<span_id>/<hop>; ids are [A-Za-z0-9_.:-], hop a
# small decimal. Anything else is garbled.
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
    None for anything missing or malformed: the caller then starts a
    fresh root trace."""
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
    """Per-stage dwell from a ``[(seq, stage, t), ...]`` transition list:
    stage i dwells ``t[i+1] - t[i]``, the last stage zero, so the values
    sum back to ``t[-1] - t[0]``."""
    out: Dict[str, float] = {}
    for i in range(len(stages) - 1):
        _, stage, t = stages[i]
        nxt_t = stages[i + 1][2]
        out[stage] = out.get(stage, 0.0) + max(0.0, nxt_t - t)
    return out


def durations_partition_latency(timeline: Dict[str, Any],
                                rel_tol: float = 1e-9) -> bool:
    """A closed timeline's stage durations sum to its measured latency
    (within float telescoping noise)."""
    durations = timeline.get("durations") or stage_durations(
        timeline["stages"])
    total = math.fsum(durations.values())
    latency = float(timeline.get("latency_s",
                                 timeline["stages"][-1][2]
                                 - timeline["stages"][0][2]))
    return abs(total - latency) <= rel_tol * max(1.0, abs(latency))


class RequestTraceRecorder:
    """Per-request stage timelines in fixed memory. Purely observational:
    unknown rids are no-ops, nothing raises into the request path, and
    trace and span ids come from a counter."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_closed: int = DEFAULT_TRACE_RING,
                 max_open: int = DEFAULT_MAX_OPEN_TRACES):
        self._clock = clock or RealClock()
        self._max_closed = int(max_closed)
        self._max_open = int(max_open)
        self._lock = threading.Lock()
        self._open: Dict[Any, Dict[str, Any]] = {}
        self._ring: List[Dict[str, Any]] = []
        self._minted = 0
        self.closed = 0          # timelines that reached a terminal stage
        self.dropped = 0         # open entries evicted by the bound
        self.spliced = 0         # closed timelines that recorded a splice
        # per-stage dwell totals over every closed timeline
        self._stage_totals: Dict[str, Dict[str, float]] = {}

    # ---------------------------------------------------------- lifecycle

    def begin(self, rid, lane: str = "interactive",
              parent: Optional[TraceContext] = None) -> TraceContext:
        """Open a timeline at stage ``admitted``. With a ``parent``
        context the new hop joins that trace; otherwise a fresh root
        trace is minted."""
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
                del self._open[next(iter(self._open))]
                self.dropped += 1
            return ctx

    def stage(self, rid, stage: str) -> None:
        """Record a stage transition for ``rid``. Unknown rids and
        same-stage repeats are no-ops; a terminal stage closes the
        timeline into the ring."""
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                return
            stages = entry["stages"]
            if stages[-1][1] == stage:
                return
            stages.append((len(stages), stage, self._clock.now()))
            if stage in TERMINAL_STAGES:
                self._close_locked(rid, entry)

    def token_appended(self, rid) -> None:
        """A token reached the request's client-visible stream. From
        ``prefill`` this is the first-token edge (``first_token`` then
        ``streaming``); from ``splice`` the stream resumes; otherwise a
        no-op, so callers may call it per token."""
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
        self._ring.append(entry)
        if len(self._ring) > self._max_closed:
            self._ring.pop(0)

    def _context_locked(self, entry: Dict[str, Any]) -> TraceContext:
        return TraceContext(trace_id=entry["trace_id"],
                            span_id=entry["span_id"], hop=entry["hop"])

    def _find_locked(self, rid) -> Optional[Dict[str, Any]]:
        entry = self._open.get(rid)
        if entry is None:
            entry = next((e for e in reversed(self._ring)
                          if e["rid"] == rid), None)
        return entry

    # --------------------------------------------------------------- reads

    def context(self, rid) -> Optional[TraceContext]:
        """The trace context to forward to the next hop, or None for an
        unknown rid."""
        with self._lock:
            entry = self._find_locked(rid)
            return None if entry is None else self._context_locked(entry)

    def timeline(self, rid) -> Optional[Dict[str, Any]]:
        """A copy of ``rid``'s timeline, closed (with durations) or open
        (without), or None if never seen or evicted."""
        with self._lock:
            entry = self._find_locked(rid)
            return None if entry is None else _copy_timeline(entry)

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
        """The ``/trace?rid=`` envelope data: one request's timeline with
        durations computed even while open."""
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
    gapless stage seqs, legal transitions, monotone timestamps, exactly
    one terminal stage (the last, required when ``closed``), and for a
    closed timeline stage durations that sum to its latency."""
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
                        f"{', '.join(legal) or 'none, terminal'})")
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
                        f"the measured latency")
    elif terminals != 0:
        msgs.append(f"request {rid}: open timeline already passed a "
                    f"terminal stage")
    return msgs


def _copy_timeline(entry: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(entry)
    out["stages"] = [list(s) for s in entry["stages"]]
    out["self"] = dict(entry["self"])
    if "durations" in entry:
        out["durations"] = dict(entry["durations"])
    return out
