"""The request router: affinity placement and drain-aware handoff.

A port of the JAX package's ``serving/router.py``. One
:class:`RequestRouter` fronts a :class:`~.pool.ReplicaPool` and keeps,
at every tick (``check_invariants``):

- **exactly once**: every submitted request is always in exactly one of
  queued / assigned / completed / shed, and is delivered exactly once,
  across drain handoffs, replica crashes and rolling upgrades;
- **admission legality**: a new request is never placed on a replica
  whose node is cordoned, quarantined or reclaim-tainted;
- **drain before cordon**: the moment a replica's node enters
  ``cordon-required`` (admitted to the upgrade pipeline, the cordon
  imminent but not yet applied) the router stops admitting there,
  stamps :data:`~..wire.DRAIN_INTENT_ANNOTATION`, hands the untouched
  queue to peers and live-migrates the in-flight requests (KV export,
  bounded retry with backoff, adoption on a peer; re-prefill from the
  prompt at degraded priority when every peer refuses).

Placement: session affinity (a ``session`` id pins to its last replica
while that replica admits), shared-prefix affinity (requests opening
with the same prompt head prefer the replica that served it last), then
weighted least outstanding work with backpressure (a replica whose
scraped queue depth reaches ``queue_high`` is skipped). QoS lanes queue
by weighted fair queueing and shed from the lowest lane up.

Everything is clock-injected and the only state is host dicts: the
router adds no device work. It does not step the replicas; their
owner does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from ..core.client import ApiError
from ..utils.clock import Clock, RealClock
from ..wire import (DRAIN_INTENT_ANNOTATION, MIGRATION_INTENT_ANNOTATION,
                    QUARANTINE_LABEL, RECLAIM_TAINT_KEY)
from .pool import DRAIN_STATES, Replica, ReplicaPool

logger = logging.getLogger(__name__)

QUEUED = "queued"
ASSIGNED = "assigned"
COMPLETED = "completed"
# terminal state of a request dropped by overload shedding: never placed
# on a runtime, never delivered — the exactly-once ledger accounts it in
# exactly one of {completed, shed}, never both
SHED = "shed"

# Per-tenant QoS lanes, highest priority first. The SAME table prices
# both sides of the capacity market: the router's demand-side weighted
# fair queueing and overload shedding read it, and the arbiter's
# supply-side exchange rate (the JAX package's market/arbiter.py, not
# yet ported) weighs lane backlog by
# it — so a best-effort flood can neither starve interactive traffic nor
# preempt a training slice the way an interactive burn can.
LANES = ("interactive", "batch", "best-effort")
LANE_WEIGHTS = {"interactive": 4.0, "batch": 2.0, "best-effort": 1.0}
# overload shedding sacrifices lanes in this order; interactive is
# deliberately absent — it is never shed, it is what the market trades
# training capacity to protect
SHED_ORDER = ("best-effort", "batch")
DEFAULT_LANE = "interactive"

# placement priorities: a request re-prefilling from its prompt after a
# failed migration runs `degraded` — it yields placement to normal
# traffic (slower) but is never lost (the exactly-once ledger accounts
# it in exactly one terminal state either way)
NORMAL = "normal"
DEGRADED = "degraded"

# how many head tokens key the shared-prefix affinity map
PREFIX_KEY_TOKENS = 16


@dataclasses.dataclass
class RouterRequest:
    """One request's lifecycle under the router."""

    rid: int
    prompt: Tuple[int, ...]
    max_new: int
    session: Optional[str] = None
    state: str = QUEUED
    replica_id: Optional[str] = None
    local_rid: Optional[int] = None
    tokens: Optional[list] = None
    submitted_t: float = 0.0
    completed_t: Optional[float] = None
    handoffs: int = 0          # times re-placed (drain or crash)
    priority: str = NORMAL     # DEGRADED after a migration fallback
    migrations: int = 0        # successful live KV migrations
    lane: str = DEFAULT_LANE   # QoS lane (LANES member)
    shed_t: Optional[float] = None   # when overload shedding dropped it
    queue_wait_s: Optional[float] = None  # submit -> FIRST placement
    # weighted-fair-queueing finish tag: requests place in tag order, so
    # backlogged lanes interleave in proportion to LANE_WEIGHTS
    wfq_tag: float = 0.0
    # the client-visible token stream: stream[i] is the request's i-th
    # generated token, appended exactly once (gapless, duplicate-free —
    # the router-stream-integrity invariant); stream_log records the
    # (seq, replica id) provenance of every append, so a spliced stream
    # is auditable across migrations and failovers
    stream: list = dataclasses.field(default_factory=list)
    stream_log: list = dataclasses.field(default_factory=list)
    # tokens a re-prefilling runtime will re-emit that the client has
    # already seen: the splice point of the fallback path. The router
    # swallows exactly this many incoming tokens (verifying each equals
    # what was already streamed — greedy decode is deterministic)
    replay_skip: int = 0

    @property
    def prefix_key(self) -> Tuple[int, ...]:
        return self.prompt[:PREFIX_KEY_TOKENS]


class RequestRouter:
    def __init__(self, pool: ReplicaPool, metrics=None,
                 clock: Optional[Clock] = None, queue_high: float = 8.0,
                 transfer_retries: int = 3,
                 transfer_backoff_s: float = 0.25,
                 transfer_backoff_cap_s: float = 2.0,
                 shed_high: Optional[float] = None,
                 reqtrace=None):
        self.pool = pool
        self._metrics = metrics
        self._clock = clock or RealClock()
        # optional request flight recorder (obs/reqtrace.py): purely
        # observational stage-timeline hooks at every lifecycle edge;
        # None keeps the router untraced
        self.reqtrace = reqtrace
        self.queue_high = float(queue_high)
        # live-migration transfer budget: total adoption attempts per
        # request across peers, with exponential backoff (clock-injected:
        # a fake clock models multi-second backoffs for free)
        self.transfer_retries = int(transfer_retries)
        self.transfer_backoff_s = float(transfer_backoff_s)
        self.transfer_backoff_cap_s = float(transfer_backoff_cap_s)
        # fault hook: fn(donor, peer) called before every KV transfer;
        # raising models a failed or flaky payload transfer
        self.transfer_gate = None
        # overload shedding: while more than ``shed_high`` requests are
        # queued after placement, the backlog sheds from the lowest
        # priority lane up (SHED_ORDER; interactive never sheds). None =
        # shedding off — requests queue without bound, the pre-lane
        # behavior
        self.shed_high = None if shed_high is None else float(shed_high)
        self.requests: Dict[int, RouterRequest] = {}
        self._next_rid = 0
        self._queue: List[int] = []                 # queued rids
        # weighted fair queueing state: per-lane virtual finish time and
        # the served virtual clock (advances as queued work places)
        self._lane_vtime: Dict[str, float] = {lane: 0.0 for lane in LANES}
        self._vclock = 0.0
        self._lane_shed: Dict[str, int] = {lane: 0 for lane in LANES}
        self._lane_completed: Dict[str, int] = {lane: 0 for lane in LANES}
        self._local2global: Dict[Tuple[str, int], int] = {}
        self._session_map: Dict[str, str] = {}      # session -> replica id
        self._prefix_map: Dict[Tuple[int, ...], str] = {}
        # per-tick admission log the invariants check: (rid, replica id,
        # node name) for every placement made in the LAST tick()
        self.assignments_this_tick: List[Tuple[int, str, str]] = []
        # rid -> delivery count; anything above 1 is a double-serve
        self.completed_counts: Dict[int, int] = {}
        # (replica id, node, reason, node-was-schedulable) per drain
        self.drains: List[Tuple[str, str, str, bool]] = []
        self._routed = 0
        self._rerouted = 0
        self.migration_attempts = 0
        self.migration_successes = 0
        self.migration_fallbacks = 0
        # splice-verification failures (a replayed token differing from
        # what the client already saw) — surfaced by the
        # router-stream-integrity invariant the tick they appear
        self.stream_violations: List[str] = []

    # ------------------------------------------------------------ submit

    def submit(self, prompt, max_new: int,
               session: Optional[str] = None,
               lane: str = DEFAULT_LANE) -> int:
        """Accept a request on a QoS ``lane``; it places immediately
        when a replica has headroom, otherwise queues (weighted-fair
        across lanes) until :meth:`tick` finds one."""
        if lane not in LANES:
            raise ValueError(f"unknown QoS lane {lane!r} "
                             f"(known: {', '.join(LANES)})")
        rid = self._next_rid
        self._next_rid += 1
        req = RouterRequest(rid=rid,
                            prompt=tuple(int(t) for t in prompt),
                            max_new=int(max_new), session=session,
                            lane=lane,
                            submitted_t=self._clock.now())
        # classic WFQ finish tag: a lane's next request finishes 1/weight
        # virtual seconds after the later of its lane's previous finish
        # and the served virtual clock — backlogged lanes interleave in
        # weight proportion, an idle lane accumulates no credit
        tag = max(self._lane_vtime[lane], self._vclock) \
            + 1.0 / LANE_WEIGHTS[lane]
        self._lane_vtime[lane] = tag
        req.wfq_tag = tag
        self.requests[rid] = req
        self._queue.append(rid)
        if self.reqtrace is not None:
            self.reqtrace.begin(rid, lane=lane)
            self.reqtrace.stage(rid, "queued")
        self._place_queued()
        return rid

    def result(self, rid: int):
        """Completed tokens for ``rid`` (None while in flight)."""
        req = self.requests[rid]
        return req.tokens if req.state == COMPLETED else None

    def stream(self, rid: int) -> List[int]:
        """The request's client-visible token stream so far —
        ``stream[i]`` is generated token i, spliced gaplessly across any
        migrations and failovers the request survived."""
        return list(self.requests[rid].stream)

    @property
    def outstanding(self) -> int:
        return sum(1 for r in self.requests.values()
                   if r.state not in (COMPLETED, SHED))

    def lane_depths(self) -> Dict[str, int]:
        """Currently queued requests per QoS lane — the demand signal
        a capacity arbiter prices."""
        out = {lane: 0 for lane in LANES}
        for rid in self._queue:
            req = self.requests[rid]
            if req.state == QUEUED:
                out[req.lane] += 1
        return out

    def lane_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-lane {queued, shed, completed} counters."""
        depths = self.lane_depths()
        return {lane: {"queued": depths[lane],
                       "shed": self._lane_shed[lane],
                       "completed": self._lane_completed[lane]}
                for lane in LANES}

    def admitting_count(self) -> int:
        return len(self.pool.admitting())

    # ------------------------------------------------------------- tick

    def tick(self) -> None:
        """One reconcile tick: refresh cluster views, watch for drains,
        collect completions, re-place handed-off work, update gauges."""
        self.assignments_this_tick = []
        self.pool.refresh_nodes()
        self.pool.scrape()
        self._watch_drains()
        self._collect_failures()
        self._collect_streams()
        self._collect_completions()
        self._place_queued()
        self._shed_overload()
        self._mark_drained()
        self._update_gauges()

    # ------------------------------------------------------------ drains

    def _drain_reason(self, replica: Replica) -> Optional[str]:
        state = self.pool.node_states.get(replica.node_name)
        if state is None or not state.known:
            return None
        if state.quarantined:
            return "quarantined"
        if state.reclaim_tainted:
            return "reclaim"
        if state.state_label in DRAIN_STATES:
            return f"upgrade:{state.state_label}"
        if not state.schedulable:
            return "cordoned"
        return None

    def _watch_drains(self) -> None:
        for replica in self.pool.live():
            if replica.draining:
                continue
            reason = self._drain_reason(replica)
            if reason is None and replica.stats.draining:
                # the replica began draining on its own (pod-side SIGTERM
                # watcher, or an operator outside this router) — follow it
                reason = "replica-initiated"
            if reason is not None:
                self.drain_replica(replica, reason)

    def drain_replica(self, replica: Replica, reason: str) -> None:
        """Stop admitting to ``replica``, persist the intent, migrate
        its untouched queue to peers, and LIVE-MIGRATE its in-flight
        requests: each one's KV state is exported at a step boundary,
        transferred to a chosen peer under the bounded retry/backoff
        budget, and adopted there so its token stream resumes from the
        last acked sequence number — the client never sees a disconnect
        or a duplicated/skipped token.
        A transfer that exhausts the budget, or a peer that rejects
        adoption, falls back to re-prefill-from-prompt at ``degraded``
        priority — slower, never lost. Runtimes without the migration
        surface (the HTTP adapter) keep the legacy behavior: in-flight
        requests finish on the drainer."""
        if replica.draining:
            return
        state = self.pool.node_states.get(replica.node_name)
        schedulable_at_drain = state.schedulable if (
            state is not None and state.known) else True
        replica.draining = True
        replica.drain_reason = reason
        self.drains.append((replica.id, replica.node_name, reason,
                            schedulable_at_drain))
        if self.pool.client is not None:
            try:
                self.pool.client.patch_node_metadata(
                    replica.node_name, annotations={
                        DRAIN_INTENT_ANNOTATION:
                            f"{reason}@{self._clock.wall():.3f}"})
            except (ApiError, TimeoutError):
                logger.warning("could not stamp drain intent on %s",
                               replica.node_name, exc_info=True)
        try:
            replica.runtime.drain()
            handoff = replica.runtime.handoff()
        except Exception:  # exc: allow — a crashed runtime mid-drain is failed; its queue re-prefills on peers
            logger.exception("drain of replica %s failed; treating its "
                             "runtime as crashed", replica.id)
            replica.failed = True
            handoff = []
        migrated = 0
        for local_rid, _prompt, _max_new in handoff:
            rid = self._local2global.pop((replica.id, local_rid), None)
            if rid is None:
                continue
            self._requeue(rid)
            migrated += 1
        if self._metrics is not None:
            self._metrics.observe("handoff_requests", migrated,
                                  buckets=_depth_buckets())
        logger.info("draining replica %s on %s (%s): %d queued requests "
                    "migrated to peers", replica.id, replica.node_name,
                    reason, migrated)
        if not replica.failed:
            self._migrate_in_flight(replica)

    # ------------------------------------------------- live KV migration

    def _assigned_to(self, replica: Replica) -> List[int]:
        return [rid for rid, req in self.requests.items()
                if req.state == ASSIGNED and req.replica_id == replica.id]

    def _migrate_in_flight(self, replica: Replica) -> None:
        """Move every in-flight request off a draining donor via KV
        export/adopt. Streams were last collected on the previous tick —
        export quiesces the slot at a step boundary, and the payload's
        ``generated`` cursor carries any not-yet-collected tokens, so
        :meth:`_collect_streams` resumes gaplessly on the peer."""
        runtime = replica.runtime
        if not hasattr(runtime, "export_slot"):
            return      # legacy runtime: in-flight finishes on the drainer
        rids = self._assigned_to(replica)
        if not rids:
            return
        if self.pool.client is not None:
            try:
                self.pool.client.patch_node_metadata(
                    replica.node_name, annotations={
                        MIGRATION_INTENT_ANNOTATION:
                            f"{len(rids)}@{self._clock.wall():.3f}"})
            except (ApiError, TimeoutError):
                logger.warning("could not stamp migration intent on %s",
                               replica.node_name, exc_info=True)
        for rid in rids:
            req = self.requests[rid]
            if self.reqtrace is not None:
                self.reqtrace.stage(rid, "drain")
            # sync the client stream to the donor's cursor BEFORE the
            # export freezes the slot (tokens decoded since last tick)
            try:
                self._drain_stream_of(replica, req)
                payload = runtime.export_slot(req.local_rid)
            except KeyError:
                continue    # finished between the drain and the export
            except Exception:  # exc: allow — an export failure of any shape falls back to re-prefill from prompt
                logger.exception("export of request %d from replica %s "
                                 "failed; falling back to re-prefill",
                                 rid, replica.id)
                self._local2global.pop((replica.id, req.local_rid), None)
                self._fallback(rid)
                continue
            self._local2global.pop((replica.id, req.local_rid), None)
            if self.reqtrace is not None:
                self.reqtrace.stage(rid, "export")
            if not self._transfer(rid, req, payload, donor=replica):
                self._fallback(rid)

    def _drain_stream_of(self, replica: Replica, req: RouterRequest
                         ) -> None:
        """Collect any tokens the donor generated for ``req`` since the
        last tick, so the export's splice point equals the client's
        acked sequence number."""
        if not hasattr(replica.runtime, "poll_stream"):
            return
        for local_rid, toks in replica.runtime.poll_stream().items():
            rid = self._local2global.get((replica.id, local_rid))
            if rid is not None:
                self._append_stream(self.requests[rid], toks, replica.id)

    def _transfer(self, rid: int, req: RouterRequest, payload: dict,
                  donor: Replica) -> bool:
        """Bounded retry/backoff transfer of one migration payload to
        the best adoptable peer. A raised :attr:`transfer_gate` (a
        flaky transfer) is transient — the same peer may be
        retried after backoff; a peer REJECTING adoption (version
        mismatch, no free pages) is deterministic — that peer is
        excluded. Returns True once a peer adopted."""
        rejected = set()
        attempts = 0
        nbytes = _payload_nbytes(payload)
        if self.reqtrace is not None:
            self.reqtrace.stage(rid, "transfer")
        while attempts < self.transfer_retries:
            peers = [r for r in self.pool.admitting()
                     if r.id != donor.id and r.id not in rejected
                     and hasattr(r.runtime, "adopt_slot")]
            if not peers:
                break
            peer = min(peers, key=lambda r: (
                (self._outstanding_on(r) + r.stats.queue_depth)
                / r.weight))
            attempts += 1
            self.migration_attempts += 1
            t0 = self._clock.now()
            try:
                if self.transfer_gate is not None:
                    self.transfer_gate(donor, peer)
            except Exception:  # exc: allow — transfer-gate failures retry under the bounded backoff budget
                logger.warning(
                    "KV transfer of request %d to %s failed (attempt "
                    "%d/%d); backing off", rid, peer.id, attempts,
                    self.transfer_retries)
                self._backoff(attempts)
                continue
            try:
                local = peer.runtime.adopt_slot(payload)
            except Exception:  # exc: allow — an adoption failure of any shape just tries the next peer
                logger.warning(
                    "peer %s rejected adoption of request %d; trying "
                    "the next peer", peer.id, rid, exc_info=True)
                rejected.add(peer.id)
                self._backoff(attempts)
                continue
            req.replica_id = peer.id
            req.local_rid = local
            req.migrations += 1
            if self.reqtrace is not None:
                self.reqtrace.stage(rid, "adopt")
                self.reqtrace.stage(rid, "splice")
            self._local2global[(peer.id, local)] = rid
            if req.session is not None:
                self._session_map[req.session] = peer.id
            self.migration_successes += 1
            if self._metrics is not None:
                self._metrics.observe(
                    "migration_transfer_seconds",
                    max(0.0, self._clock.now() - t0))
                self._metrics.observe("migration_transfer_bytes", nbytes,
                                      buckets=_transfer_buckets())
            logger.info("migrated request %d (%d tokens in) %s -> %s",
                        rid, len(req.stream), donor.id, peer.id)
            return True
        return False

    def _backoff(self, attempt: int) -> None:
        self._clock.sleep(min(self.transfer_backoff_cap_s,
                              self.transfer_backoff_s
                              * (2.0 ** (attempt - 1))))

    def _fallback(self, rid: int) -> None:
        """Migration exhausted its budget: the request re-prefills from
        its prompt on whichever peer the queue places it, at DEGRADED
        priority. The re-decode re-emits tokens the client already saw;
        ``replay_skip`` makes :meth:`_collect_streams` swallow exactly
        those (verifying each — greedy decode is deterministic), so the
        client stream resumes from the last acked sequence number."""
        req = self.requests[rid]
        req.priority = DEGRADED
        req.replay_skip = len(req.stream)
        self.migration_fallbacks += 1
        if self.reqtrace is not None:
            self.reqtrace.stage(rid, "fallback")
        self._requeue(rid)
        logger.warning("request %d falls back to re-prefill at degraded "
                       "priority (%d tokens already streamed)", rid,
                       len(req.stream))

    def _mark_drained(self) -> None:
        for replica in self.pool.live():
            if replica.draining and not replica.drained:
                try:
                    if replica.runtime.idle:
                        replica.drained = True
                except Exception:  # exc: allow — a dead runtime surface marks the replica failed
                    replica.failed = True

    # ---------------------------------------------------------- failures

    def _collect_failures(self) -> None:
        """A crashed replica loses its in-flight work — those requests
        were never delivered, so they re-place on peers (a re-decode, not
        a double-serve: greedy decoding is deterministic and the dead
        runtime can never deliver its copy)."""
        for replica in self.pool.replicas.values():
            alive = True
            try:
                alive = replica.runtime.alive()
            except Exception:  # exc: allow — an unreachable liveness surface counts as dead (conservative)
                alive = False
            if alive and not replica.stats.failed:
                continue
            if not replica.failed:
                replica.failed = True
                logger.warning("replica %s on %s failed; re-placing its "
                               "in-flight requests", replica.id,
                               replica.node_name)
            for rid, req in self.requests.items():
                if req.state == ASSIGNED and req.replica_id == replica.id:
                    self._local2global.pop((replica.id, req.local_rid),
                                           None)
                    # the re-decode on a peer replays tokens the client
                    # already saw — splice at the last acked seq number
                    req.replay_skip = len(req.stream)
                    self._requeue(rid)

    def _requeue(self, rid: int) -> None:
        req = self.requests[rid]
        req.state = QUEUED
        req.replica_id = None
        req.local_rid = None
        req.handoffs += 1
        self._rerouted += 1
        self._queue.append(rid)
        if self.reqtrace is not None:
            self.reqtrace.stage(rid, "queued")

    # --------------------------------------------------------- streaming

    def _append_stream(self, req: RouterRequest, tokens, replica_id: str
                       ) -> None:
        """Splice newly generated tokens onto the request's client
        stream. While ``replay_skip`` is positive the incoming tokens
        re-play what the client already saw (a fallback re-prefill) —
        each is verified against the streamed copy and swallowed, so
        sequence numbers stay gapless and duplicate-free."""
        for tok in tokens:
            tok = int(tok)
            if req.replay_skip > 0:
                idx = len(req.stream) - req.replay_skip
                if req.stream[idx] != tok:
                    self.stream_violations.append(
                        f"request {req.rid}: replayed token at seq {idx}"
                        f" is {tok}, client already saw "
                        f"{req.stream[idx]} (replica {replica_id})")
                req.replay_skip -= 1
                continue
            req.stream_log.append((len(req.stream), replica_id))
            req.stream.append(tok)
            if self.reqtrace is not None:
                self.reqtrace.token_appended(req.rid)

    def _collect_streams(self) -> None:
        """Pull every streaming runtime's new tokens and splice them
        into the per-request client streams (sequence numbers = stream
        indexes, gapless across migrations and failovers)."""
        for replica in self.pool.replicas.values():
            if replica.failed or not hasattr(replica.runtime,
                                             "poll_stream"):
                continue
            try:
                chunks = replica.runtime.poll_stream()
            except Exception:  # exc: allow — a failing stream poll fails the replica; its requests migrate
                replica.failed = True
                continue
            for local_rid, toks in chunks.items():
                rid = self._local2global.get((replica.id, local_rid))
                if rid is None:
                    continue
                self._append_stream(self.requests[rid], toks, replica.id)

    # ------------------------------------------------------- completions

    def _collect_completions(self) -> None:
        for replica in self.pool.replicas.values():
            if replica.failed:
                continue
            try:
                done = replica.runtime.poll()
            except Exception:  # exc: allow — a failing completion poll fails the replica; its requests migrate
                replica.failed = True
                continue
            for local_rid, tokens in done.items():
                rid = self._local2global.pop((replica.id, local_rid),
                                             None)
                if rid is None:
                    continue
                req = self.requests[rid]
                self.completed_counts[rid] = \
                    self.completed_counts.get(rid, 0) + 1
                if req.state == COMPLETED:
                    # double-serve: keep the first result, leave the
                    # count > 1 for the invariant to flag
                    continue
                req.state = COMPLETED
                req.tokens = [int(t) for t in tokens]
                req.completed_t = self._clock.now()
                self._lane_completed[req.lane] += 1
                if self.reqtrace is not None:
                    self.reqtrace.stage(rid, "completed")

    # --------------------------------------------------------- placement

    def _candidates(self) -> List[Replica]:
        admitting = self.pool.admitting()
        roomy = [r for r in admitting
                 if r.stats.stale or r.stats.queue_depth < self.queue_high]
        return roomy or []

    def _outstanding_on(self, replica: Replica) -> int:
        return sum(1 for r in self.requests.values()
                   if r.state == ASSIGNED and r.replica_id == replica.id)

    def _pick(self, req: RouterRequest) -> Optional[Replica]:
        # a lane-dedicated replica (Replica.lane, mirrored to the
        # cluster as the LANE_LABEL) only serves its own lane — reserved
        # capacity a flood on the other lanes cannot touch
        candidates = [r for r in self._candidates()
                      if getattr(r, "lane", None) in (None, req.lane)]
        if not candidates:
            return None
        by_id = {r.id: r for r in candidates}
        if req.session is not None:
            sticky = self._session_map.get(req.session)
            if sticky in by_id:
                return by_id[sticky]
        warm = self._prefix_map.get(req.prefix_key)
        if warm in by_id:
            return by_id[warm]
        # weighted least outstanding work; ties break on registration
        # order (the candidates list preserves pool insertion order)
        return min(candidates,
                   key=lambda r: ((self._outstanding_on(r)
                                   + r.stats.queue_depth) / r.weight))

    def _place_queued(self) -> None:
        remaining: List[int] = []
        # degraded requests (migration fallbacks) yield placement to
        # normal traffic: slower, never lost. Within a priority class,
        # weighted fair queueing across QoS lanes: place in WFQ finish-
        # tag order (interactive drains ~4x as fast as best-effort when
        # both are backlogged), ties broken by arrival (the rid).
        ordered = sorted(self._queue, key=lambda r: (
            self.requests[r].priority == DEGRADED,
            self.requests[r].wfq_tag, r))
        for rid in ordered:
            req = self.requests[rid]
            if req.state != QUEUED:
                continue        # completed/assigned through another path
            if self.reqtrace is not None:
                with self.reqtrace.timer(rid, "route"):
                    target = self._pick(req)
            else:
                target = self._pick(req)
            if target is None:
                remaining.append(rid)
                continue
            try:
                local = target.runtime.submit(list(req.prompt),
                                              req.max_new)
            except Exception:  # exc: allow — a refused submit requeues the request and stops picking the replica this tick
                logger.warning("submit to replica %s refused; requeueing",
                               target.id, exc_info=True)
                target.stats.draining = True   # stop picking it this tick
                remaining.append(rid)
                continue
            req.state = ASSIGNED
            req.replica_id = target.id
            req.local_rid = local
            if self.reqtrace is not None:
                self.reqtrace.stage(rid, "assigned")
                self.reqtrace.stage(rid, "prefill")
            self._vclock = max(self._vclock, req.wfq_tag)
            self._local2global[(target.id, local)] = rid
            self.assignments_this_tick.append(
                (rid, target.id, target.node_name))
            if req.session is not None:
                self._session_map[req.session] = target.id
            self._prefix_map[req.prefix_key] = target.id
            if req.handoffs == 0:
                self._routed += 1
                req.queue_wait_s = max(
                    0.0, self._clock.now() - req.submitted_t)
                if self._metrics is not None:
                    self._metrics.observe("lane_queue_wait_seconds",
                                          req.queue_wait_s,
                                          labels={"lane": req.lane})
        self._queue = remaining

    # ---------------------------------------------------------- shedding

    def _shed_overload(self) -> None:
        """Overload degrades by policy, not by accident: while more than
        ``shed_high`` requests remain queued after placement, drop the
        excess from the LOWEST priority lane up (``SHED_ORDER`` —
        best-effort first, then batch; interactive is never shed).
        Within a lane the newest requests shed first: the oldest have
        waited longest and are next in line for a slot. A shed request
        is terminal — never placed, never delivered — and is reported to
        its submitter through :meth:`result` raising/None semantics plus
        the per-lane shed counters."""
        if self.shed_high is None:
            return
        excess = len(self._queue) - int(self.shed_high)
        if excess <= 0:
            return
        for lane in SHED_ORDER:
            if excess <= 0:
                break
            victims = [rid for rid in self._queue
                       if self.requests[rid].state == QUEUED
                       and self.requests[rid].lane == lane]
            for rid in reversed(victims):      # newest first
                if excess <= 0:
                    break
                req = self.requests[rid]
                req.state = SHED
                req.shed_t = self._clock.now()
                self._queue.remove(rid)
                self._lane_shed[lane] += 1
                if self.reqtrace is not None:
                    self.reqtrace.stage(rid, "shed")
                excess -= 1
                logger.warning("overload: shed request %d (lane %s, "
                               "%d queued > shed_high %g)", rid, lane,
                               len(self._queue) + 1, self.shed_high)

    # ------------------------------------------------------------ gauges

    def _update_gauges(self) -> None:
        if self._metrics is None:
            return
        live = self.pool.live()
        self._metrics.set_gauge("replicas", len(self.pool.replicas))
        self._metrics.set_gauge("replicas_admitting",
                                len(self.pool.admitting()))
        self._metrics.set_gauge("replicas_draining",
                                sum(1 for r in live if r.draining))
        self._metrics.set_gauge(
            "replicas_failed",
            sum(1 for r in self.pool.replicas.values() if r.failed))
        self._metrics.set_gauge("queue_depth", len(self._queue))
        self._metrics.set_gauge("outstanding_requests", self.outstanding)
        self._metrics.set_gauge("requests_routed", self._routed)
        self._metrics.set_gauge(
            "requests_completed",
            sum(1 for r in self.requests.values()
                if r.state == COMPLETED))
        self._metrics.set_gauge("requests_rerouted", self._rerouted)
        self._metrics.set_gauge("migration_attempts",
                                self.migration_attempts)
        self._metrics.set_gauge("migration_success",
                                self.migration_successes)
        self._metrics.set_gauge("migration_fallbacks",
                                self.migration_fallbacks)
        depths = self.lane_depths()
        for lane in LANES:
            labels = {"lane": lane}
            self._metrics.set_gauge("lane_queue_depth", depths[lane],
                                    labels=labels)
            self._metrics.set_gauge("lane_shed", self._lane_shed[lane],
                                    labels=labels)
            self._metrics.set_gauge("lane_completed",
                                    self._lane_completed[lane],
                                    labels=labels)

    # --------------------------------------------------------- invariants

    def check_invariants(self, nodes=None) -> List[str]:
        """The two standing router invariants, as violation strings
        (empty = clean). ``nodes`` (optional ``{name: Node}``) lets the
        caller check this tick's admissions against cluster truth."""
        out: List[str] = []
        out.extend(self.stream_violations)
        for rid, count in self.completed_counts.items():
            if count > 1:
                out.append(f"request {rid} delivered {count} times "
                           f"(double-serve)")
        for rid, req in self.requests.items():
            for i, (seq, _replica) in enumerate(req.stream_log):
                if seq != i:
                    out.append(f"request {rid} stream seq {seq} at "
                               f"position {i} (gap or duplicate)")
                    break
            if req.state == COMPLETED and req.tokens is not None:
                tail = [int(t) for t in req.tokens[len(req.prompt):]]
                if req.stream and req.stream != tail:
                    out.append(f"request {rid} stream diverged from its "
                               f"delivered result after "
                               f"{req.migrations} migration(s)")
        for rid, req in self.requests.items():
            if req.state not in (QUEUED, ASSIGNED, COMPLETED, SHED):
                out.append(f"request {rid} in unknown state {req.state!r}"
                           f" (lost)")
            if req.state == SHED:
                if req.lane not in SHED_ORDER:
                    out.append(f"request {rid} on protected lane "
                               f"{req.lane!r} was shed (policy: only "
                               f"{', '.join(SHED_ORDER)} shed)")
                if self.completed_counts.get(rid):
                    out.append(f"request {rid} both shed and delivered "
                               f"({self.completed_counts[rid]}x)")
            if req.state == ASSIGNED:
                replica = self.pool.replicas.get(req.replica_id)
                if replica is None or replica.failed:
                    out.append(f"request {rid} assigned to dead replica "
                               f"{req.replica_id} (lost)")
        if nodes is not None:
            for rid, replica_id, node_name in self.assignments_this_tick:
                node = nodes.get(node_name)
                if node is None:
                    continue
                if node.spec.unschedulable:
                    out.append(f"request {rid} admitted to CORDONED node "
                               f"{node_name} (replica {replica_id})")
                elif QUARANTINE_LABEL in node.metadata.labels:
                    out.append(f"request {rid} admitted to QUARANTINED "
                               f"node {node_name}")
                elif any(t.key == RECLAIM_TAINT_KEY
                         for t in node.spec.taints):
                    out.append(f"request {rid} admitted to reclaim-"
                               f"tainted node {node_name}")
        return out


def _depth_buckets():
    from ..obs.metrics import QUEUE_DEPTH_BUCKETS
    return QUEUE_DEPTH_BUCKETS


def _transfer_buckets():
    from ..obs.metrics import TRANSFER_BYTES_BUCKETS
    return TRANSFER_BYTES_BUCKETS


def _payload_nbytes(payload: dict) -> int:
    """Transfer size of a migration payload: the KV arrays for a
    batcher payload (``models/paged.py:kv_payload_nbytes``), a
    token-count proxy for the sim payloads."""
    kv = payload.get("kv")
    if kv is not None:
        from ..models.paged import kv_payload_nbytes
        return kv_payload_nbytes(kv)
    return 4 * (len(payload.get("generated", ()))
                + len(payload.get("prompt", ())))
