"""SLO-driven autoscaling for the router tier.

A port of the JAX package's ``serving/autoscaler.py``:

- **scale up** when the SLO engine's fastest (page-severity) burn-rate
  pair for the serving TTFT objective triggers (long AND short window
  both burning past their factor), or when the mean scraped queue depth
  per admitting replica exceeds ``queue_high`` (backpressure before
  latency shows);
- **scale down** when the fleet has been SUSTAINED idle (slot occupancy
  at most ``idle_occupancy`` with an empty router queue for
  ``idle_seconds``), never below ``min_replicas``.

Hysteresis: one decision per ``cooldown_seconds``, and the idle timer
resets on any activity, so a bursty workload cannot flap the fleet.

Every collaborator is duck-typed and optional. ``slo_engine`` has a
``last`` dict of objective statuses (``obs/slo.py:SLOEngine``, the
operator's), ``scheduler`` a
``place(workload, prefer=)`` (the JAX package's slice scheduler's
surface; this package's ``gpu/scheduler.py`` takes no ``prefer`` yet),
``market`` a ``leased_slice_ids()``.
A scale-up hands the placement to ``replica_factory`` to stand the
runtime up; a scale-down drains the emptiest replica through the router
(zero-loss handoff) and releases it once idle. Every decision is
journaled as a Kubernetes Event (``RouterScaleUp`` / ``RouterScaleDown``
/ ``RouterScaleUpFailed``) and mirrored in the ``tpu_router_scale_*``
gauges.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

from ..utils.clock import Clock, RealClock
from .pool import Replica, ReplicaPool
from .router import RequestRouter

logger = logging.getLogger(__name__)

SCALE_UP_REASON = "RouterScaleUp"
SCALE_DOWN_REASON = "RouterScaleDown"
SCALE_UP_FAILED_REASON = "RouterScaleUpFailed"


class _RouterMeta:
    def __init__(self, name: str):
        self.name = name


class _RouterObject:
    """Event anchor: scale decisions have no node to attach to, so the
    Event's involved object is a synthetic ``ServingRouter/<name>``."""

    kind = "ServingRouter"

    def __init__(self, name: str = "router"):
        self.metadata = _RouterMeta(name)


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    queue_high: float = 4.0        # mean queued per admitting replica
    idle_occupancy: float = 0.10   # busy-slot fraction counting as idle
    idle_seconds: float = 300.0    # sustained idle before a scale-down
    cooldown_seconds: float = 120.0
    slo_name: str = "serving-ttft-p99"


class Autoscaler:
    """Reconcile-tick autoscaler. ``slo_engine`` has an SLO engine's
    ``last`` evaluation (read, not re-evaluated: the operator loop
    evaluates once per tick); ``scheduler``/``workload_template`` place
    new slices; ``replica_factory(placement) -> Replica`` stands the
    runtime up; ``release(replica)`` tears a drained scale-down replica
    back down. Each hook is optional: without a factory the decision
    still fires, journals and gauges (a dry run)."""

    def __init__(self, pool: ReplicaPool, router: RequestRouter,
                 slo_engine=None, scheduler=None, workload_template=None,
                 replica_factory: Optional[Callable] = None,
                 release: Optional[Callable[[Replica], None]] = None,
                 recorder=None, metrics=None,
                 clock: Optional[Clock] = None,
                 config: Optional[AutoscalerConfig] = None,
                 market=None):
        self.pool = pool
        self.router = router
        self.slo_engine = slo_engine
        # the capacity market's supply side (duck-typed to
        # ``leased_slice_ids() -> set``): scale-up placement prefers
        # slices the arbiter traded away from training
        self.market = market
        self.scheduler = scheduler
        self.workload_template = workload_template
        self.replica_factory = replica_factory
        self.release = release
        self._recorder = recorder
        self._metrics = metrics
        self._clock = clock or RealClock()
        self.config = config or AutoscalerConfig()
        self._idle_since: Optional[float] = None
        self._last_decision_t: Optional[float] = None
        self._placements = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_decision: Optional[dict] = None

    # ------------------------------------------------------------ signals

    def _burn_reason(self) -> Optional[str]:
        if self.slo_engine is None:
            return None
        status = (self.slo_engine.last or {}).get(self.config.slo_name)
        if not status:
            return None
        for pair in status.get("burn") or []:
            if pair.get("triggered") and pair.get("severity") == "page":
                return (f"slo {self.config.slo_name} burning "
                        f"{pair['long_rate']:.1f}x/{pair['long']} + "
                        f"{pair['short_rate']:.1f}x/{pair['short']} "
                        f"(threshold {pair['factor']}x)")
        return None

    def _queue_reason(self) -> Optional[str]:
        admitting = self.pool.admitting()
        if not admitting:
            return None
        depth = (sum(r.stats.queue_depth for r in admitting)
                 + len(self.router._queue)) / len(admitting)
        if depth > self.config.queue_high:
            return (f"mean queue depth {depth:.1f}/replica > "
                    f"{self.config.queue_high:g}")
        return None

    def _occupancy(self) -> Optional[float]:
        admitting = self.pool.admitting()
        total = sum(r.stats.slots_total for r in admitting)
        if total <= 0:
            return None
        return sum(r.stats.slots_busy for r in admitting) / total

    def _cooldown_ok(self) -> bool:
        return (self._last_decision_t is None
                or self._clock.now() - self._last_decision_t
                >= self.config.cooldown_seconds)

    # --------------------------------------------------------------- tick

    def tick(self) -> Optional[dict]:
        """One reconcile tick; returns the decision dict when one fired
        ({"action", "reason", ...}) else None."""
        cfg = self.config
        live = self.pool.live()
        decision = None

        up_reason = self._burn_reason() or self._queue_reason()
        occupancy = self._occupancy()
        busy = (up_reason is not None or len(self.router._queue) > 0
                or (occupancy is not None
                    and occupancy > cfg.idle_occupancy))
        now = self._clock.now()
        if busy:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        if up_reason and len(live) < cfg.max_replicas and \
                self._cooldown_ok():
            decision = self._scale_up(up_reason)
        elif (not busy and self._idle_since is not None
              and now - self._idle_since >= cfg.idle_seconds
              and len(live) > cfg.min_replicas and self._cooldown_ok()):
            decision = self._scale_down(
                f"idle {now - self._idle_since:.0f}s (occupancy "
                f"{0.0 if occupancy is None else occupancy:.2f})")
        self._release_drained()
        if self._metrics is not None:
            self._metrics.set_gauge("scale_target", self._target())
            self._metrics.set_gauge("scale_ups", self.scale_ups)
            self._metrics.set_gauge("scale_downs", self.scale_downs)
        if decision is not None:
            self.last_decision = decision
        return decision

    def _target(self) -> int:
        return max(self.config.min_replicas,
                   min(self.config.max_replicas, len(self.pool.live())))

    # ------------------------------------------------------------ scaling

    def _scale_up(self, reason: str) -> dict:
        placement = None
        if self.scheduler is not None and self.workload_template is not None:
            self._placements += 1
            workload = dataclasses.replace(
                self.workload_template,
                name=f"{self.workload_template.name}-{self._placements}")
            leased = set()
            if self.market is not None:
                try:
                    leased = set(self.market.leased_slice_ids())
                except Exception:  # exc: allow — the market surface is advisory; place without preference when it fails
                    logger.warning("market lease lookup failed; placing "
                                   "without preference", exc_info=True)
            try:
                placement = self.scheduler.place(
                    workload,
                    prefer=(leased.__contains__ if leased else None))
            except Exception:  # exc: allow — scale-up isolation: a scheduler failure reads as no placement this tick
                logger.exception("scale-up slice placement raised")
                placement = None
            if placement is None:
                self._event("Warning", SCALE_UP_FAILED_REASON,
                            f"scale-up wanted ({reason}) but no eligible "
                            f"slice accepted workload {workload.name}")
                self._last_decision_t = self._clock.now()
                return {"action": "scale-up-failed", "reason": reason}
        replica = None
        if self.replica_factory is not None:
            try:
                replica = self.replica_factory(placement)
            except Exception:  # exc: allow — the replica factory is a tenant callback; on failure the slice serves pool-less
                logger.exception("replica factory failed on scale-up")
        if replica is not None:
            self.pool.register(replica)
        self.scale_ups += 1
        self._last_decision_t = self._clock.now()
        self._event("Normal", SCALE_UP_REASON,
                    f"scaling serving fleet up to "
                    f"{len(self.pool.live())} replicas: {reason}")
        return {"action": "scale-up", "reason": reason,
                "replica": None if replica is None else replica.id,
                "placement": placement}

    def _scale_down(self, reason: str) -> dict:
        admitting = self.pool.admitting()
        if not admitting:
            return {"action": "noop", "reason": "no admitting replica"}
        victim = min(admitting,
                     key=lambda r: (self.router._outstanding_on(r)
                                    + r.stats.queue_depth))
        victim.scale_down = True
        self.router.drain_replica(victim, "scale-down")
        self.scale_downs += 1
        self._last_decision_t = self._clock.now()
        self._event("Normal", SCALE_DOWN_REASON,
                    f"draining replica {victim.id} on {victim.node_name} "
                    f"for scale-down: {reason}")
        return {"action": "scale-down", "reason": reason,
                "replica": victim.id}

    def _release_drained(self) -> None:
        """Tear down scale-down replicas once their drain completes."""
        for replica in list(self.pool.replicas.values()):
            if replica.scale_down and replica.drained:
                self.pool.deregister(replica.id)
                if self.release is not None:
                    try:
                        self.release(replica)
                    except Exception:  # exc: allow — the release hook is a tenant callback; deregistration already happened
                        logger.exception("release hook failed for %s",
                                         replica.id)

    def _event(self, event_type: str, reason: str, message: str) -> None:
        logger.info("%s: %s", reason, message)
        if self._recorder is not None:
            try:
                self._recorder.event(_RouterObject(), event_type, reason,
                                     message)
            except Exception:  # exc: allow — events are advisory; never fail the decision on the recorder
                logger.warning("could not record %s event", reason,
                               exc_info=True)
