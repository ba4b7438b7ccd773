"""Resilient client boundary: retry, adaptive rate limiting, circuit breaker.

Control-plane partial failure (apiserver 5xx, latency, 429s) is a
first-class design obligation. :class:`ResilientClient` centralizes the
policy as one transparent wrapper at the client boundary (a
``__getattr__`` wrapper, like the JAX package's ``CountingClient`` and
``ChaosClient``, and it stacks with them):

- **Verb-classified retry.** Idempotent reads (``get_*`` / ``list_*``)
  are retried on :class:`~.client.ServerError` / ``TimeoutError`` with
  jittered exponential backoff (seeded RNG, waits on the injected clock, so a
  replay is deterministic). Writes and ``watch_*`` get exactly one
  attempt: a write may have landed before the 5xx reached us, so retrying
  it is the caller's idempotency decision, not the transport's; a watch
  returns a stream whose failures surface mid-iteration where no
  transparent retry is possible.
- **429 adaptive rate limiting.** A ``TooManyRequestsError`` carrying a
  ``retry_after`` attribute (apiserver priority & fairness) pauses the
  whole client for at least that long and doubles an adaptive pacing
  penalty that decays on success. Eviction-subresource 429s (a
  PodDisruptionBudget, no ``retry_after``) pass through untouched — they
  mean "this pod", not "this apiserver", and the drain helper owns that
  retry schedule.
- **Circuit breaker.** Sustained failures (default: 8 consecutive) open
  the breaker; while open, calls are shed instantly with
  :class:`BreakerOpenError` (a ``ServerError``, so every existing
  handler treats a shed exactly like the 5xx it stands for) instead of
  piling latency and retries onto a dead apiserver. After
  ``open_seconds`` the breaker half-opens and lets probe traffic
  through; one success closes it. :meth:`ResilientClient.safety` returns
  a view that BYPASSES the shedding gate — the operator's degraded-mode
  safety writes (uncordon, quarantine-lift completion) keep retrying
  through it, and their outcomes double as breaker probes, so the first
  safety write that lands also begins recovery.

Exemptions mirror the chaos injector's: lease traffic passes through
untouched (leader election implements its own renew-deadline semantics
and must see real errors), and ``create_event`` passes through (events
are advisory and swallowed by every recorder; shedding them would skew
the event-dedup invariant's exact counts).

Everything is observable through MetricsHub:
``tpu_operator_apiserver_breaker_state`` (0 closed / 1 half-open /
2 open), ``..._apiserver_retries_total``, ``..._apiserver_shed_total``,
``..._apiserver_rate_limited_total``. Every family in the tables below
has a HELP_TEXTS entry.

``GPUOperator`` consumes the breaker state to drive its fail-static
DEGRADED mode — see ``gpu/operator.py``.

A copy of the JAX package's ``core/resilience.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, Optional

from ..utils.clock import Clock, RealClock
from .client import (ApiError, ServerError, TooManyRequestsError,
                     method_verb_kind)

logger = logging.getLogger(__name__)

# family tables: every family here has a HELP_TEXTS entry, and every
# tpu_operator_apiserver_breaker_*/retries/shed/rate_limited HELP entry
# appears here.
RESILIENCE_GAUGE_FAMILIES = (
    "tpu_operator_apiserver_breaker_state",
)
RESILIENCE_COUNTER_FAMILIES = (
    "tpu_operator_apiserver_retries_total",
    "tpu_operator_apiserver_shed_total",
    "tpu_operator_apiserver_rate_limited_total",
)

# pass-through ops, mirroring the JAX package's chaos injector's
# exemptions (see module docstring for why each is out of scope for retry/shed)
_EXEMPT_OPS = {"get_lease", "create_lease", "update_lease", "create_event"}

_RETRY_VERBS = ("get", "list")

CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"

_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class BreakerOpenError(ServerError):
    """The circuit breaker is open: the call was shed without touching
    the apiserver. A ``ServerError`` subclass so every existing 5xx
    handler (per-component reconcile isolation, drain backoff) treats a
    shed like the outage it stands for."""


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing, clock-injected.

    closed --[>= failure_threshold consecutive failures]--> open
    open   --[open_seconds elapsed]--> half-open (probes allowed)
    half-open --[half_open_successes successes]--> closed
    half-open --[any failure]--> open (timer restarts)

    A success recorded while OPEN (a safety-bypass write that landed)
    short-circuits to half-open and counts as a probe success — the
    in-flight safety retries ARE the recovery probes."""

    def __init__(self, clock: Optional[Clock] = None,
                 failure_threshold: int = 8,
                 open_seconds: float = 30.0,
                 half_open_successes: int = 1,
                 metrics=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._clock = clock or RealClock()
        self.failure_threshold = failure_threshold
        self.open_seconds = open_seconds
        self.half_open_successes = max(1, half_open_successes)
        self._metrics = metrics
        # duck-typed fleet black box (obs/timeline.py FleetTimeline —
        # not imported: core sits below obs in the layering); bound by
        # the operator so breaker open/close edges land on the unified
        # timeline the root-cause engine walks
        self._timeline = None
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_successes = 0
        self.opened_total = 0
        self._publish()

    # ------------------------------------------------------------- state

    @property
    def state(self) -> str:
        """Current state, advancing open -> half-open when the timer has
        elapsed (reading IS the timer check — no background thread)."""
        if (self._state == OPEN
                and self._clock.now() - self._opened_at
                >= self.open_seconds):
            self._transition(HALF_OPEN)
            self._probe_successes = 0
        return self._state

    @property
    def is_closed(self) -> bool:
        return self.state == CLOSED

    def allow(self) -> bool:
        """May a normal (non-safety) call proceed right now?"""
        return self.state != OPEN

    # ----------------------------------------------------------- feeding

    def record_success(self) -> None:
        state = self.state
        if state == CLOSED:
            self._consecutive_failures = 0
            return
        if state == OPEN:
            # a safety-bypass call landed: the apiserver answered while
            # the shedding gate was still closed to normal traffic
            self._transition(HALF_OPEN)
            self._probe_successes = 0
        self._probe_successes += 1
        if self._probe_successes >= self.half_open_successes:
            self._consecutive_failures = 0
            self._transition(CLOSED)

    def record_failure(self) -> None:
        state = self.state
        if state == CLOSED:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._open()
        else:
            # half-open probe failed, or a safety call failed while
            # open: the outage persists — (re)start the open window
            self._open()

    def _open(self) -> None:
        self._opened_at = self._clock.now()
        self._probe_successes = 0
        if self._state != OPEN:
            self.opened_total += 1
        self._transition(OPEN)

    def _transition(self, state: str) -> None:
        if state != self._state:
            logger.info("apiserver circuit breaker %s -> %s",
                        self._state, state)
            if self._timeline is not None and state in (OPEN, CLOSED):
                # half-open probing is internal churn; only the outage
                # edges matter for root-cause attribution
                if state == OPEN:
                    self._timeline.record_event(
                        kind="breaker-open", entity="breaker/apiserver",
                        detail=f"after {self._consecutive_failures} "
                               f"consecutive failures")
                else:
                    self._timeline.record_event(
                        kind="breaker-close",
                        entity="breaker/apiserver",
                        detail="probe succeeded; traffic restored")
        self._state = state
        self._publish()

    def bind_metrics(self, metrics) -> None:
        self._metrics = metrics
        self._publish()

    def bind_timeline(self, timeline) -> None:
        """Late-bind a FleetTimeline (duck-typed — see ctor note)."""
        self._timeline = timeline

    def _publish(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("apiserver_breaker_state",
                                    _STATE_VALUE[self._state])


class AdaptiveRateLimiter:
    """429 ``Retry-After`` honoring pacing, clock-injected.

    Engages ONLY on 429s carrying a ``retry_after`` attribute (apiserver
    priority & fairness): the client pauses until the server-stated
    deadline and an adaptive penalty (doubling per 429, decaying per
    success) spaces subsequent traffic. PDB eviction 429s never engage —
    they are per-pod admission decisions, not server overload."""

    def __init__(self, clock: Optional[Clock] = None,
                 base_penalty_s: float = 1.0,
                 max_penalty_s: float = 30.0,
                 metrics=None):
        self._clock = clock or RealClock()
        self.base_penalty_s = base_penalty_s
        self.max_penalty_s = max_penalty_s
        self._metrics = metrics
        self._pace_until = 0.0
        self._penalty_s = 0.0
        self.limited_total = 0

    def pace(self) -> None:
        """Block (on the injected clock) until the current pacing window
        has passed; no-op when the limiter is idle."""
        now = self._clock.now()
        if now < self._pace_until:
            self._clock.sleep(self._pace_until - now)

    def on_429(self, retry_after: Optional[float]) -> None:
        if retry_after is None:
            return  # PDB-style 429: not a server-overload signal
        self.limited_total += 1
        if self._metrics is not None:
            self._metrics.inc("apiserver_rate_limited_total")
        self._penalty_s = min(self.max_penalty_s,
                              max(self.base_penalty_s,
                                  self._penalty_s * 2.0))
        wait = max(float(retry_after), self._penalty_s)
        self._pace_until = max(self._pace_until,
                               self._clock.now() + wait)

    def on_success(self) -> None:
        self._penalty_s = 0.0 if self._penalty_s <= self.base_penalty_s \
            else self._penalty_s / 2.0

    def bind_metrics(self, metrics) -> None:
        self._metrics = metrics


class ResilientClient:
    """Transparent retry/rate-limit/breaker wrapper at the client
    boundary. Stack order (outermost first) in the full configuration::

        CachedClient -> ResilientClient -> CountingClient -> ChaosClient

    so informer list/watch traffic and every operator write pass through
    the breaker gate, retries are individually counted and individually
    taxed by chaos, and store reads stay free."""

    def __init__(self, inner,
                 clock: Optional[Clock] = None,
                 retries: int = 3,
                 retry_base_s: float = 0.5,
                 retry_max_s: float = 4.0,
                 retry_jitter: float = 0.2,
                 seed: int = 0,
                 breaker: Optional[CircuitBreaker] = None,
                 limiter: Optional[AdaptiveRateLimiter] = None,
                 metrics=None,
                 failure_threshold: int = 8,
                 open_seconds: float = 30.0,
                 half_open_successes: int = 1):
        self._inner = inner
        self._clock = clock or RealClock()
        self.retries = max(0, retries)
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.retry_jitter = retry_jitter
        self._rng = random.Random(seed)
        self._metrics = metrics
        self.breaker = breaker or CircuitBreaker(
            clock=self._clock, failure_threshold=failure_threshold,
            open_seconds=open_seconds,
            half_open_successes=half_open_successes, metrics=metrics)
        self.limiter = limiter or AdaptiveRateLimiter(
            clock=self._clock, metrics=metrics)
        self.retried_total = 0
        self.shed_total = 0

    # --------------------------------------------------------------- views

    def direct(self) -> "ResilientClient":
        """Uncached view sharing this wrapper's breaker, limiter, RNG and
        counters — one resilience policy covers both read paths."""
        clone = ResilientClient.__new__(ResilientClient)
        clone.__dict__.update(self.__dict__)
        clone._inner = self._inner.direct()
        return clone

    def safety(self) -> "_SafetyView":
        """A view whose calls BYPASS the breaker's shedding gate (still
        feeding it): degraded-mode safety writes — uncordon,
        quarantine-lift completion — keep retrying through this, and
        each outcome doubles as a breaker probe."""
        return _SafetyView(self)

    def bind_metrics(self, metrics) -> None:
        """Late-bind a MetricsHub (cmd/operator.py builds the client
        before the hub exists)."""
        self._metrics = metrics
        self.breaker.bind_metrics(metrics)
        self.limiter.bind_metrics(metrics)

    def bind_timeline(self, timeline) -> None:
        """Late-bind the fleet timeline onto the breaker (the operator
        calls this; core never imports obs)."""
        self.breaker.bind_timeline(timeline)

    def probe(self) -> bool:
        """One cheap gated read (a label-scoped node LIST matching
        nothing) — the degraded-mode recovery probe for configurations
        without an informer pump. Sheds instantly while the breaker is
        open; once half-open, a success closes the breaker. A 5xx, a
        shed, a throttle, or the retry budget expiring all mean the same
        thing here: not recovered yet."""
        try:
            self._call("list_nodes", self._inner.list_nodes, "list", (),
                       {"label_selector": {"breaker-probe": "none"}})
            return True
        except (ApiError, TimeoutError):
            return False

    def payload(self) -> Dict[str, object]:
        """The ``/resilience`` envelope data (cmd/operator.py)."""
        return {
            "breaker": self.breaker.state,
            "breaker_opened_total": self.breaker.opened_total,
            "retried_total": self.retried_total,
            "shed_total": self.shed_total,
            "rate_limited_total": self.limiter.limited_total,
        }

    # ---------------------------------------------------------- the gate

    def _backoff(self, attempt: int) -> float:
        delay = min(self.retry_max_s,
                    self.retry_base_s * (2.0 ** (attempt - 1)))
        jitter = 1.0 + self.retry_jitter * self._rng.uniform(-1.0, 1.0)
        return max(0.0, delay * jitter)

    def _call(self, name: str, attr, verb: str, args, kwargs,
              gated: bool = True):
        self.limiter.pace()
        attempt = 0
        while True:
            if gated and not self.breaker.allow():
                self.shed_total += 1
                if self._metrics is not None:
                    self._metrics.inc("apiserver_shed_total",
                                      labels={"verb": verb})
                raise BreakerOpenError(
                    f"apiserver circuit breaker open; {name} shed")
            try:
                out = attr(*args, **kwargs)
            except TooManyRequestsError as exc:
                # the server answered: alive, just throttling — never a
                # breaker failure, never transparently retried here
                self.limiter.on_429(getattr(exc, "retry_after", None))
                raise
            except (ServerError, TimeoutError):
                self.breaker.record_failure()
                if verb in _RETRY_VERBS and attempt < self.retries \
                        and self.breaker.allow():
                    attempt += 1
                    self.retried_total += 1
                    if self._metrics is not None:
                        self._metrics.inc("apiserver_retries_total",
                                          labels={"verb": verb})
                    self._clock.sleep(self._backoff(attempt))
                    continue
                raise
            self.breaker.record_success()
            self.limiter.on_success()
            return out

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr) or name in _EXEMPT_OPS:
            return attr
        vk = method_verb_kind(name)
        if vk is None:
            return attr
        verb, _kind = vk

        def call(*args, **kwargs):
            return self._call(name, attr, verb, args, kwargs)

        return call


class _SafetyView:
    """Bypasses the breaker's shedding gate; outcomes still feed it (a
    safety write that lands while open IS the recovery probe)."""

    def __init__(self, resilient: ResilientClient):
        self._res = resilient

    def direct(self) -> "_SafetyView":
        return _SafetyView(self._res.direct())

    def __getattr__(self, name):
        res = self._res
        attr = getattr(res._inner, name)
        if not callable(attr) or name in _EXEMPT_OPS:
            return attr
        vk = method_verb_kind(name)
        if vk is None:
            return attr
        verb, _kind = vk

        def call(*args, **kwargs):
            return res._call(name, attr, verb, args, kwargs, gated=False)

        return call


class ResilienceOptions:
    """The ``resilience:`` config section (camelCase, CRD convention) —
    ``cmd/operator.py`` builds a :class:`ResilientClient` from this."""

    def __init__(self, retries: int = 3, retry_base_s: float = 0.5,
                 retry_max_s: float = 4.0, retry_jitter: float = 0.2,
                 failure_threshold: int = 8, open_seconds: float = 30.0,
                 half_open_successes: int = 1, seed: int = 0):
        if retries < 0:
            raise ValueError("retries must be >= 0")
        if open_seconds < 0:
            raise ValueError("openSeconds must be >= 0")
        self.retries = retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.retry_jitter = retry_jitter
        self.failure_threshold = failure_threshold
        self.open_seconds = open_seconds
        self.half_open_successes = half_open_successes
        self.seed = seed

    @classmethod
    def from_dict(cls, d: dict) -> "ResilienceOptions":
        return cls(
            retries=int(d.get("retries", 3)),
            retry_base_s=float(d.get("retryBaseSeconds", 0.5)),
            retry_max_s=float(d.get("retryMaxSeconds", 4.0)),
            retry_jitter=float(d.get("retryJitter", 0.2)),
            failure_threshold=int(d.get("breakerFailureThreshold", 8)),
            open_seconds=float(d.get("breakerOpenSeconds", 30.0)),
            half_open_successes=int(d.get("breakerHalfOpenSuccesses", 1)),
            seed=int(d.get("seed", 0)))

    def build(self, inner, clock=None, metrics=None) -> ResilientClient:
        return ResilientClient(
            inner, clock=clock, retries=self.retries,
            retry_base_s=self.retry_base_s, retry_max_s=self.retry_max_s,
            retry_jitter=self.retry_jitter, seed=self.seed,
            metrics=metrics, failure_threshold=self.failure_threshold,
            open_seconds=self.open_seconds,
            half_open_successes=self.half_open_successes)


__all__ = ["AdaptiveRateLimiter", "BreakerOpenError", "CircuitBreaker",
           "ResilienceOptions", "ResilientClient",
           "RESILIENCE_COUNTER_FAMILIES", "RESILIENCE_GAUGE_FAMILIES",
           "CLOSED", "HALF_OPEN", "OPEN"]
