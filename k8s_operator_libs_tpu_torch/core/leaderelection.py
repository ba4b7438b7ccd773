"""Lease-based leader election for HA operator deployments.

A copy of the JAX package's ``core/leaderelection.py`` over the port's
clients; the port imports nothing of that package.

The reference library ships none of this — its consumers (GPU / Network
Operator) inherit controller-runtime's leaderelection when they build their
manager. The deployable binary (``operator.py``) has no controller-runtime,
so this module implements the same protocol against a
``coordination.k8s.io/v1`` Lease:

- a candidate acquires the lease by CREATE (404 path) or by CAS UPDATE when
  the recorded ``renewTime`` is older than ``leaseDurationSeconds`` (holder
  crashed / stopped renewing);
- the holder re-PUTs ``renewTime`` every ``retry_period``; the apiserver's
  resourceVersion conflict detection makes every transition a
  compare-and-swap — two candidates racing the same takeover get exactly one
  winner (the loser's PUT 409s);
- losing the lease (e.g. an apiserver partition longer than the lease
  duration) is detected on the next tick and reported, so the caller stops
  acting as leader BEFORE a new holder starts.

Defaults follow client-go: lease 15 s, retry 2 s.

Usage: run :meth:`run_background` so renewal is NOT coupled to the
reconcile cadence (a reconcile longer than the lease duration — a drain
waiting out PDB retries — must not let the lease lapse mid-tick; client-go
renews on a background goroutine for the same reason), then gate work on
:attr:`is_leader`:

    elector = LeaderElector(client, "tpu-operator", "kube-system", identity)
    elector.run_background(stop_event)
    while running:
        if elector.is_leader:
            operator.reconcile()
        clock.sleep(interval)

The non-blocking :meth:`tick` remains for single-threaded loops whose
iteration time is far below the lease duration.

Why the absence of write fencing is safe here: an
in-flight reconcile cannot be aborted at the instant leadership lapses, so
a deposed leader can complete a handful of writes concurrently with the
new leader's first pass. Every write the operator performs is a node
label/annotation strategic-merge PATCH that encodes a STATE of the
idempotent, cluster-state-driven machine — not an increment, not a
read-modify-write of shared structure. Interleavings therefore resolve to
last-writer-wins on a single key, and whichever value lands, the next
reconcile (by the one remaining leader) re-derives the correct transition
from observed cluster state: a stale write can at worst repeat or rewind
one step of an idempotent pipeline, never corrupt it. This is the same
argument controller-runtime relies on for its own non-fenced
leader-election default (leases fence the RECONCILER, not each write).
Deployments that want hard fencing anyway can make ``on_lost`` stop the
process (client-go's OnStoppedLeading convention — ``operator.py`` sets
its shutdown event there), bounding the deposed leader's write window to
the one in-flight reconcile.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..utils import threads
from ..utils.clock import Clock, RealClock
from .client import ConflictError, NotFoundError
from .objects import Lease, LeaseSpec, ObjectMeta

logger = logging.getLogger(__name__)

DEFAULT_LEASE_DURATION_S = 15.0
DEFAULT_RETRY_PERIOD_S = 2.0


class LeaderElector:
    def __init__(self, client, lease_name: str, namespace: str,
                 identity: str,
                 lease_duration_s: float = DEFAULT_LEASE_DURATION_S,
                 retry_period_s: float = DEFAULT_RETRY_PERIOD_S,
                 clock: Optional[Clock] = None):
        self._client = client
        self._name = lease_name
        self._ns = namespace
        self.identity = identity
        self._duration = lease_duration_s
        self.retry_period = retry_period_s
        self._clock = clock or RealClock()
        self._is_leader = False
        self._last_attempt: float = -1e18
        self._last_renew_ok: float = -1e18
        self._bg_stop = threads.make_event(f"leader-elector-{identity}-stop")
        self._bg_thread = None
        self._on_lost = None

    @property
    def is_leader(self) -> bool:
        """Last observed leadership state (updated by :meth:`tick`)."""
        # thr: allow — deliberate lock-free bool read: GIL-atomic, stale
        # by at most one retry period, and the module docstring's fencing
        # argument covers the deposed-leader window; a lock here would be
        # held across every reconcile gate check for nothing
        return self._is_leader  # thr: allow — see above


    # ------------------------------------------------------------------ tick

    def tick(self) -> bool:
        """Acquire-or-renew, rate-limited to ``retry_period``; returns
        whether this process is the leader RIGHT NOW. Call every loop
        iteration — cheap between attempts."""
        now = self._clock.now()
        if now - self._last_attempt < self.retry_period:
            return self._is_leader
        self._last_attempt = now
        was = self._is_leader
        self._is_leader = self._try_acquire_or_renew()
        if self._is_leader:
            self._last_renew_ok = now
        if self._is_leader and not was:
            logger.info("%s became leader of %s/%s", self.identity,
                        self._ns, self._name)
        elif was and not self._is_leader:
            logger.warning("%s LOST leadership of %s/%s", self.identity,
                           self._ns, self._name)
            if self._on_lost is not None:
                self._on_lost()
        return self._is_leader

    def tick_safely(self) -> bool:
        """:meth:`tick` with client-go renew-deadline semantics on
        transport failure: an exception from the apiserver (blip, rolling
        restart, chaos-injected 5xx) KEEPS leadership while the lease we
        hold is still alive — the record still names us, so no standby can
        take over anyway. Only when the outage outlives the renew deadline
        (strictly inside the lease duration, so the old holder steps down
        BEFORE a standby can acquire) is leadership demoted. Used by
        :meth:`run_background` and by synchronous drivers (the chaos
        campaign ticks candidates on a fake clock)."""
        try:
            return self.tick()
        except Exception:  # exc: allow — any tick failure demotes at the renew deadline, exactly like a renew timeout
            logger.exception("leader-election tick failed")
            # demote at a renew DEADLINE strictly inside the lease
            # (client-go: renewDeadline < leaseDuration): a standby
            # acquires only after the full lease, so the margin —
            # two retry periods, covering our own polling lag —
            # guarantees the old holder has stepped down first;
            # equal thresholds would allow a dual-leader window
            deadline = max(self.retry_period,
                           self._duration - 2 * self.retry_period)
            lapsed = (self._clock.now() - self._last_renew_ok > deadline)
            if self._is_leader and lapsed:
                self._is_leader = False
                if self._on_lost is not None:
                    self._on_lost()
            return self._is_leader

    def run_background(self, stop_event, on_lost=None):
        """Renew/acquire on a daemon thread every ``retry_period`` until
        ``stop_event`` (or :meth:`release`) fires — leadership stays alive
        through reconciles longer than the lease duration. The caller gates
        work on :attr:`is_leader` (a plain bool read).

        ``on_lost`` fires when held leadership lapses (renewals failed
        longer than the lease). There is no way to abort a reconcile already
        in flight, so callers should treat it like client-go's
        OnStoppedLeading: stop the process and let the supervisor restart it
        as a standby."""
        self._on_lost = on_lost

        def loop():
            while not (stop_event.is_set() or self._bg_stop.is_set()):
                self.tick_safely()
                self._bg_stop.wait(self.retry_period)
        t = threads.spawn(f"leader-elector-{self.identity}", loop,
                          start=False)
        self._bg_thread = t
        t.start()
        return t

    def release(self) -> None:
        """Voluntarily drop the lease on clean shutdown so the successor
        doesn't wait out the full lease duration (client-go's
        ReleaseOnCancel). Stops and joins the background renew thread first
        — otherwise an in-flight renew PUT can beat the release (409) or a
        zombie thread can re-acquire the lease it just gave up. Never
        raises — shutdown must complete even when the apiserver is
        unreachable (the lease then simply expires)."""
        self._bg_stop.set()
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=max(5.0, self.retry_period * 3))
            self._bg_thread = None
        was_leader = self._is_leader
        # step down BEFORE the record clears (the module contract: the
        # old holder stops acting as leader before a new holder can
        # start) — clearing the lease first left a window where a
        # standby acquired while is_leader here still read True; the
        # schedule explorer's two-leader observation caught it
        self._is_leader = False
        if not was_leader:
            return
        try:
            lease = self._client.get_lease(self._ns, self._name)
            if lease.spec.holder_identity == self.identity:
                lease.spec.holder_identity = ""
                lease.spec.renew_time = None
                self._client.update_lease(lease)
        except Exception as exc:  # exc: allow — release is best-effort; an unreleased lease expires on its own
            logger.warning("could not release lease %s/%s (%s); it will "
                           "expire on its own", self._ns, self._name, exc)

    # ------------------------------------------------------------- internals

    def _try_acquire_or_renew(self) -> bool:
        now = self._clock.now()
        try:
            lease = self._client.get_lease(self._ns, self._name)
        except NotFoundError:
            lease = Lease(
                metadata=ObjectMeta(name=self._name, namespace=self._ns),
                spec=LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=int(self._duration),
                    acquire_time=now, renew_time=now))
            try:
                self._client.create_lease(lease)
                return True
            except ConflictError:
                return False  # raced another candidate; retry next tick

        if lease.spec.holder_identity == self.identity:
            # renew: keep resourceVersion so a hijack (another holder took
            # over while we were partitioned) 409s instead of clobbering
            lease.spec.renew_time = now
            try:
                self._client.update_lease(lease)
                return True
            except (ConflictError, NotFoundError):
                return False

        # client-go semantics: expiry is judged against the CANDIDATE'S
        # configured LeaseDuration, not the record's integer field (which
        # is informational — and truncates sub-second test durations to 0)
        expired = (not lease.spec.holder_identity
                   or lease.spec.renew_time is None
                   or now - lease.spec.renew_time > self._duration)
        if not expired:
            return False
        # takeover: CAS on the observed resourceVersion
        lease.spec.holder_identity = self.identity
        lease.spec.acquire_time = now
        lease.spec.renew_time = now
        lease.spec.lease_transitions += 1
        try:
            self._client.update_lease(lease)
            return True
        except (ConflictError, NotFoundError):
            return False  # someone else won the race
