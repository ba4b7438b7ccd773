"""Drain helper — the k8s.io/kubectl/pkg/drain analog.

The reference never evicts pods itself: all cordon/uncordon/drain/eviction
flows go through the kubectl drain helper, configured in three places —
CordonManager (cordon_manager.go:39-48), DrainManager with
``IgnoreAllDaemonSets: true`` (drain_manager.go:76-96), and PodManager's
filtered eviction via ``AdditionalFilters`` (pod_manager.go:149-160). This
module reimplements the helper's core semantics against our abstract Client.

A copy of the JAX package's ``core/drain.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.clock import Clock, RealClock
from .client import (Client, ConflictError, NotFoundError, ServerError,
                     TooManyRequestsError)
from .objects import Pod

# An AdditionalFilter: pod -> (delete?, reason). Matches kubectl drain's
# PodFilter contract (pod_manager.go:76 PodDeletionFilter feeds one of these).
PodFilter = Callable[[Pod], Tuple[bool, Optional[str]]]


class DrainError(RuntimeError):
    pass


@dataclasses.dataclass
class Helper:
    """drain.Helper analog. Field names follow the reference's config at
    drain_manager.go:76-96."""

    client: Client
    force: bool = False
    ignore_all_daemon_sets: bool = True
    delete_empty_dir_data: bool = False
    grace_period_seconds: Optional[int] = None
    timeout_seconds: float = 300.0
    pod_selector: Optional[Dict[str, str]] = None
    additional_filters: List[PodFilter] = dataclasses.field(default_factory=list)
    on_pod_deletion_finished: Optional[Callable[[Pod], None]] = None
    clock: Clock = dataclasses.field(default_factory=RealClock)
    use_eviction: bool = True
    # Eviction retry schedule: bounded exponential backoff with seeded
    # jitter on 429 (PDB) / 409 (conflict) responses. kubectl drain retries
    # at a fixed 5 s; under a chaos-injected 429 storm that cadence
    # hammers the apiserver in lockstep across every draining node, so the
    # schedule grows 5 → 10 → 20 → ... capped at ``retry_max_seconds``,
    # spread by ±``retry_jitter`` fraction. The jitter RNG is seeded
    # (deterministic by default) and the waits ride the injected clock, so
    # chaos runs and unit tests can pin the exact schedule.
    retry_base_seconds: float = 5.0
    retry_max_seconds: float = 60.0
    retry_jitter: float = 0.2
    retry_seed: int = 0

    def _retry_schedule(self):
        """Infinite backoff generator: base * 2^n capped, jittered."""
        rng = random.Random(self.retry_seed)
        delay = self.retry_base_seconds
        while True:
            jitter = 1.0 + self.retry_jitter * rng.uniform(-1.0, 1.0)
            yield max(0.0, delay * jitter)
            delay = min(self.retry_max_seconds, delay * 2.0)

    # ----------------------------------------------------------------- cordon

    def run_cordon_or_uncordon(self, node_name: str, desired: bool,
                               node=None) -> None:
        """drain.RunCordonOrUncordon (used at drain_manager.go:111 and
        cordon_manager.go:39-48). Idempotent — and when the caller hands
        the Node OBJECT it already holds, a node already at the desired
        schedulability is skipped without a patch (the drain path used to
        re-cordon every already-cordoned node, a guaranteed no-op
        ``patch Node`` per drain at fleet scale)."""
        if node is not None and bool(node.spec.unschedulable) == desired:
            return
        self.client.patch_node_unschedulable(node_name, desired)

    # ------------------------------------------------------------------ drain

    def get_pods_for_deletion(self, node_name: str) -> Tuple[List[Pod], List[str]]:
        """Apply kubectl's pod filters; returns (deletable, errors). Uses the
        *uncached* client like the reference (drain helper gets the clientset,
        upgrade_state.go:132-135)."""
        pods = self.client.direct().list_pods(field_node_name=node_name,
                                              label_selector=self.pod_selector)
        deletable: List[Pod] = []
        errors: List[str] = []
        for pod in pods:
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            skip = False
            for f in self.additional_filters:
                delete, reason = f(pod)
                if not delete:
                    if reason:
                        errors.append(f"{pod.metadata.name}: {reason}")
                    skip = True
                    break
            if skip:
                continue
            owner = pod.controller_owner()
            if owner is not None and owner.kind == "DaemonSet":
                if self.ignore_all_daemon_sets:
                    continue
                errors.append(f"{pod.metadata.name}: DaemonSet-managed pod")
                continue
            if owner is None and not self.force:
                errors.append(f"{pod.metadata.name}: unmanaged pod (use force)")
                continue
            if any(v.empty_dir for v in pod.spec.volumes) and not self.delete_empty_dir_data:
                errors.append(f"{pod.metadata.name}: pod with emptyDir volume")
                continue
            deletable.append(pod)
        return deletable, errors

    def delete_or_evict_pods(self, pods: List[Pod]) -> None:
        client = self.client.direct()
        # kubectl drain treats Timeout==0 as "no timeout"
        no_timeout = self.timeout_seconds <= 0
        deadline = self.clock.now() + self.timeout_seconds
        pending = list(pods)
        schedule = self._retry_schedule()
        while pending:
            still_blocked: List[Pod] = []
            for pod in pending:
                try:
                    if self.use_eviction:
                        client.evict_pod(pod.metadata.namespace,
                                         pod.metadata.name,
                                         self.grace_period_seconds)
                    else:
                        client.delete_pod(pod.metadata.namespace,
                                          pod.metadata.name,
                                          self.grace_period_seconds)
                except NotFoundError:
                    pass
                except (TooManyRequestsError, ConflictError, ServerError):
                    # a PodDisruptionBudget blocks this eviction right now
                    # (429), the write raced another client (409), or the
                    # apiserver answered 5xx (overload, rolling restart) —
                    # kubectl drain retries until its timeout; so do we,
                    # on the jittered backoff schedule instead of its
                    # fixed 5 s cadence. The 5xx case used to escape the
                    # schedule and abort the whole drain mid-flight.
                    still_blocked.append(pod)
            if not still_blocked:
                break
            if not no_timeout and self.clock.now() >= deadline:
                raise DrainError(
                    f"global timeout reached with evictions still blocked "
                    f"by disruption budgets: "
                    f"{[p.metadata.name for p in still_blocked]}")
            self.clock.sleep(next(schedule))
            pending = still_blocked
        for pod in pods:
            while True:
                try:
                    cur = client.get_pod(pod.metadata.namespace, pod.metadata.name)
                except NotFoundError:
                    break
                except ServerError:
                    # transient 5xx while polling for termination: keep
                    # waiting on the same deadline instead of aborting
                    # the drain
                    if not no_timeout and self.clock.now() >= deadline:
                        raise DrainError(
                            f"global timeout reached while waiting for "
                            f"pod {pod.metadata.name} to terminate "
                            f"(apiserver 5xx)")
                    self.clock.sleep(1.0 if no_timeout
                                     else min(1.0, self.timeout_seconds / 10))
                    continue
                if cur.metadata.uid != pod.metadata.uid:
                    break  # same name, new pod — original is gone
                if not no_timeout and self.clock.now() >= deadline:
                    raise DrainError(
                        f"global timeout reached while waiting for pod "
                        f"{pod.metadata.name} to terminate")
                self.clock.sleep(1.0 if no_timeout
                                 else min(1.0, self.timeout_seconds / 10))
            if self.on_pod_deletion_finished is not None:
                self.on_pod_deletion_finished(pod)

    def run_node_drain(self, node_name: str) -> None:
        """drain.RunNodeDrain (drain_manager.go:121): filter then evict; any
        filter error aborts the drain (kubectl refuses to proceed)."""
        deletable, errors = self.get_pods_for_deletion(node_name)
        if errors:
            raise DrainError("; ".join(errors))
        self.delete_or_evict_pods(deletable)
