"""Pluggable health probes — raw signal sources over the cluster snapshot.

A probe turns the snapshot the operator already holds (nodes + the managed
component's driver pods) into zero or more :class:`Signal`s. Probes are pure
observers: they never write to the cluster, and any memory they keep (restart
counters, error-counter baselines) is soft — losing it across an operator
restart only delays detection by one observation, mirroring how
node-problem-detector daemons rebuild state after restart.

Shipped probes, in the order production TPU fleets usually rank them:

- :class:`DriverCrashLoopProbe` — device-plugin / libtpu driver pod
  crash-looping (not-ready with accumulated restarts) or still restarting
  (restart-count delta between observations).
- :class:`HeartbeatProbe` — staleness of the node agent's heartbeat
  annotation, judged against the injected :class:`~...utils.clock.Clock`
  (never a wall-clock read in library code).
- :class:`NodeConditionProbe` — kubelet-level conditions: Ready flapping to
  False/Unknown, plus pressure conditions that should never be True.
- :class:`CounterProbe` — monotonic hardware error counters surfaced as node
  annotations (ICI link errors, HBM ECC); fires on a per-observation delta
  or an absolute ceiling. ECC uses ``persistent_hint`` — a failing HBM stack
  does not heal by waiting, so the classifier may skip the transient stage.

A copy of the JAX package's ``health/probes.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from ..core.objects import Node, Pod
from ..utils.clock import Clock
from . import consts

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Snapshot:
    """What every probe sees for one tick."""

    nodes: List[Node]
    pods_by_node: Dict[str, List[Pod]]  # the managed driver pods, per node
    clock: Clock


@dataclasses.dataclass(frozen=True)
class Signal:
    """One probe observation against one node."""

    probe: str
    node: str
    message: str = ""
    # True when the underlying fault cannot clear on its own (uncorrectable
    # ECC, dead ICI link): the classifier escalates straight past the
    # transient stage once the signal survives damping.
    persistent_hint: bool = False


class Probe:
    """Base class; ``name`` keys damping state in the classifier, so it must
    be stable across ticks."""

    name = "probe"

    def observe(self, snapshot: Snapshot) -> List[Signal]:
        raise NotImplementedError


class DriverCrashLoopProbe(Probe):
    """Driver-pod health: crashloop and restart-count deltas.

    Fires while a driver pod is (a) in a terminal/unknown phase, (b) not
    ready with ``restart_threshold`` or more container restarts, or (c) still
    accumulating restarts between observations (delta probe — catches the
    crashloop whose container is momentarily Ready between crashes). Delta
    baselines key on pod UID, so a recreated pod starts clean.
    """

    name = "driver-crashloop"

    def __init__(self, restart_threshold: int = 3):
        self.restart_threshold = restart_threshold
        self._last_restarts: Dict[str, int] = {}  # pod uid -> total restarts

    def observe(self, snapshot: Snapshot) -> List[Signal]:
        signals: List[Signal] = []
        seen_uids = set()
        for node in snapshot.nodes:
            for pod in snapshot.pods_by_node.get(node.metadata.name, []):
                sig = self._check_pod(node.metadata.name, pod)
                seen_uids.add(pod.metadata.uid)
                if sig is not None:
                    signals.append(sig)
        # drop baselines of pods that no longer exist
        for uid in list(self._last_restarts):
            if uid not in seen_uids:
                del self._last_restarts[uid]
        return signals

    def _check_pod(self, node_name: str, pod: Pod) -> Optional[Signal]:
        statuses = (list(pod.status.init_container_statuses)
                    + list(pod.status.container_statuses))
        restarts = sum(cs.restart_count for cs in statuses)
        prev = self._last_restarts.get(pod.metadata.uid)
        self._last_restarts[pod.metadata.uid] = restarts
        if pod.status.phase in ("Failed", "Unknown"):
            return Signal(self.name, node_name,
                          f"driver pod {pod.metadata.name} phase "
                          f"{pod.status.phase}")
        crash_looping = any(
            not cs.ready and cs.restart_count >= self.restart_threshold
            for cs in statuses)
        if crash_looping:
            return Signal(self.name, node_name,
                          f"driver pod {pod.metadata.name} crash-looping "
                          f"({restarts} restarts, not ready)")
        if (prev is not None and restarts > prev
                and restarts >= self.restart_threshold):
            return Signal(self.name, node_name,
                          f"driver pod {pod.metadata.name} still restarting "
                          f"({prev} -> {restarts})")
        return None


class HeartbeatProbe(Probe):
    """Staleness of the node agent's heartbeat annotation.

    The agent writes wall-clock seconds (``Clock.wall`` format) to
    ``tpu.dev/health.heartbeat``. A node that has NEVER reported is not
    signalled — absence means "no agent deployed", and flagging it would
    condemn every fleet that doesn't run one. A malformed value IS signalled:
    an agent that used to write well-formed stamps and now writes garbage is
    broken.
    """

    name = "heartbeat"

    def __init__(self, stale_after_seconds: float = 180.0,
                 annotation: str = consts.HEARTBEAT_ANNOTATION):
        self.stale_after_seconds = stale_after_seconds
        self.annotation = annotation

    def observe(self, snapshot: Snapshot) -> List[Signal]:
        signals: List[Signal] = []
        now = snapshot.clock.wall()
        for node in snapshot.nodes:
            raw = node.metadata.annotations.get(self.annotation)
            if raw is None:
                continue
            try:
                age = now - float(raw)
            except (TypeError, ValueError):
                signals.append(Signal(
                    self.name, node.metadata.name,
                    f"malformed heartbeat annotation {raw!r}"))
                continue
            if age > self.stale_after_seconds:
                signals.append(Signal(
                    self.name, node.metadata.name,
                    f"heartbeat stale for {age:.0f}s "
                    f"(> {self.stale_after_seconds:.0f}s)"))
        return signals


class NodeConditionProbe(Probe):
    """Kubelet node conditions: Ready must be True; pressure/problem
    conditions must not be."""

    name = "node-condition"

    # condition types that signal trouble when their status is "True"
    # (the node-problem-detector convention: problems are positive flags)
    BAD_WHEN_TRUE = ("MemoryPressure", "DiskPressure", "PIDPressure",
                     "NetworkUnavailable", "TPUUnhealthy")

    def observe(self, snapshot: Snapshot) -> List[Signal]:
        signals: List[Signal] = []
        for node in snapshot.nodes:
            name = node.metadata.name
            for cond in node.status.conditions:
                if cond.type == "Ready" and cond.status != "True":
                    signals.append(Signal(
                        self.name, name,
                        f"node condition Ready={cond.status}"))
                elif cond.type in self.BAD_WHEN_TRUE and cond.status == "True":
                    signals.append(Signal(
                        self.name, name,
                        f"node condition {cond.type}=True"))
        return signals


class CounterProbe(Probe):
    """Monotonic hardware error counter surfaced as a node annotation.

    Fires when the counter grows by ``delta_threshold`` or more between
    observations (errors actively accumulating) or crosses
    ``absolute_threshold`` (damage already done). The first observation only
    sets the baseline — a fleet adopted mid-life must not alarm on its
    historical totals.
    """

    def __init__(self, name: str, annotation: str,
                 delta_threshold: int = 1,
                 absolute_threshold: Optional[int] = None,
                 persistent_hint: bool = False):
        self.name = name
        self.annotation = annotation
        self.delta_threshold = delta_threshold
        self.absolute_threshold = absolute_threshold
        self.persistent_hint = persistent_hint
        self._baseline: Dict[str, int] = {}  # node -> last observed value

    def observe(self, snapshot: Snapshot) -> List[Signal]:
        signals: List[Signal] = []
        for node in snapshot.nodes:
            name = node.metadata.name
            raw = node.metadata.annotations.get(self.annotation)
            if raw is None:
                self._baseline.pop(name, None)
                continue
            try:
                value = int(raw)
            except (TypeError, ValueError):
                signals.append(Signal(self.name, name,
                                      f"malformed {self.annotation}={raw!r}",
                                      persistent_hint=self.persistent_hint))
                continue
            prev = self._baseline.get(name)
            self._baseline[name] = value
            if (self.absolute_threshold is not None
                    and value >= self.absolute_threshold):
                signals.append(Signal(
                    self.name, name,
                    f"{self.annotation}={value} >= absolute threshold "
                    f"{self.absolute_threshold}",
                    persistent_hint=self.persistent_hint))
            elif prev is not None and value - prev >= self.delta_threshold:
                signals.append(Signal(
                    self.name, name,
                    f"{self.annotation} climbed {prev} -> {value}",
                    persistent_hint=self.persistent_hint))
        return signals


def default_probes(restart_threshold: int = 3,
                   heartbeat_stale_seconds: float = 180.0
                   ) -> List[Probe]:
    """The standard fleet probe set: crashloop, heartbeat, node conditions,
    ICI link errors (transient — links retrain), HBM ECC (persistent)."""
    return [
        DriverCrashLoopProbe(restart_threshold=restart_threshold),
        HeartbeatProbe(stale_after_seconds=heartbeat_stale_seconds),
        NodeConditionProbe(),
        CounterProbe("ici-link-errors",
                     consts.ICI_LINK_ERRORS_ANNOTATION,
                     delta_threshold=1),
        CounterProbe("hbm-ecc-errors",
                     consts.HBM_ECC_ERRORS_ANNOTATION,
                     delta_threshold=1, persistent_hint=True),
    ]


def run_probes(probes: List[Probe], snapshot: Snapshot
               ) -> Tuple[List[Signal], List[str]]:
    """Run every probe; a raising probe is isolated (its name is returned in
    the error list) so one broken signal source cannot blind the fleet."""
    signals: List[Signal] = []
    errors: List[str] = []
    for probe in probes:
        try:
            signals.extend(probe.observe(snapshot))
        except Exception:  # exc: allow — probe isolation: one broken signal source must not blind the fleet
            logger.exception("health probe %s failed", probe.name)
            errors.append(probe.name)
    return signals, errors
