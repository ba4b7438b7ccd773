"""Per-node upgrade journey: durable state-transition timeline + stuck
detection.

Every ``UpgradeState`` transition flows through ONE choke point — the
:class:`~..upgrade.node_state_provider.NodeUpgradeStateProvider` write path
— which calls :meth:`JourneyRecorder.record` and folds the returned
annotations into the same strategic-merge patch as the state label itself.
The journey therefore can never disagree with the label, and because it is
a node ANNOTATION, time-in-state survives operator restarts and leader
failover (the acceptance bar the in-memory gauges could not meet).

Wire format (one annotation per managed component)::

    tpu.dev/libtpu-driver-upgrade.journey =
        [["upgrade-required",1722700100.0],["cordon-required",1722700130.5],
         ...]

— a JSON list of ``[state wire value, entered-at wall seconds]`` pairs,
newest last, capped at :data:`MAX_JOURNEY_ENTRIES` entries AND
:data:`MAX_JOURNEY_BYTES` serialized bytes (k8s enforces a hard
per-object annotation budget; a 10k-node fleet with long repair
histories would hit it silently otherwise). Once truncation has
happened the journey switches to the object form::

    {"truncated": 3, "entries": [["drain-required",1722700150.0], ...]}

carrying the count of dropped oldest entries, so readers (``cmd/status
--timeline``, the fleet benchmark's integrity sweep) can tell a short
journey from a clipped one. Untruncated journeys keep the legacy list
form byte-for-byte — existing annotations, golden patch fixtures, and
external parsers are unaffected until the cap actually binds.

This module deliberately does NOT import the upgrade package (obs sits
below it in the layering DAG), so :data:`DEFAULT_STUCK_THRESHOLDS` is keyed
by the state **wire values**. The table is closed over ``UpgradeState``:
``tests/test_torch_fakecluster.py`` holds it equal to the JAX package's,
and the port's OBS001 (``lint/obs_check.py``) keeps it closed.

A copy of the JAX package's ``obs/journey.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

from ..core.client import ApiError
from ..utils.clock import Clock, RealClock

logger = logging.getLogger(__name__)

MAX_JOURNEY_ENTRIES = 48
# serialized-size guard: k8s caps TOTAL annotations per object at 256 KiB,
# and one node carries a journey per managed component plus the health /
# repair / heartbeat annotations — budget each journey well under that
MAX_JOURNEY_BYTES = 8192

# Per-state stuck thresholds (seconds of dwell before the node is reported
# stuck); 0 disables detection for that state. Keyed by wire value, closed
# over UpgradeState. Rationale per state:
#   upgrade-required        0     waiting for an admission slot is normal
#                                 (budget-bound, possibly hours on big fleets)
#   cordon-required         300   cordon is one patch; minutes means the
#                                 apiserver or the operator is wedged
#   wait-for-jobs-required  0     bounded by the policy's own timeout (0 =
#                                 wait forever is a legal configuration)
#   pod-deletion-required   900   eviction retries against PDBs
#   drain-required          1800  drain timeout default is 300 s; several
#                                 retry rounds before this fires
#   pod-restart-required    900   DaemonSet controller should replace the
#                                 pod within minutes
#   validation-required     900   validation itself times out at 600 s
#   uncordon-required       600   held only by group barriers / siblings
#   upgrade-done            0     terminal
#   upgrade-failed          3600  failed nodes page through other channels;
#                                 this catches ones nobody picked up
#   "" (unknown)            0     unmanaged
DEFAULT_STUCK_THRESHOLDS: Dict[str, float] = {
    "": 0.0,
    "upgrade-required": 0.0,
    "cordon-required": 300.0,
    "wait-for-jobs-required": 0.0,
    "pod-deletion-required": 900.0,
    "drain-required": 1800.0,
    "pod-restart-required": 900.0,
    "validation-required": 900.0,
    "uncordon-required": 600.0,
    "upgrade-done": 0.0,
    "upgrade-failed": 3600.0,
}

STUCK_EVENT_REASON = "StuckNode"


def parse_journey_full(raw: Optional[str]
                       ) -> Tuple[List[Tuple[str, float]], int]:
    """Annotation value → ([(state wire value, entered-at wall seconds)],
    truncated-entry count). Accepts both the legacy list form (truncated
    count 0) and the object form a size-guarded journey switches to.
    Malformed values (operator downgrade, fat-fingered kubectl edit) parse
    as an empty journey rather than wedging the reconcile loop."""
    if not raw:
        return [], 0
    try:
        data = json.loads(raw)
        truncated = 0
        if isinstance(data, dict):
            truncated = int(data.get("truncated", 0))
            data = data.get("entries", [])
        return [(str(s), float(t)) for s, t in data], truncated
    except (ValueError, TypeError):
        logger.warning("unparseable journey annotation %r; starting fresh",
                       raw[:120])
        return [], 0


def parse_journey(raw: Optional[str]) -> List[Tuple[str, float]]:
    """Entries only — the read every consumer that cares about the tail
    (stuck detection, attribution, dwell math) uses; truncation clips the
    OLDEST entries, so those reads are unaffected by the size guard."""
    return parse_journey_full(raw)[0]


def dump_journey(entries: List[Tuple[str, float]],
                 truncated: int = 0) -> str:
    if truncated:
        return json.dumps({"truncated": truncated,
                           "entries": [[s, t] for s, t in entries]},
                          separators=(",", ":"))
    return json.dumps([[s, t] for s, t in entries],
                      separators=(",", ":"))


class JourneyRecorder:
    """Turns one state transition into the annotation updates that ride the
    provider's patch, and feeds the per-phase duration histogram.

    A re-write of the CURRENT state (idempotent reconcile passes, label
    flaps, a failed-over leader replaying its first tick) is a no-op — the
    journey never resets, so dwell times keep accumulating across leader
    failover (``test_obs`` pins this)."""

    def __init__(self, component: str, annotation_key: str, stuck_key: str,
                 clock: Optional[Clock] = None, metrics=None,
                 max_entries: int = MAX_JOURNEY_ENTRIES,
                 max_bytes: int = MAX_JOURNEY_BYTES):
        self.component = component
        self.annotation_key = annotation_key
        self.stuck_key = stuck_key
        self._clock = clock or RealClock()
        self._metrics = metrics
        self._max_entries = max_entries
        self._max_bytes = max_bytes

    def record(self, node, old_state: str,
               new_state: str) -> Dict[str, Optional[str]]:
        """→ annotation updates (None value = delete) for the transition
        ``old_state -> new_state`` on ``node``; empty dict when the journey
        already ends in ``new_state`` (not a real transition)."""
        entries, truncated = parse_journey_full(
            node.metadata.annotations.get(self.annotation_key))
        if entries and entries[-1][0] == new_state:
            return {}
        now = self._clock.wall()
        if entries and self._metrics is not None:
            prev_state, entered = entries[-1]
            self._metrics.observe(
                "phase_duration_seconds", max(0.0, now - entered),
                labels={"component": self.component,
                        "state": prev_state or "unknown"})
        entries.append((new_state, now))
        # size guard, oldest first: entry-count cap, then the serialized
        # byte cap (k8s annotation budget). The dropped count rides the
        # wire as the `truncated` marker so a clipped journey is never
        # mistaken for a short one; the TAIL — what stuck detection and
        # --timeline dwell math read — is always intact.
        while len(entries) > self._max_entries:
            entries.pop(0)
            truncated += 1
        while (len(entries) > 1 and self._max_bytes > 0
               and len(dump_journey(entries, truncated))
               > self._max_bytes):
            entries.pop(0)
            truncated += 1
        # entering a new state clears the stuck-reported marker so the NEXT
        # dwell gets its own (single) event
        return {self.annotation_key: dump_journey(entries, truncated),
                self.stuck_key: None}

    def entered_at(self, node, state: str) -> Optional[float]:
        """Wall time the node entered its CURRENT state, or None when the
        journey tail does not match ``state`` (label written out-of-band)."""
        entries = parse_journey(
            node.metadata.annotations.get(self.annotation_key))
        if entries and entries[-1][0] == state:
            return entries[-1][1]
        return None


class StuckNodeDetector:
    """Flags nodes dwelling in a state beyond its threshold: raises the
    ``stuck_nodes`` gauge every tick while the condition holds, and records
    exactly ONE Kubernetes Event per (node, state-entry) — the
    already-reported marker is a node annotation keyed to the entered-at
    timestamp, so a failed-over leader sees the prior report and stays
    quiet, while a LATER re-entry into the same state reports again."""

    def __init__(self, client, component: str, state_label: str,
                 annotation_key: str, stuck_key: str,
                 thresholds: Optional[Dict[str, float]] = None,
                 recorder=None, clock: Optional[Clock] = None,
                 metrics=None):
        self._client = client
        self.component = component
        self._state_label = state_label
        self._annotation_key = annotation_key
        self._stuck_key = stuck_key
        self.thresholds = dict(DEFAULT_STUCK_THRESHOLDS)
        if thresholds:
            self.thresholds.update(thresholds)
        self._recorder = recorder
        self._clock = clock or RealClock()
        self._metrics = metrics

    def check(self, nodes) -> Dict[str, List[Tuple[str, str, float]]]:
        """One detection pass over ``nodes`` → {"stuck": [(node, state,
        dwell_s)...], "reported": the subset that got a NEW event}."""
        now = self._clock.wall()
        stuck: List[Tuple[str, str, float]] = []
        reported: List[Tuple[str, str, float]] = []
        counts: Dict[str, int] = {}
        for node in nodes:
            state = node.metadata.labels.get(self._state_label) or ""
            threshold = self.thresholds.get(state, 0.0)
            if threshold <= 0:
                continue
            entries = parse_journey(
                node.metadata.annotations.get(self._annotation_key))
            if not entries or entries[-1][0] != state:
                continue  # no durable entered-at for this state
            entered = entries[-1][1]
            dwell = now - entered
            if dwell < threshold:
                continue
            name = node.metadata.name
            stuck.append((name, state, dwell))
            counts[state] = counts.get(state, 0) + 1
            marker = f"{state}@{entered!r}"
            if node.metadata.annotations.get(self._stuck_key) == marker:
                continue  # already reported for this state entry
            try:
                self._client.patch_node_metadata(
                    name, annotations={self._stuck_key: marker})
            except (ApiError, TimeoutError):
                # marker write failed: do NOT emit — an event without the
                # durable marker would duplicate on the next pass/leader
                logger.exception("could not persist stuck marker on %s",
                                 name)
                continue
            node.metadata.annotations = dict(node.metadata.annotations)
            node.metadata.annotations[self._stuck_key] = marker
            if self._recorder is not None:
                self._recorder.event(
                    node, "Warning", STUCK_EVENT_REASON,
                    f"Node {name} stuck in {state or 'unknown'} for "
                    f"{dwell:.0f}s (threshold {threshold:.0f}s, component "
                    f"{self.component})")
            reported.append((name, state, dwell))
            logger.warning("node %s stuck in %s for %.0fs (threshold %.0fs)",
                           name, state or "unknown", dwell, threshold)
        if self._metrics is not None:
            # publish a zero for every detectable state so recovered nodes
            # drop the gauge instead of leaving a stale series behind
            for state, threshold in self.thresholds.items():
                if threshold <= 0:
                    continue
                self._metrics.set_gauge(
                    "stuck_nodes", counts.get(state, 0),
                    labels={"component": self.component,
                            "state": state or "unknown"})
        return {"stuck": stuck, "reported": reported}
