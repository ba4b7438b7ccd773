"""Classifier: fold raw probe signals into per-node and per-slice verdicts.

Three time-based mechanisms sit between a raw signal and an actionable
verdict (all driven by the injected clock, so tests sweep hours of modelled
time in milliseconds):

- **flap damping**: a signal must fire *continuously* for
  ``damping_seconds`` before it is confirmed. A bouncing signal resets its
  damping timer on every clear, so it can never confirm — it holds the node
  at ``degraded`` and triggers no remediation (the node-problem-detector
  lesson: reacting to flaps causes more downtime than the flaps).
- **persistence escalation**: a confirmed signal that stays confirmed for
  ``persist_seconds`` (or carried ``persistent_hint`` from its probe)
  escalates the verdict from ``unhealthy-transient`` to
  ``unhealthy-persistent`` — the remediation policy's repair trigger.
- **recovery streak**: per node, how long the verdict has been continuously
  ``healthy`` — quarantine is lifted only after a clean streak, so a node
  that goes quiet for one tick does not bounce in and out of service.

The slice rollup delegates grouping to the same
:class:`~..upgrade.groups.NodeGrouper` the upgrade state machine uses
(``TPUSliceGrouper`` in production), so health and upgrades agree on what a
failure domain is by construction.

A copy of the JAX package's ``health/classifier.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from ..core.objects import Node
from ..upgrade.groups import NodeGrouper, SingleNodeGrouper
from ..utils.clock import Clock, RealClock
from .consts import HealthVerdict
from .probes import Signal

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ClassifierConfig:
    """Damping / escalation knobs (seconds of clock time)."""

    damping_seconds: float = 60.0
    persist_seconds: float = 300.0

    def validate(self) -> None:
        if self.damping_seconds < 0:
            raise ValueError("damping_seconds must be >= 0")
        if self.persist_seconds < 0:
            raise ValueError("persist_seconds must be >= 0")


@dataclasses.dataclass
class NodeHealth:
    """One node's classified state for this tick."""

    node: str
    verdict: str
    reasons: List[str] = dataclasses.field(default_factory=list)
    healthy_for: float = 0.0  # continuous healthy streak, seconds


@dataclasses.dataclass
class SliceHealth:
    """One failure domain's rolled-up state (worst member verdict)."""

    key: str                      # grouper key: "slice/<id>" or node name
    verdict: str
    members: List[NodeHealth] = dataclasses.field(default_factory=list)

    @property
    def node_names(self) -> List[str]:
        return [m.node for m in self.members]

    @property
    def reasons(self) -> List[str]:
        return [r for m in self.members for r in m.reasons]

    def min_healthy_for(self) -> float:
        """The slice's clean streak = its least-recovered member's."""
        return min((m.healthy_for for m in self.members), default=0.0)


class HealthClassifier:
    def __init__(self, clock: Optional[Clock] = None,
                 config: Optional[ClassifierConfig] = None):
        self._clock = clock or RealClock()
        self.config = config or ClassifierConfig()
        self.config.validate()
        # (node, probe) -> when the current continuous firing run started
        self._firing_since: Dict[Tuple[str, str], float] = {}
        # (node, probe) -> when the signal survived damping
        self._confirmed_at: Dict[Tuple[str, str], float] = {}
        # node -> when the current continuous healthy run started
        self._healthy_since: Dict[str, float] = {}

    # ------------------------------------------------------------- node pass

    def classify(self, signals: List[Signal],
                 nodes: List[Node]) -> Dict[str, NodeHealth]:
        """One tick: update damping state from this tick's signals and emit
        a verdict for every node in the snapshot."""
        now = self._clock.now()
        by_node: Dict[str, List[Signal]] = {}
        for sig in signals:
            by_node.setdefault(sig.node, []).append(sig)

        # flap damping: any (node, probe) that did NOT fire this tick resets
        firing_now = {(s.node, s.probe) for s in signals}
        for key in list(self._firing_since):
            if key not in firing_now:
                del self._firing_since[key]
                self._confirmed_at.pop(key, None)

        out: Dict[str, NodeHealth] = {}
        node_names = {n.metadata.name for n in nodes}
        for name in sorted(node_names):
            out[name] = self._classify_node(name, by_node.get(name, []), now)
        # forget streak state of nodes that left the fleet
        for name in list(self._healthy_since):
            if name not in node_names:
                del self._healthy_since[name]
        return out

    def _classify_node(self, name: str, sigs: List[Signal],
                       now: float) -> NodeHealth:
        verdict = HealthVerdict.HEALTHY
        reasons: List[str] = []
        for sig in sigs:
            key = (name, sig.probe)
            since = self._firing_since.setdefault(key, now)
            if now - since < self.config.damping_seconds:
                # inside the damping window: observed, not yet actionable
                verdict = HealthVerdict.worst(
                    (verdict, HealthVerdict.DEGRADED))
                reasons.append(f"[damping] {sig.probe}: {sig.message}")
                continue
            confirmed_at = self._confirmed_at.setdefault(key, now)
            persistent = (sig.persistent_hint
                          or now - confirmed_at >= self.config.persist_seconds)
            sig_verdict = (HealthVerdict.UNHEALTHY_PERSISTENT if persistent
                           else HealthVerdict.UNHEALTHY_TRANSIENT)
            verdict = HealthVerdict.worst((verdict, sig_verdict))
            reasons.append(f"{sig.probe}: {sig.message}")

        if verdict == HealthVerdict.HEALTHY:
            healthy_since = self._healthy_since.setdefault(name, now)
            healthy_for = now - healthy_since
        else:
            self._healthy_since.pop(name, None)
            healthy_for = 0.0
        return NodeHealth(node=name, verdict=verdict, reasons=reasons,
                          healthy_for=healthy_for)

    # ------------------------------------------------------------ slice pass

    @staticmethod
    def rollup(node_health: Dict[str, NodeHealth], nodes: List[Node],
               grouper: Optional[NodeGrouper] = None) -> List[SliceHealth]:
        """Roll node verdicts up to slice verdicts: one ICI domain, one
        verdict — the worst of its members'."""
        grouper = grouper or SingleNodeGrouper()
        groups: Dict[str, List[NodeHealth]] = {}
        for node in nodes:
            nh = node_health.get(node.metadata.name)
            if nh is None:
                continue
            groups.setdefault(grouper.group_key(node), []).append(nh)
        out = []
        for key in sorted(groups):
            members = sorted(groups[key], key=lambda m: m.node)
            out.append(SliceHealth(
                key=key,
                verdict=HealthVerdict.worst(m.verdict for m in members),
                members=members))
        return out
