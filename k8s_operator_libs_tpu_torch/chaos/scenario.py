"""Declarative chaos scenarios: spec dicts → validated fault schedules.

A scenario is a plain dict (YAML-able)::

    {"name": "correlated-crashloop",
     "tick_seconds": 15.0, "max_ticks": 400,
     "fleet": {"slices": 2, "hosts_per_slice": 4, "solo_nodes": 1},
     "max_unavailable": "50%",
     "upgrade_at": 30.0,          # DS revision bump driving a rollout
     "faults": [
         {"type": "driver-crashloop", "at": 60, "duration": 90,
          "slices": [0, 1], "restartCount": 12},
         {"type": "leader-loss", "at": 120},
     ]}

Each fault entry is handed to the parser registered for its ``type`` in
:data:`FAULT_PARSERS` — the dispatch table closed over
:data:`~.faults.FAULT_TYPES` in both directions. Parsers
validate the type-specific params and resolve slice indexes to node
names, so a malformed scenario fails at parse time with the field named,
never mid-campaign.

:func:`random_scenario` composes a seeded-random scenario (correlated
multi-slice faults included) — ``python -m
k8s_operator_libs_tpu_torch.chaos --seeds N`` runs N of them.

A slice here is one upgrade group of hosts (``pool-{i}-h{j}``), on GPU
nodes an NVLink clique (:func:`.campaign.build_fleet`). A copy of the JAX
package's ``chaos/scenario.py``; the port imports nothing of that
package.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, List, Optional

from .faults import FAULT_TYPES, FaultEvent


@dataclasses.dataclass
class FleetSpec:
    slices: int = 2
    hosts_per_slice: int = 4
    solo_nodes: int = 1

    def slice_hosts(self, index: int) -> List[str]:
        return [f"pool-{index}-h{i}" for i in range(self.hosts_per_slice)]

    def all_slice_hosts(self) -> List[str]:
        return [h for i in range(self.slices) for h in self.slice_hosts(i)]

    @property
    def total_nodes(self) -> int:
        return self.slices * self.hosts_per_slice + self.solo_nodes


@dataclasses.dataclass
class Scenario:
    name: str
    fleet: FleetSpec
    faults: List[FaultEvent]
    tick_seconds: float = 15.0
    max_ticks: int = 400
    max_unavailable: str = "50%"
    upgrade_at: Optional[float] = 30.0

    def describe(self) -> str:
        lines = [f"scenario {self.name}: {self.fleet.slices}x"
                 f"{self.fleet.hosts_per_slice}-host slices + "
                 f"{self.fleet.solo_nodes} solo, "
                 f"maxUnavailable={self.max_unavailable}, "
                 f"upgrade_at={self.upgrade_at}"]
        lines += [f"  {ev.describe()}" for ev in self.faults]
        return "\n".join(lines)


class ScenarioError(ValueError):
    """A scenario spec failed validation; the message names the field."""


def _targets(entry: Dict[str, Any], fleet: FleetSpec,
             default_slices: Optional[List[int]] = None) -> List[str]:
    """Resolve ``nodes`` (explicit names) or ``slices`` (indexes) to node
    names; falls back to ``default_slices``."""
    if entry.get("nodes"):
        return list(entry["nodes"])
    indexes = entry.get("slices", default_slices or [0])
    out: List[str] = []
    for ix in indexes:
        if not 0 <= int(ix) < fleet.slices:
            raise ScenarioError(
                f"fault {entry.get('type')}: slice index {ix} out of "
                f"range (fleet has {fleet.slices})")
        out.extend(fleet.slice_hosts(int(ix)))
    return out


def _window(entry: Dict[str, Any], default_duration: float) -> Dict[str, float]:
    at = float(entry.get("at", 0.0))
    duration = float(entry.get("duration", default_duration))
    if at < 0 or duration < 0:
        raise ScenarioError(f"fault {entry.get('type')}: negative at/duration")
    return {"at": at, "duration": duration}


def _rate(entry: Dict[str, Any], key: str = "rate",
          default: float = 0.2) -> float:
    rate = float(entry.get(key, default))
    if not 0.0 <= rate < 1.0:
        raise ScenarioError(
            f"fault {entry.get('type')}: {key} must be in [0, 1), "
            f"got {rate}")
    return rate


def _parse_apiserver_latency(entry, fleet) -> FaultEvent:
    w = _window(entry, 120.0)
    ml = float(entry.get("maxLatencySeconds", 1.0))
    if ml <= 0:
        raise ScenarioError("apiserver-latency: maxLatencySeconds must be "
                            "positive")
    return FaultEvent("apiserver-latency", params={"max_latency_s": ml}, **w)


def _parse_apiserver_flake(entry, fleet) -> FaultEvent:
    w = _window(entry, 120.0)
    return FaultEvent("apiserver-flake", params={"rate": _rate(entry)}, **w)


def _parse_conflict_storm(entry, fleet) -> FaultEvent:
    w = _window(entry, 120.0)
    return FaultEvent("conflict-storm", params={"rate": _rate(entry)}, **w)


def _parse_watch_lag(entry, fleet) -> FaultEvent:
    w = _window(entry, 120.0)
    lag = float(entry.get("lagSeconds", 5.0))
    if lag <= 0:
        raise ScenarioError("watch-lag: lagSeconds must be positive")
    return FaultEvent("watch-lag", params={"lag_s": lag}, **w)


def _parse_driver_crashloop(entry, fleet) -> FaultEvent:
    w = _window(entry, 90.0)
    restarts = int(entry.get("restartCount", 12))
    if restarts <= 0:
        raise ScenarioError("driver-crashloop: restartCount must be positive")
    return FaultEvent("driver-crashloop", targets=_targets(entry, fleet),
                      params={"restart_count": restarts}, **w)


def _parse_node_notready(entry, fleet) -> FaultEvent:
    w = _window(entry, 60.0)
    return FaultEvent("node-notready", targets=_targets(entry, fleet), **w)


def _parse_leader_loss(entry, fleet) -> FaultEvent:
    w = _window(entry, 0.0)  # 0 = injector defaults to 1.5x the lease
    return FaultEvent("leader-loss", params={
        k: entry[k] for k in ("identity", "lease_name", "lease_namespace")
        if k in entry}, **w)


def _parse_eviction_storm(entry, fleet) -> FaultEvent:
    w = _window(entry, 0.0)
    count = int(entry.get("count", 3))
    if count <= 0:
        raise ScenarioError("eviction-storm: count must be positive")
    params: Dict[str, Any] = {"count": count}
    if entry.get("selector"):
        params["selector"] = dict(entry["selector"])
    return FaultEvent("eviction-storm", targets=_targets(entry, fleet),
                      params=params, **w)


def _parse_spot_reclaim(entry, fleet) -> FaultEvent:
    w = _window(entry, 180.0)
    deadline = float(entry.get("deadlineSeconds", 120.0))
    if deadline <= 0:
        raise ScenarioError("spot-reclaim: deadlineSeconds must be positive")
    return FaultEvent("spot-reclaim", targets=_targets(entry, fleet),
                      params={"deadline_s": deadline}, **w)


def _parse_replica_kill(entry, fleet) -> FaultEvent:
    # the window is the OUTAGE: the replica process on the target nodes
    # is dead until the window closes (then the campaign's serving tier
    # may respawn a fresh generation there)
    w = _window(entry, 120.0)
    if w["duration"] <= 0:
        raise ScenarioError("replica-kill: duration must be positive "
                            "(a zero-length kill window kills nothing)")
    return FaultEvent("replica-kill", targets=_targets(entry, fleet), **w)


def _parse_metrics_flake(entry, fleet) -> FaultEvent:
    w = _window(entry, 90.0)
    if w["duration"] <= 0:
        raise ScenarioError("metrics-flake: duration must be positive")
    return FaultEvent("metrics-flake", targets=_targets(entry, fleet), **w)


def _parse_mid_stream_kill(entry, fleet) -> FaultEvent:
    # the window is the OUTAGE, like replica-kill — but the kill itself
    # waits until the target replica holds streaming requests in flight
    w = _window(entry, 120.0)
    if w["duration"] <= 0:
        raise ScenarioError("mid-stream-kill: duration must be positive "
                            "(a zero-length kill window kills nothing)")
    return FaultEvent("mid-stream-kill", targets=_targets(entry, fleet),
                      **w)


def _parse_flash_crowd(entry, fleet) -> FaultEvent:
    # pure traffic, no node targets: the ServingTier submits an extra
    # requestsPerTick requests (seeded lane mix) while the window is open
    w = _window(entry, 120.0)
    if w["duration"] <= 0:
        raise ScenarioError("flash-crowd: duration must be positive")
    rate = int(entry.get("requestsPerTick", 8))
    if rate <= 0:
        raise ScenarioError("flash-crowd: requestsPerTick must be "
                            "positive")
    return FaultEvent("flash-crowd", params={"requests_per_tick": rate},
                      **w)


def _parse_kv_transfer_flake(entry, fleet) -> FaultEvent:
    w = _window(entry, 90.0)
    if w["duration"] <= 0:
        raise ScenarioError("kv-transfer-flake: duration must be "
                            "positive")
    return FaultEvent("kv-transfer-flake", targets=_targets(entry, fleet),
                      params={"rate": _rate(entry, default=0.5)}, **w)


def _parse_apiserver_blackout(entry, fleet) -> FaultEvent:
    # a full outage: every client call 5xxs for the window (lease +
    # create_event exempt — see faults.py); no targets, no rate
    w = _window(entry, 120.0)
    if w["duration"] <= 0:
        raise ScenarioError("apiserver-blackout: duration must be "
                            "positive")
    return FaultEvent("apiserver-blackout", **w)


def _parse_operator_crash(entry, fleet) -> FaultEvent:
    # instant: the named identity (default: whoever leads when the
    # fault lands) is killed and reboots fresh — duration is meaningless
    w = _window(entry, 0.0)
    params: Dict[str, Any] = {}
    if entry.get("identity"):
        params["identity"] = str(entry["identity"])
    return FaultEvent("operator-crash", params=params, **w)


# fault type -> parser; its keys equal FAULT_TYPES exactly (an
# unparseable fault type can never register)
FAULT_PARSERS: Dict[str, Callable[[Dict[str, Any], FleetSpec], FaultEvent]] = {
    "apiserver-latency": _parse_apiserver_latency,
    "apiserver-flake": _parse_apiserver_flake,
    "conflict-storm": _parse_conflict_storm,
    "watch-lag": _parse_watch_lag,
    "driver-crashloop": _parse_driver_crashloop,
    "node-notready": _parse_node_notready,
    "leader-loss": _parse_leader_loss,
    "eviction-storm": _parse_eviction_storm,
    "spot-reclaim": _parse_spot_reclaim,
    "replica-kill": _parse_replica_kill,
    "metrics-flake": _parse_metrics_flake,
    "mid-stream-kill": _parse_mid_stream_kill,
    "kv-transfer-flake": _parse_kv_transfer_flake,
    "flash-crowd": _parse_flash_crowd,
    "apiserver-blackout": _parse_apiserver_blackout,
    "operator-crash": _parse_operator_crash,
}


def parse_scenario(spec: Dict[str, Any]) -> Scenario:
    fleet_spec = spec.get("fleet", {})
    fleet = FleetSpec(
        slices=int(fleet_spec.get("slices", 2)),
        hosts_per_slice=int(fleet_spec.get("hosts_per_slice", 4)),
        solo_nodes=int(fleet_spec.get("solo_nodes", 1)))
    if fleet.slices < 1 or fleet.hosts_per_slice < 1:
        raise ScenarioError("fleet: slices and hosts_per_slice must be >= 1")
    faults: List[FaultEvent] = []
    for entry in spec.get("faults", []):
        ftype = entry.get("type")
        parser = FAULT_PARSERS.get(ftype)
        if parser is None:
            raise ScenarioError(
                f"unknown fault type {ftype!r} (known: "
                f"{', '.join(FAULT_TYPES)})")
        faults.append(parser(entry, fleet))
    upgrade_at = spec.get("upgrade_at", 30.0)
    return Scenario(
        name=str(spec.get("name", "unnamed")),
        fleet=fleet,
        faults=sorted(faults, key=lambda e: e.at),
        tick_seconds=float(spec.get("tick_seconds", 15.0)),
        max_ticks=int(spec.get("max_ticks", 400)),
        max_unavailable=str(spec.get("max_unavailable", "50%")),
        upgrade_at=None if upgrade_at is None else float(upgrade_at))


def random_scenario(seed: int) -> Scenario:
    """Compose a seeded-random scenario: a rolling upgrade in flight plus
    2–4 correlated faults drawn from the full catalog. The budget is
    always >= one slice (maxUnavailable=50% of a 2-slice fleet), so the
    oversized-group deadlock breaker never legitimately exceeds it and
    the budget invariant stays strict."""
    rng = random.Random(seed)
    fleet = {"slices": 2, "hosts_per_slice": 4,
             "solo_nodes": rng.choice([0, 1])}
    horizon = 1800.0
    picks = rng.sample(list(FAULT_TYPES), k=rng.randint(2, 4))
    faults: List[Dict[str, Any]] = []
    for ftype in picks:
        at = rng.uniform(40.0, horizon / 2)
        entry: Dict[str, Any] = {"type": ftype, "at": round(at, 1)}
        if ftype == "driver-crashloop":
            entry.update(duration=rng.choice([60.0, 120.0]),
                         slices=sorted(rng.sample(
                             range(fleet["slices"]),
                             k=rng.randint(1, fleet["slices"]))))
        elif ftype == "node-notready":
            entry.update(duration=rng.choice([45.0, 90.0]),
                         slices=[rng.randrange(fleet["slices"])])
        elif ftype == "spot-reclaim":
            entry.update(duration=240.0, deadlineSeconds=120.0,
                         slices=[rng.randrange(fleet["slices"])])
        elif ftype == "eviction-storm":
            entry.update(count=rng.randint(2, 5),
                         slices=[rng.randrange(fleet["slices"])])
        elif ftype == "apiserver-latency":
            entry.update(duration=120.0,
                         maxLatencySeconds=rng.choice([0.5, 1.0, 2.0]))
        elif ftype in ("apiserver-flake", "conflict-storm"):
            entry.update(duration=rng.choice([90.0, 180.0]),
                         rate=rng.choice([0.1, 0.25, 0.4]))
        elif ftype == "watch-lag":
            entry.update(duration=120.0,
                         lagSeconds=rng.choice([3.0, 8.0]))
        elif ftype == "replica-kill":
            entry.update(duration=rng.choice([60.0, 120.0]),
                         slices=[rng.randrange(fleet["slices"])])
        elif ftype == "mid-stream-kill":
            entry.update(duration=rng.choice([60.0, 120.0]),
                         slices=[rng.randrange(fleet["slices"])])
        elif ftype == "kv-transfer-flake":
            entry.update(duration=rng.choice([60.0, 120.0]),
                         rate=rng.choice([0.3, 0.6]),
                         slices=sorted(rng.sample(
                             range(fleet["slices"]),
                             k=rng.randint(1, fleet["slices"]))))
        elif ftype == "metrics-flake":
            entry.update(duration=rng.choice([60.0, 120.0]),
                         slices=sorted(rng.sample(
                             range(fleet["slices"]),
                             k=rng.randint(1, fleet["slices"]))))
        elif ftype == "flash-crowd":
            entry.update(duration=rng.choice([120.0, 180.0]),
                         requestsPerTick=rng.choice([6, 10]))
        elif ftype == "apiserver-blackout":
            entry.update(duration=rng.choice([90.0, 180.0]))
        # leader-loss and operator-crash need no params: the injector
        # partitions/kills whoever holds the lease when the fault lands
        faults.append(entry)
    return parse_scenario({
        "name": f"seed-{seed}",
        "fleet": fleet,
        "max_unavailable": "50%",
        "upgrade_at": rng.choice([30.0, 75.0]),
        "max_ticks": 600,
        "faults": faults,
    })
