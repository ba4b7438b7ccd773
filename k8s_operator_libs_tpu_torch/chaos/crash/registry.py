"""The durable-write site registry + the write classifier.

A SITE is one durable-write choke point: a family of cluster writes
that, interrupted (or immediately followed by a crash), leaves a
distinct durable-state configuration the restarted operator must
recover from. The registry has two halves:

- :data:`SITE_WIRE_KEYS` — site name -> the names of the port's
  ``wire.py`` constants it stamps, as a pure literal dict (every claimed
  name exists in ``wire.py``, and no key is claimed by two sites).
  Sites whose keys are KeyFactory *templates* (the per-component state
  label / journey annotation — deliberately excluded from wire.py, see
  its docstring) claim an empty tuple.
- :func:`classify` — the runtime half: maps one client write call
  (method name + payload) to its site, used by the explorer's
  :class:`~.explorer.CrashGate` to count occurrences and
  fire kills, and by the recording pass that proves every registered
  site actually occurs in the sweep scenario.

The chaos injector's own writes (reclaim taints — the CLOUD's keys,
written by the fault injector playing the external agent) are not
operator durable writes and are invisible here by construction: the
injector patches through the raw cluster client, never through the
gated chaos boundary.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# site -> wire-key constant names it stamps.
SITE_WIRE_KEYS: Dict[str, Tuple[str, ...]] = {
    # the provider choke point: state label + journey annotation + the
    # upgrade bookkeeping annotations ride one strategic-merge patch
    # (KeyFactory templates, not wire.py keys)
    "state-journey": (),
    # the same choke point writing the upgrade-required decree — the
    # fleet-wide rollout fan-out, worth its own crash points because it
    # is the highest-volume durable write in the system
    "rollout-decree": (),
    # cordon/uncordon flips (patch_node_unschedulable) — no key at all,
    # but the single most availability-relevant durable bit
    "cordon-flip": (),
    "health-verdict": ("VERDICT_LABEL",),
    "health-quarantine": ("QUARANTINE_LABEL", "QUARANTINE_TAINT_KEY",
                          "QUARANTINE_REASON_ANNOTATION",
                          "PRE_QUARANTINE_CORDON_ANNOTATION",
                          "QUARANTINE_LIFT_ANNOTATION"),
    "health-repair": ("REPAIR_ANNOTATION",
                      "REPAIR_ATTEMPTS_ANNOTATION",
                      "REPAIR_LAST_ANNOTATION"),
    "market-lease": ("MARKET_OWNER_LABEL", "MARKET_LEASE_ANNOTATION",
                     "MARKET_DECISION_ANNOTATION"),
    "drain-intent": ("DRAIN_INTENT_ANNOTATION",),
    "migration-intent": ("MIGRATION_INTENT_ANNOTATION",),
    "replica-registry": ("REPLICA_ID_LABEL", "REPLICA_WEIGHT_LABEL",
                         "REPLICA_ENDPOINT_ANNOTATION",
                         "KV_PAYLOAD_VERSION_ANNOTATION", "LANE_LABEL"),
}

# which process issues each site's writes in the campaign: "operator"
# sites kill the issuing candidate mid-call (the sharp interleaving);
# "router" sites are stamped by the serving tier, so the explorer kills
# the LEADER operator at the write boundary instead (the write itself
# proceeds — the router process is not the one under crash test)
SITE_PROCESS: Dict[str, str] = {
    "state-journey": "operator",
    "rollout-decree": "operator",
    "cordon-flip": "operator",
    "health-verdict": "operator",
    "health-quarantine": "operator",
    "health-repair": "operator",
    "market-lease": "operator",
    "drain-intent": "router",
    "migration-intent": "router",
    "replica-registry": "router",
}

SITES: Tuple[str, ...] = tuple(SITE_WIRE_KEYS)

_STATE_LABEL_SUFFIX = "-driver-upgrade-state"
_UPGRADE_KEY_MARKER = "-driver-upgrade"
_DECREE_VALUE = "upgrade-required"


def _payload(args, kwargs, name: str, position: int) -> Dict[str, Any]:
    """The labels/annotations dict passed to a patch call, by keyword or
    position (position counts from 0 AFTER the node name)."""
    value = kwargs.get(name)
    if value is None and len(args) > position + 1:
        value = args[position + 1]
    return value or {}


def classify(method: str, args, kwargs) -> Optional[str]:
    """One client write call -> its durable-write site, or None for
    writes outside the registry (pod deletes/evictions — DaemonSet-
    recreated process state; lease CAS — the elector's own protocol,
    exercised by the leader-loss fault; Events — advisory).

    Precedence within one ``patch_node_metadata`` payload follows the
    stamping subsystems: a repair injection carries REPAIR_* plus the
    component's upgrade-requested annotation and must classify as
    health-repair, so the specific wire-key checks run before the
    upgrade-template fallthrough."""
    from ... import wire

    def names(keys: Tuple[str, ...]):
        return {getattr(wire, k) for k in keys}

    if method == "patch_node_unschedulable":
        return "cordon-flip"
    if method == "patch_node_taints":
        patch = args[1] if len(args) > 1 else kwargs.get("taint_patch")
        for entry in patch or []:
            if entry.get("key") in names(
                    SITE_WIRE_KEYS["health-quarantine"]):
                return "health-quarantine"
        return None
    if method != "patch_node_metadata":
        return None
    labels = _payload(args, kwargs, "labels", 0)
    annotations = _payload(args, kwargs, "annotations", 1)
    keys = set(labels) | set(annotations)
    for site in ("health-repair", "health-quarantine", "health-verdict",
                 "market-lease", "drain-intent", "migration-intent",
                 "replica-registry"):
        if keys & names(SITE_WIRE_KEYS[site]):
            return site
    for key, value in labels.items():
        if key.endswith(_STATE_LABEL_SUFFIX):
            return ("rollout-decree" if value == _DECREE_VALUE
                    else "state-journey")
    if any(_UPGRADE_KEY_MARKER in key for key in keys):
        return "state-journey"
    return None
