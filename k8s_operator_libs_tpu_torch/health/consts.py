"""Health-verdict enum and the fleet-health label/annotation/taint keys.

Like the upgrade state machine's :mod:`..upgrade.consts`, everything the
health subsystem persists lives in the cluster as node labels, annotations,
and taints — the monitor itself holds only soft state (damping timers,
counter baselines) that an operator restart may safely lose. Verdict strings
are wire format (label values, metric label names, doc anchors) and must
stay stable, like the upgrade-state strings.

A copy of the JAX package's ``health/consts.py``; the port imports nothing
of that package.
"""

from __future__ import annotations


class HealthVerdict:
    """Per-node (and rolled-up per-slice) health verdict lattice.

    Ordered by severity::

        healthy < degraded < unhealthy-transient < unhealthy-persistent

    - ``healthy``: no probe signal firing.
    - ``degraded``: a signal is firing but has not yet survived the flap
      damping window — observed, not yet actionable.
    - ``unhealthy-transient``: a signal confirmed past damping; the node is
      quarantined but given a chance to recover on its own.
    - ``unhealthy-persistent``: confirmed signal outlived the persistence
      window (or the probe marked it inherently persistent, e.g. HBM ECC);
      the slice is handed to the upgrade state machine for repair.

    A slice's verdict is the WORST member verdict — an interconnect domain
    (a TPU slice's ICI, a GPU clique's NVLink) fails as a unit, so one unhealthy host condemns the whole slice.
    """

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY_TRANSIENT = "unhealthy-transient"
    UNHEALTHY_PERSISTENT = "unhealthy-persistent"

    ALL = (HEALTHY, DEGRADED, UNHEALTHY_TRANSIENT, UNHEALTHY_PERSISTENT)

    # verdicts that put (or keep) a slice in quarantine
    QUARANTINE = (UNHEALTHY_TRANSIENT, UNHEALTHY_PERSISTENT)

    _SEVERITY = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY_TRANSIENT: 2,
                 UNHEALTHY_PERSISTENT: 3}

    @classmethod
    def worst(cls, verdicts) -> str:
        """Fold member verdicts into the slice verdict (max severity)."""
        out = cls.HEALTHY
        for v in verdicts:
            if cls._SEVERITY[v] > cls._SEVERITY[out]:
                out = v
        return out


# The key constants themselves live in the wire-key registry
# (k8s_operator_libs_tpu_torch/wire.py) — WIRE001 keeps the port closed over
# it, so no `.dev/` key may be spelled (or constructed) here. Re-exported
# for the health package's historical import surface; see wire.py for
# each key's semantics:
# - VERDICT_LABEL carries the current non-healthy verdict (removed while
#   healthy, so an idle fleet generates zero label churn; cmd/status.py
#   renders "-" for both "healthy" and "health subsystem never ran");
# - the quarantine trio: label (verdict that caused it), NoSchedule taint
#   (belt-and-braces next to the cordon), reason annotation, and the
#   pre-quarantine-cordon marker (the initial-state idiom of
#   upgrade/upgrade_state.py applied to the health subsystem);
# - repair bookkeeping keys store wall time so the backoff survives
#   operator restarts — utils/clock.py ``Clock.wall``, never a bare
#   time.time();
# - signal-source annotations a node agent maintains; all optional — a
#   fleet without an agent simply has fewer probes firing.
from ..wire import (DOMAIN, HBM_ECC_ERRORS_ANNOTATION,
                    HEARTBEAT_ANNOTATION, ICI_LINK_ERRORS_ANNOTATION,
                    PRE_QUARANTINE_CORDON_ANNOTATION, QUARANTINE_LABEL,
                    QUARANTINE_LIFT_ANNOTATION,
                    QUARANTINE_REASON_ANNOTATION, QUARANTINE_TAINT_KEY,
                    REPAIR_ANNOTATION, REPAIR_ATTEMPTS_ANNOTATION,
                    REPAIR_LAST_ANNOTATION, VERDICT_LABEL)

QUARANTINE_TAINT_EFFECT = "NoSchedule"  # an effect, not a key: stays here
REPAIR_PENDING = "pending"              # annotation value, likewise

__all__ = [
    "DOMAIN", "HBM_ECC_ERRORS_ANNOTATION", "HEARTBEAT_ANNOTATION",
    "HealthVerdict", "ICI_LINK_ERRORS_ANNOTATION",
    "PRE_QUARANTINE_CORDON_ANNOTATION", "QUARANTINE_LABEL",
    "QUARANTINE_LIFT_ANNOTATION",
    "QUARANTINE_REASON_ANNOTATION", "QUARANTINE_TAINT_EFFECT",
    "QUARANTINE_TAINT_KEY", "REPAIR_ANNOTATION",
    "REPAIR_ATTEMPTS_ANNOTATION", "REPAIR_LAST_ANNOTATION",
    "REPAIR_PENDING", "VERDICT_LABEL",
]
