"""Upgrade-state enum and key formats (a copy of the JAX package's
``upgrade/consts.py``; reference pkg/upgrade/consts.go).

Node upgrade state lives in the cluster as a node *label* whose value is one
of these states (consts.go:20-21, 42-67); auxiliary handshakes live in node
*annotations* (consts.go:22-41). State strings are wire format: the port and
the JAX package read each other's labels, so they must stay the same.
"""

from __future__ import annotations


class UpgradeState:
    """Values of the per-node upgrade-state label (reference consts.go:42-67).

    Pipeline order (upgrade_state.go:418-481):
    unknown → upgrade-required → cordon-required → wait-for-jobs-required →
    pod-deletion-required → drain-required → pod-restart-required →
    validation-required → uncordon-required → upgrade-done;
    any failure → upgrade-failed.
    """

    UNKNOWN = ""  # UpgradeStateUnknown: node not yet managed
    UPGRADE_REQUIRED = "upgrade-required"
    CORDON_REQUIRED = "cordon-required"
    WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
    POD_DELETION_REQUIRED = "pod-deletion-required"
    DRAIN_REQUIRED = "drain-required"
    POD_RESTART_REQUIRED = "pod-restart-required"
    VALIDATION_REQUIRED = "validation-required"
    UNCORDON_REQUIRED = "uncordon-required"
    DONE = "upgrade-done"
    FAILED = "upgrade-failed"

    ALL = (UNKNOWN, UPGRADE_REQUIRED, CORDON_REQUIRED, WAIT_FOR_JOBS_REQUIRED,
           POD_DELETION_REQUIRED, DRAIN_REQUIRED, POD_RESTART_REQUIRED,
           VALIDATION_REQUIRED, UNCORDON_REQUIRED, DONE, FAILED)

    # "In progress" = any state other than unknown/done/upgrade-required
    # (reference upgrade_state.go:1056-1062).
    IN_PROGRESS = (CORDON_REQUIRED, WAIT_FOR_JOBS_REQUIRED, POD_DELETION_REQUIRED,
                   DRAIN_REQUIRED, POD_RESTART_REQUIRED, VALIDATION_REQUIRED,
                   UNCORDON_REQUIRED, FAILED)


# Key-format templates. The reference interpolates a process-wide DriverName
# into "nvidia.com/%s-..." (util.go:97-134); we interpolate (domain, component)
# via an instance-scoped KeyFactory (util.py) so one process can manage
# "libtpu" and "tpu-device-plugin" (or "gpu" and "ofed") independently.
DEFAULT_DOMAIN = "tpu.dev"

STATE_LABEL_FMT = "{domain}/{component}-driver-upgrade-state"
SKIP_NODE_LABEL_FMT = "{domain}/{component}-driver-upgrade.skip"
SAFE_LOAD_ANNOTATION_FMT = (
    "{domain}/{component}-driver-upgrade.driver-wait-for-safe-load")
UPGRADE_REQUESTED_ANNOTATION_FMT = (
    "{domain}/{component}-driver-upgrade.upgrade-requested")
INITIAL_STATE_ANNOTATION_FMT = (
    "{domain}/{component}-driver-upgrade.node-initial-state.unschedulable")
WAIT_FOR_COMPLETION_START_FMT = (
    "{domain}/{component}-driver-upgrade-wait-for-completion-start-time")
VALIDATION_START_FMT = "{domain}/{component}-driver-upgrade-validation-start-time"
# Upgrade-journey observability (obs/journey.py; no reference analog): the
# durable per-node transition timeline with entered-at timestamps, and the
# stuck-node already-reported marker keyed to one state entry. Annotations,
# not labels — values are JSON / free-form and never selected on.
JOURNEY_ANNOTATION_FMT = "{domain}/{component}-driver-upgrade.journey"
STUCK_REPORTED_ANNOTATION_FMT = (
    "{domain}/{component}-driver-upgrade.journey-stuck-reported")

# Fixed thresholds (see BASELINE.md table).
VALIDATION_TIMEOUT_SECONDS = 600.0  # validation_manager.go:32
POD_FAILURE_RESTART_THRESHOLD = 10  # upgrade_state.go:968,973 (strictly >)
CACHE_SYNC_TIMEOUT_SECONDS = 10.0  # node_upgrade_state_provider.go:100-103
CACHE_SYNC_POLL_SECONDS = 1.0
