"""The per-node upgrade-state label's values and its key template.

A copy of ``UpgradeState`` and of the state label's template from the
JAX package's ``upgrade/consts.py``: the operator writes the label, the
serving tier reads it to drain a replica before its node is cordoned.
"""

from __future__ import annotations


class UpgradeState:
    """Values of the per-node upgrade-state label, in pipeline order:
    unknown -> upgrade-required -> cordon-required ->
    wait-for-jobs-required -> pod-deletion-required -> drain-required ->
    pod-restart-required -> validation-required -> uncordon-required ->
    upgrade-done; any failure -> upgrade-failed."""

    UNKNOWN = ""
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

    # "in progress": any state but unknown, upgrade-required and done
    IN_PROGRESS = (CORDON_REQUIRED, WAIT_FOR_JOBS_REQUIRED,
                   POD_DELETION_REQUIRED, DRAIN_REQUIRED, POD_RESTART_REQUIRED,
                   VALIDATION_REQUIRED, UNCORDON_REQUIRED, FAILED)


DEFAULT_DOMAIN = "tpu.dev"

STATE_LABEL_FMT = "{domain}/{component}-driver-upgrade-state"
