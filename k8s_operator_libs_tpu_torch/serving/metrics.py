"""The closed ``tpu_router_*`` metric-family tables.

A copy of the JAX package's ``serving/metrics.py``. Every family the
router tier emits is declared here, and each has its HELP text in
``obs/metrics.py:HELP_TEXTS``. The router's hub renders under
:data:`ROUTER_PREFIX`, so a combined scrape of a replica
(``tpu_workload_*``) and the router (``tpu_router_*``) never collides.
"""

from __future__ import annotations

ROUTER_PREFIX = "tpu_router"

# gauge families the pool/router/autoscaler emit through the hub (full
# exposed names)
ROUTER_GAUGE_FAMILIES = (
    "tpu_router_replicas",
    "tpu_router_replicas_admitting",
    "tpu_router_replicas_draining",
    "tpu_router_replicas_failed",
    "tpu_router_queue_depth",
    "tpu_router_outstanding_requests",
    "tpu_router_requests_routed",
    "tpu_router_requests_completed",
    "tpu_router_requests_rerouted",
    "tpu_router_scale_target",
    "tpu_router_scale_ups",
    "tpu_router_scale_downs",
    "tpu_router_migration_attempts",
    "tpu_router_migration_success",
    "tpu_router_migration_fallbacks",
    # per-tenant QoS lanes (labelled by lane)
    "tpu_router_lane_queue_depth",
    "tpu_router_lane_shed",
    "tpu_router_lane_completed",
)

# histogram families (bucket ladders from obs/metrics.py)
ROUTER_HISTOGRAM_FAMILIES = (
    "tpu_router_handoff_requests",
    "tpu_router_replica_queue_depth",
    "tpu_router_migration_transfer_seconds",
    "tpu_router_migration_transfer_bytes",
    "tpu_router_lane_queue_wait_seconds",
)
