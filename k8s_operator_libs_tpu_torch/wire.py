"""The cluster keys the serving tier and the capacity market read and
write.

A copy of the JAX package's ``wire.py``, each key with the same string
value: they are wire format, written by one process and read by another
(a router, an operator of either package, a status view), so the two
packages must spell them alike, and an operator of either package reads
the other's nodes. ``tests/test_torch_serving.py`` and
``tests/test_torch_health.py`` hold each value against the reference's.
The values keep the reference's words on GPU nodes too:
``ICI_LINK_ERRORS_ANNOTATION`` is the interconnect error counter a node
agent keeps, NVLink's on a GPU node.
"""

from __future__ import annotations

# The domain every key lives under.
DOMAIN = "tpu.dev"

# The fleet-health verdict surface: the verdict label carries a node's
# current non-healthy verdict; a quarantined node carries the label (the
# verdict that caused it), a NoSchedule taint and a reason.
VERDICT_LABEL = "tpu.dev/health"
# A node pulled from scheduling by the fleet-health verdict.
QUARANTINE_LABEL = "tpu.dev/health-quarantine"
QUARANTINE_TAINT_KEY = "tpu.dev/health-quarantine"
QUARANTINE_REASON_ANNOTATION = "tpu.dev/health.quarantine-reason"
# Set when the node was already unschedulable at quarantine time: lifting
# the quarantine must not remove a cordon it did not create.
PRE_QUARANTINE_CORDON_ANNOTATION = "tpu.dev/health.pre-quarantine-cordon"
# The durable lift intent: stamped (wall seconds) as the first write of a
# quarantine lift and cleared by its last, so the degraded-mode safety
# pass or the next tick can finish a lift that was cut off.
QUARANTINE_LIFT_ANNOTATION = "tpu.dev/health.quarantine-lift"

# Repair bookkeeping: the in-flight marker, the attempt counter behind
# the exponential backoff, and the wall-clock stamp of the last repair.
REPAIR_ANNOTATION = "tpu.dev/health.repair"
REPAIR_ATTEMPTS_ANNOTATION = "tpu.dev/health.repair-attempts"
REPAIR_LAST_ANNOTATION = "tpu.dev/health.repair-last"

# Signal sources a node agent maintains, all optional: its heartbeat
# (wall seconds) and cumulative interconnect and memory ECC error counts.
HEARTBEAT_ANNOTATION = "tpu.dev/health.heartbeat"
ICI_LINK_ERRORS_ANNOTATION = "tpu.dev/health.ici-link-errors"
HBM_ECC_ERRORS_ANNOTATION = "tpu.dev/health.hbm-ecc-errors"

# The cloud's spot-reclaim notice: the node is tainted before its
# accelerators disappear, and the deadline (wall seconds) is stamped.
RECLAIM_TAINT_KEY = "tpu.dev/spot-reclaim"
RECLAIM_DEADLINE_ANNOTATION = "tpu.dev/spot-reclaim-deadline"

# Every pod of a placed workload carries it (the scheduler's placement
# label; the upgrade library's deletion filter and wait-for-completion
# selector match on it).
WORKLOAD_LABEL = "tpu.dev/workload"

# The replica registry mirrored onto the node that hosts a replica: its
# id, its placement weight and its HTTP base URL.
REPLICA_ID_LABEL = "tpu.dev/serving-replica"
REPLICA_WEIGHT_LABEL = "tpu.dev/serving-replica-weight"
REPLICA_ENDPOINT_ANNOTATION = "tpu.dev/serving.endpoint"

# Stamped by the router when it decides to drain a replica, before the
# operator cordons the node (value: "<reason>@<wall seconds>").
DRAIN_INTENT_ANNOTATION = "tpu.dev/serving.drain-intent"

# Stamped by the router on the donor node when live KV migration of its
# in-flight requests begins (value: "<in-flight count>@<wall seconds>").
MIGRATION_INTENT_ANNOTATION = "tpu.dev/serving.migration-intent"

# The KV migration wire version the node's replica speaks.
KV_PAYLOAD_VERSION_ANNOTATION = "tpu.dev/serving.kv-payload-version"

# The QoS lane a replica is dedicated to (absent: it serves every lane).
LANE_LABEL = "tpu.dev/serving.lane"

# The capacity market's lease contract between training and serving
# (``market/arbiter.py`` is its only writer). The market owner of every
# node of a managed slice: ``training`` | ``serving`` | ``draining`` (a
# trade in flight, either direction).
MARKET_OWNER_LABEL = "tpu.dev/market.owner"
# The lease on the slice's anchor node (its first member):
# "<phase>:<decision id>@<wall seconds>", phase one of training,
# preempting, serving, returning; a restarted arbiter resumes from it.
MARKET_LEASE_ANNOTATION = "tpu.dev/market.lease"
# The arbiter's last decision for the slice, as compact JSON (id, action,
# exchange rate, serving pressure, training value, wall time).
MARKET_DECISION_ANNOTATION = "tpu.dev/market.decision"
