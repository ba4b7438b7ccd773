"""The cluster keys the serving tier and the capacity market read and
write.

A copy of the serving, health, reclaim and market keys of the JAX
package's ``wire.py``, each with the same string value: they are wire
format, written by one process and read by another (a router, an
operator of either package, a status view), so the two packages must
spell them alike. ``tests/test_torch_serving.py`` holds each value
against the reference's.
"""

from __future__ import annotations

# A node pulled from scheduling by the fleet-health verdict.
QUARANTINE_LABEL = "tpu.dev/health-quarantine"

# The cloud's spot-reclaim notice: the node is tainted before its
# accelerators disappear.
RECLAIM_TAINT_KEY = "tpu.dev/spot-reclaim"

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
