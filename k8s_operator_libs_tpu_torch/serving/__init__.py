"""The router tier above this package's ``models/serve.py`` replicas.

A port of the JAX package's ``serving/``, with the same names:

- :mod:`.pool`       — the replica registry: each replica is one serving
                       runtime on one node, mirrored onto the node with
                       the ``wire.py`` replica keys, its backpressure
                       scraped from its own ``tpu_workload_serve_*``
                       metrics text, its node's state (cordon,
                       quarantine, reclaim, upgrade state) refreshed
                       through the client;
- :mod:`.router`     — routing with session and shared-prefix affinity
                       and least outstanding work, QoS lanes, and the
                       drain-aware handoff: a replica whose node enters
                       the upgrade pipeline stops admitting before the
                       cordon lands, its queue goes to peers and its
                       in-flight requests live-migrate, and no request
                       is lost or served twice;
- :mod:`.autoscaler` — scale up on an SLO burn or on queue depth, scale
                       down on sustained idle, each decision journaled
                       as an Event and a gauge;
- :mod:`.sim`        — a deterministic replica runtime with no model;
- :mod:`.metrics`    — the ``tpu_router_*`` metric families.

It imports ``torch`` only where a :class:`BatcherRuntime` builds its
batcher or the router sizes a KV payload; nothing here picks or changes
a device (the batcher runs where its parameters live).
"""

from .autoscaler import Autoscaler, AutoscalerConfig
from .metrics import (ROUTER_GAUGE_FAMILIES, ROUTER_HISTOGRAM_FAMILIES,
                      ROUTER_PREFIX)
from .pool import (BatcherRuntime, NodeState, Replica, ReplicaPool,
                   parse_gauges)
from .router import (DEFAULT_LANE, DRAIN_STATES, LANE_WEIGHTS, LANES,
                     SHED_ORDER, RequestRouter, RouterRequest)
from .sim import SimReplicaRuntime, sim_tokens

__all__ = [
    "Autoscaler", "AutoscalerConfig", "BatcherRuntime", "DEFAULT_LANE",
    "DRAIN_STATES", "LANES", "LANE_WEIGHTS", "NodeState", "Replica",
    "ReplicaPool", "RequestRouter",
    "ROUTER_GAUGE_FAMILIES", "ROUTER_HISTOGRAM_FAMILIES", "ROUTER_PREFIX",
    "RouterRequest", "SHED_ORDER", "SimReplicaRuntime", "parse_gauges",
    "sim_tokens",
]
