"""Fleet health monitoring & auto-remediation.

Closes the loop from raw node/pod signals to slice-atomic repair:

- :mod:`.probes` — pluggable signal sources over the cluster snapshot
  (driver crashloop, heartbeat staleness, node conditions, ICI/HBM error
  counters);
- :mod:`.classifier` — flap damping + persistence escalation folding
  signals into per-node :class:`HealthVerdict`\\ s, rolled up to slice
  verdicts through the same ``NodeGrouper`` the upgrade machine uses;
- :mod:`.remediation` — quarantine (cordon + taint + label) and repair by
  injecting the whole slice into the upgrade state machine's pipeline,
  sharing its maxUnavailable budget;
- :mod:`.monitor` — the per-tick composition (``FleetHealthMonitor``);
- :mod:`.metrics` — gauges for the shared /metrics endpoint.

See docs/fleet-health.md for the operator-facing story.

A copy of the JAX package's ``health/``; the port imports nothing
of that package.
"""

from .classifier import (ClassifierConfig, HealthClassifier, NodeHealth,
                         SliceHealth)
from .consts import HealthVerdict
from .monitor import FleetHealthMonitor, HealthOptions, HealthReport
from .probes import (CounterProbe, DriverCrashLoopProbe, HeartbeatProbe,
                     NodeConditionProbe, Probe, Signal, Snapshot,
                     default_probes)
from .remediation import HealthRemediator, RemediationPolicy

__all__ = [
    "ClassifierConfig", "CounterProbe", "DriverCrashLoopProbe",
    "FleetHealthMonitor", "HealthClassifier", "HealthOptions",
    "HealthRemediator", "HealthReport", "HealthVerdict", "HeartbeatProbe",
    "NodeConditionProbe", "NodeHealth", "Probe", "RemediationPolicy",
    "Signal", "SliceHealth", "Snapshot", "default_probes",
]
