"""Health gauges for the operator's /metrics endpoint.

:func:`collect` snapshots one :class:`~.monitor.HealthReport` into a flat
gauge dict (per-verdict node and slice counts, quarantine totals, repair
in-flight count); rendering reuses
:func:`..upgrade.metrics.render_prometheus`, which owns the exposition
format (metric-name sanitization, HELP + TYPE lines), so health and upgrade
metrics stay format-identical on the shared endpoint.

A copy of the JAX package's ``health/metrics.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

from typing import Dict

from ..upgrade.metrics import render_prometheus
from .consts import HealthVerdict
from .monitor import HealthReport

HEALTH_PREFIX = "tpu_operator_health"


def collect(report: HealthReport) -> Dict[str, float]:
    per_node = {f"nodes_verdict_{v}": c
                for v, c in report.verdict_counts().items()}
    per_slice = {f"slices_verdict_{v}": c
                 for v, c in report.slice_verdict_counts().items()}
    assert set(f"nodes_verdict_{v}" for v in HealthVerdict.ALL) == \
        set(per_node)  # every verdict gets a gauge, even at zero
    return {
        # 1 while the report is a degraded-mode re-publication of stale
        # verdicts (control plane unreachable; remediation suspended)
        "masked": 1.0 if report.masked else 0.0,
        "monitored_nodes": len(report.node_health),
        "monitored_slices": len(report.slices),
        "quarantined_nodes": report.quarantined_nodes,
        "quarantined_slices": report.quarantined_slices,
        "repairs_in_flight": report.repairs_in_flight,
        "repairs_injected": len(report.actions.repairs_injected),
        "driver_pods_restarted": len(report.actions.driver_pods_restarted),
        "quarantines_deferred": len(report.actions.deferred_slices),
        "probe_errors": len(report.probe_errors),
        **per_node,
        **per_slice,
    }


def render(component: str, report: HealthReport) -> str:
    """Prometheus text for one report, labelled with the repair component."""
    return render_prometheus(component, collect(report),
                             prefix=HEALTH_PREFIX)
