"""Operator metrics over the upgrade state (reference exposes counter
getters for operator metrics — upgrade_state.go:1034-1120; Prometheus
registration is left to the consumer there, and here).

:func:`collect` snapshots every counter for one component;
:func:`render_prometheus` emits the text exposition format so a consumer can
serve them from its /metrics endpoint without extra dependencies.

A copy of the JAX package's ``upgrade/metrics.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import re
from typing import Dict

from ..obs.metrics import render_gauges
from .consts import UpgradeState
from .upgrade_state import ClusterUpgradeState, ClusterUpgradeStateManager

# Prometheus metric names admit [a-zA-Z_:][a-zA-Z0-9_:]* — the per-state
# gauges carry state wire values like "upgrade-done", whose dashes must be
# mapped to underscores or the exposition is invalid and scrapes drop it.
_INVALID_METRIC_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    name = _INVALID_METRIC_CHARS.sub("_", name)
    if name and not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


def collect(mgr: ClusterUpgradeStateManager,
            state: ClusterUpgradeState) -> Dict[str, float]:
    per_state = {f"nodes_in_state_{s or 'unknown'}": len(state.bucket(s))
                 for s in UpgradeState.ALL}
    return {
        "total_managed_nodes": mgr.get_total_managed_nodes(state),
        "upgrades_in_progress": mgr.get_upgrades_in_progress(state),
        "upgrades_done": mgr.get_upgrades_done(state),
        "upgrades_failed": mgr.get_upgrades_failed(state),
        "upgrades_pending": mgr.get_upgrades_pending(state),
        "unavailable_nodes": mgr.get_current_unavailable_nodes(state),
        **per_state,
    }


def render_prometheus_multi(per_component: Dict[str, Dict[str, float]],
                            prefix: str = "tpu_operator") -> str:
    """Text exposition for several components sharing one metric family
    set: HELP and TYPE once per metric name, then one sample per
    component (the port's :func:`~..obs.metrics.render_gauges`)."""
    return render_gauges(per_component, prefix)


def render_prometheus(component: str, metrics: Dict[str, float],
                      prefix: str = "tpu_operator") -> str:
    return render_prometheus_multi({component: metrics}, prefix=prefix)
