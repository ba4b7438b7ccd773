"""Seeded chaos harness: fault injection, standing invariants, campaigns.

Correlated multi-group failures, apiserver latency/flake/conflict
injection, watch lag, leader failover mid-phase, eviction 429 storms and
spot-reclaim notices — every run continuously asserting the invariants
the rest of the repo claims (maxUnavailable budget, journey continuity
across failover, attribution summing to the window, exactly-one-Event
dedup, alert-machine transition legality).

A port of the JAX package's ``chaos/`` on GPU nodes: the campaign's
fleet is NVLink cliques and single H100 nodes, its operator candidates
``GPUOperator`` instances. ``python -m k8s_operator_libs_tpu_torch.chaos`` runs
a campaign, ``python -m k8s_operator_libs_tpu_torch.chaos.crash`` the
crash-restart explorer. The port imports nothing of the JAX package.
"""

from .campaign import (CampaignResult, SimJob, build_fleet, run_campaign,
                       run_scenario, shrink_failure)
from .faults import (FAULT_TYPES, RECLAIM_DEADLINE_ANNOTATION,
                     RECLAIM_TAINT_KEY, FaultEvent)
from .injector import ChaosClient, ChaosInjector
from .invariants import (FAULT_COVERAGE, INVARIANT_NAMES, CampaignView,
                         Invariant, Violation, default_invariants)
from .scenario import (FAULT_PARSERS, FleetSpec, Scenario, ScenarioError,
                       parse_scenario, random_scenario)

__all__ = [
    "CampaignResult", "SimJob", "build_fleet", "run_campaign",
    "run_scenario", "shrink_failure",
    "FAULT_TYPES", "RECLAIM_DEADLINE_ANNOTATION", "RECLAIM_TAINT_KEY",
    "FaultEvent", "ChaosClient", "ChaosInjector",
    "FAULT_COVERAGE", "INVARIANT_NAMES", "CampaignView", "Invariant",
    "Violation", "default_invariants",
    "FAULT_PARSERS", "FleetSpec", "Scenario", "ScenarioError",
    "parse_scenario", "random_scenario",
]
