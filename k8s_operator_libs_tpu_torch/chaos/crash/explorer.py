"""The crash-restart sweep: record sites, kill before/after each write.

One :class:`CrashPlan` names one crash point: ``(site, occurrence,
phase)`` — kill the operator immediately BEFORE or immediately AFTER the
``occurrence``-th write classified to ``site``. The :class:`CrashGate`
installs on the chaos injector's write-gate hook, sees every durable
write cluster-wide in deterministic order, and fires the kill:

- for a write issued by an operator candidate, it raises
  :class:`~..campaign.OperatorKilled` at the
  exact client call — ``phase="before"`` means the write NEVER LANDS
  (killed between deciding and writing), ``phase="after"`` means it
  landed and nothing else did;
- for a write issued by the serving tier ("router" sites), the LEADER
  operator is killed at the same boundary instead (the router process
  is not under crash test): before =
  leader dies, then the write lands; after = the write lands, then the
  leader dies.

The campaign reboots the victim as a fresh process (only durable
cluster state survives) and the run must converge with every standing
chaos invariant green. Determinism: the campaign is synchronous and the
gate draws no randomness, so ``(scenario, seed, plan)`` replays
byte-identically — a failing crash point IS its reproducer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..campaign import OperatorKilled, run_scenario, shrink_failure
from ..scenario import Scenario, parse_scenario

from .registry import SITES, classify

_OPERATOR_IDENTITIES = ("op-a", "op-b")

# The pinned sweep scenario: a rolling upgrade (state-journey, decree,
# cordon flips, drain intent on the serving hosts), a crashloop on slice
# 1 (health verdict -> quarantine -> repair -> lift), and a sustained
# flash crowd (market lease stamps when the arbiter trades, replica
# churn). Uncached read path: the arbiter prices the crowd against the
# slower legacy reconcile and reliably trades (the cached fleet recovers
# too fast — see chaos-market-smoke), and every registered site occurs.
SWEEP_SPEC = {
    "name": "crash-sweep",
    "fleet": {"slices": 2, "hosts_per_slice": 4, "solo_nodes": 1},
    "max_unavailable": "50%",
    "upgrade_at": 30.0,
    "max_ticks": 600,
    "faults": [
        {"type": "driver-crashloop", "at": 60.0, "duration": 90.0,
         "slices": [1]},
        {"type": "flash-crowd", "at": 45.0, "duration": 180.0,
         "requestsPerTick": 10},
    ],
}


def sweep_scenario() -> Scenario:
    return parse_scenario(SWEEP_SPEC)


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    site: str
    occurrence: int          # 1-based index among this site's writes
    phase: str               # "before" | "after"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r} "
                             f"(known: {', '.join(SITES)})")
        if self.phase not in ("before", "after"):
            raise ValueError("phase must be 'before' or 'after'")
        if self.occurrence < 1:
            raise ValueError("occurrence is 1-based")

    def describe(self) -> str:
        return f"{self.site}#{self.occurrence}/{self.phase}"


class CrashGate:
    """The injector write-gate. With ``plan=None`` it only records
    (site -> occurrence count) — the coverage pass. With a plan, it
    fires the kill exactly once at the planned write boundary."""

    def __init__(self, plan: Optional[CrashPlan] = None):
        self.plan = plan
        self.reset()

    def reset(self) -> None:
        self.counts: Dict[str, int] = {}
        self.fired = False
        self.kill_leader_pending = False
        self.last_reason = ""

    # ------------------------------------------------------------- hooks

    def _observe(self, method, identity, args, kwargs,
                 phase: str) -> None:
        site = classify(method, args, kwargs)
        if site is None:
            return
        if phase == "before":
            self.counts[site] = self.counts.get(site, 0) + 1
        plan = self.plan
        if (plan is None or self.fired or site != plan.site
                or phase != plan.phase
                or self.counts.get(site, 0) != plan.occurrence):
            return
        self.fired = True
        self.last_reason = f"crash point {plan.describe()} ({method})"
        if identity in _OPERATOR_IDENTITIES:
            # kill the ISSUING operator at the exact call: "before"
            # raises out of the client call before the write executes
            raise OperatorKilled(identity, self.last_reason)
        # router-stamped site: the write proceeds; the leader dies at
        # the campaign's next checkpoint
        self.kill_leader_pending = True

    def before_write(self, method, identity, args, kwargs) -> None:
        self._observe(method, identity, args, kwargs, "before")

    def after_write(self, method, identity, args, kwargs) -> None:
        self._observe(method, identity, args, kwargs, "after")


@dataclasses.dataclass
class CrashResult:
    plan: CrashPlan
    fired: bool
    converged: bool
    violations: List[str]
    crashes: int
    ticks: int
    trace: List[str]

    @property
    def failed(self) -> bool:
        return bool(self.violations) or not self.converged or not self.fired

    def report(self) -> str:
        status = "PASS" if not self.failed else "FAIL"
        line = (f"{status} crash point {self.plan.describe():>28s}  "
                f"fired={self.fired} converged={self.converged} "
                f"crashes={self.crashes} ticks={self.ticks} "
                f"violations={len(self.violations)}")
        if self.failed:
            line += "".join(f"\n  {v}" for v in self.violations[:10])
            line += (f"\n  replay: python -m "
                     f"k8s_operator_libs_tpu_torch.chaos.crash --site "
                     f"{self.plan.site} --occurrence "
                     f"{self.plan.occurrence} --phase {self.plan.phase}")
        return line


def record_sites(seed: int = 0,
                 scenario: Optional[Scenario] = None) -> Dict[str, int]:
    """The coverage pass: run the sweep scenario once with a recording
    gate and return {site: occurrence count}. A registered site that
    never occurs would make the sweep vacuous — the caller treats it as
    a failure."""
    gate = CrashGate(plan=None)
    result = run_scenario(scenario or sweep_scenario(), seed,
                          write_gate=gate)
    if result.failed:
        raise RuntimeError(
            "the crash sweep's baseline (no-kill) run failed — fix the "
            "scenario before sweeping:\n" + result.report())
    return dict(gate.counts)


def run_crash_point(plan: CrashPlan, seed: int = 0,
                    scenario: Optional[Scenario] = None,
                    shrink: bool = True) -> CrashResult:
    """One crash point to convergence. On failure (and ``shrink``), the
    scenario's fault set is shrunk under the SAME plan and the minimal
    reproducer appended to the trace, tools/race-style."""
    scenario = scenario or sweep_scenario()
    gate = CrashGate(plan)
    result = run_scenario(scenario, seed, write_gate=gate)
    out = CrashResult(
        plan=plan, fired=gate.fired, converged=result.converged,
        violations=[str(v) for v in result.violations],
        crashes=result.crashes, ticks=result.ticks,
        trace=list(result.trace))
    if out.failed and gate.fired and shrink:
        minimal = shrink_failure(scenario, seed, write_gate=gate)
        out.trace.append("shrunk reproducer:\n" + minimal.describe())
    return out


def full_sweep(seed: int = 0, occurrences_per_site: int = 2,
               sites: Optional[List[str]] = None,
               scenario: Optional[Scenario] = None
               ) -> List[CrashResult]:
    """Every registered site x {before, after} x up to N occurrences
    (the first, plus evenly-spaced later ones — a site's first write and
    a mid-flight write exercise different durable-state shapes).
    Raises on a registered site the scenario never exercises."""
    scenario = scenario or sweep_scenario()
    observed = record_sites(seed, scenario)
    wanted = sites or list(SITES)
    missing = [s for s in wanted if not observed.get(s)]
    if missing:
        raise RuntimeError(
            f"registered durable-write sites never occurred in the "
            f"sweep scenario: {', '.join(missing)} (observed: "
            f"{observed}) — the sweep would be vacuous")
    results: List[CrashResult] = []
    for site in wanted:
        total = observed[site]
        picks = [1]
        if occurrences_per_site > 1 and total > 1:
            step = max(1, total // occurrences_per_site)
            picks += [min(total, 1 + step * i)
                      for i in range(1, occurrences_per_site)]
        for occurrence in sorted(set(picks)):
            for phase in ("before", "after"):
                results.append(run_crash_point(
                    CrashPlan(site, occurrence, phase), seed, scenario))
    return results


# the budgeted subset (``--smoke``): one operator-process site
# through the provider choke point, the quarantine trio, and one
# router-stamped site — first occurrence, both phases
SMOKE_SITES = ("state-journey", "health-quarantine", "drain-intent")


def smoke_sweep(seed: int = 0) -> List[CrashResult]:
    scenario = sweep_scenario()
    results: List[CrashResult] = []
    for site in SMOKE_SITES:
        for phase in ("before", "after"):
            results.append(run_crash_point(CrashPlan(site, 1, phase),
                                           seed, scenario, shrink=False))
    return results
