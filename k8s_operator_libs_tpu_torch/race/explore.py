"""Seeded bounded exploration, replay and greedy schedule shrinking
(the port's twin of the JAX package's ``tools/race/explore.py``).

The seed-replay discipline of ``chaos/campaign.py`` applied to
interleavings:

- :func:`run_once`: one schedule. Install the cooperative scheduler as
  the shim's backend, run the harness, collect failures (assertion,
  deadlock, budget) and lockset races;
- :func:`explore`: N seeds; the first failing seed is shrunk and
  returned with its replay recipe;
- :func:`replay`: re-run a (seed, trace) pair; the same seed and trace
  give the same schedule and the same failure;
- :func:`shrink`: greedy delta-debugging over the DECISION TRACE. Drop
  one recorded choice at a time and keep the drop while the schedule
  still fails. A dropped choice makes the replayer fall back to its
  deterministic default at that point, so every candidate trace is
  well-formed. The minimal trace is what a bug report carries: a few
  forced switches instead of hundreds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from ..utils import threads as shim

from .lockset import LocksetChecker, RaceFinding
from .scheduler import CoopScheduler, RunReport


@dataclasses.dataclass
class ScheduleResult:
    """One schedule + its lockset findings."""

    report: RunReport
    races: List[RaceFinding] = dataclasses.field(default_factory=list)

    @property
    def failed(self) -> bool:
        return self.report.failed or bool(self.races)

    def describe(self) -> str:
        lines: List[str] = []
        if self.report.failure:
            lines.append(f"{self.report.failure_kind}: "
                         f"{self.report.failure}")
        lines.extend(str(r) for r in self.races)
        return "\n".join(lines) or "pass"


@dataclasses.dataclass
class ExploreResult:
    harness: str
    schedules: int
    failing_seed: Optional[int] = None
    failure: Optional[ScheduleResult] = None
    minimal_trace: Optional[List[str]] = None
    total_decisions: int = 0

    @property
    def failed(self) -> bool:
        return self.failure is not None

    def report(self) -> str:
        if not self.failed:
            return (f"PASS {self.harness}: {self.schedules} schedules, "
                    f"{self.total_decisions} decisions, 0 failures")
        lines = [f"FAIL {self.harness} seed={self.failing_seed}",
                 "  " + self.failure.describe().replace("\n", "\n  ")]
        if self.minimal_trace is not None:
            lines.append(f"  minimal trace ({len(self.minimal_trace)} "
                         f"forced switches): {self.minimal_trace}")
            lines.append(f"  replay: k8s_operator_libs_tpu_torch.race."
                         f"explore.replay(harness, "
                         f"seed={self.failing_seed}, "
                         f"trace={self.minimal_trace!r})")
        return "\n".join(lines)


def run_once(harness: Callable, seed: int,
             trace: Optional[List[str]] = None,
             lockset_files: Optional[List[str]] = None,
             max_decisions: int = 200_000) -> ScheduleResult:
    """One schedule of ``harness(sched)`` under seed (+ optional replay
    trace), with the lockset checker watching ``lockset_files``
    (None = the default operator spine; [] = disabled)."""
    sched = CoopScheduler(seed=seed, replay=trace,
                          max_decisions=max_decisions)
    checker = (None if lockset_files == []
               else LocksetChecker(files=lockset_files))
    with shim.use_backend(sched):
        if checker is not None:
            with checker:
                report = sched.run(harness, sched)
        else:
            report = sched.run(harness, sched)
    return ScheduleResult(report=report,
                          races=list(checker.races) if checker else [])


def replay(harness: Callable, seed: int, trace: List[str],
           **kwargs) -> ScheduleResult:
    """Re-run a recorded (seed, trace) pair — the bug-report recipe."""
    return run_once(harness, seed, trace=list(trace), **kwargs)


def shrink(harness: Callable, seed: int, trace: List[str],
           **kwargs) -> List[str]:
    """Greedily drop forced choices while the failure reproduces."""
    current = list(trace)
    shrunk = True
    while shrunk and current:
        shrunk = False
        for i in range(len(current)):
            candidate = current[:i] + current[i + 1:]
            if replay(harness, seed, candidate, **kwargs).failed:
                current = candidate
                shrunk = True
                break
    return current


def explore(harness: Callable, schedules: int = 50, base_seed: int = 0,
            name: Optional[str] = None,
            lockset_files: Optional[List[str]] = None,
            max_decisions: int = 200_000,
            shrink_failures: bool = True) -> ExploreResult:
    """Bounded exploration: one run per seed; first failure shrunk."""
    out = ExploreResult(harness=name or harness.__name__,
                        schedules=schedules)
    for i in range(schedules):
        seed = base_seed + i
        result = run_once(harness, seed, lockset_files=lockset_files,
                          max_decisions=max_decisions)
        out.total_decisions += result.report.decisions
        if result.failed:
            out.failing_seed = seed
            out.failure = result
            if shrink_failures:
                out.minimal_trace = shrink(
                    harness, seed, result.report.trace,
                    lockset_files=lockset_files,
                    max_decisions=max_decisions)
            break
    return out
