"""Downtime attribution: join the workload's goodput ledger with the
operator's per-node upgrade journey.

The headline — workload downtime through a rolling driver upgrade —
is computed here, on the one code path that a benchmark, the status CLI
(``status.py --goodput``) and the chaos invariants share:

- :data:`WINDOW_PHASES` names the slice-unavailability segment each
  ``UpgradeState`` belongs to (the three segments a downtime report has always
  reported: ``window_to_gate_s``, ``window_gate_to_restart_s``,
  ``window_after_restart_s``). Keyed by state **wire values** — obs sits
  below the upgrade package in the layering — and its keys are exactly
  ``UpgradeState``'s values (a test holds both directions).
- :func:`windows_from_journey` / :func:`slice_window` turn journey
  annotations (:func:`~.journey.parse_journey`) into
  :class:`WindowBreakdown` segment sums.
- :func:`attribute_downtime` splits each ledger-observed unavailability
  window (:func:`~.goodput.unavailability_windows`) into named phases:
  workload-local badput (drain save, restore, re-warmup) takes
  precedence, the remainder is attributed to whichever journey segment
  was active, and anything neither explains is ``idle``. The phases of
  one window always sum to the window — nothing is double-counted or
  dropped.
- :func:`downtime_summary` is the downtime formula (the drain save's
  write half rides concurrently with the unavailability window).

A copy of the JAX package's ``obs/attribution.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Slice-unavailability segment per upgrade state, keyed by wire value
# (obs may not import the upgrade package). Segments:
#   outside          node serving traffic (before cordon / after uncordon)
#   to_gate          cordon landed, waiting for the workload's own exit
#                    (the wait-for-jobs gate) — overlappable by the drain
#                    save's write half
#   gate_to_restart  jobs gone; old driver pods evicted/drained — still
#                    overlappable (the checkpoint uploader DaemonSet
#                    survives the drain)
#   after_restart    driver restart, validation, uncordon barriers — the
#                    serial tail before the job can reschedule
WINDOW_PHASES: Dict[str, str] = {
    "": "outside",
    "upgrade-required": "outside",
    "cordon-required": "to_gate",
    "wait-for-jobs-required": "to_gate",
    "pod-deletion-required": "gate_to_restart",
    "drain-required": "gate_to_restart",
    "pod-restart-required": "after_restart",
    "validation-required": "after_restart",
    "uncordon-required": "after_restart",
    "upgrade-done": "outside",
    "upgrade-failed": "after_restart",
}

# ledger badput phases that claim window time ahead of journey segments
_WORKLOAD_PHASES = ("drain_save", "ckpt_restore", "rewarmup", "compile",
                    "ckpt_save")


@dataclasses.dataclass
class WindowBreakdown:
    """One slice-unavailability window split into the three named
    segments. ``start``/``gate_at``/``restart_at``/``end`` are absolute
    wall times when derived from a journey, ``None`` when constructed
    from bare segment durations."""

    to_gate_s: float
    gate_to_restart_s: float
    after_restart_s: float
    start: Optional[float] = None
    end: Optional[float] = None
    gate_at: Optional[float] = None
    restart_at: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.to_gate_s + self.gate_to_restart_s + self.after_restart_s

    @property
    def to_restart_s(self) -> float:
        """The pre-restart (overlappable) half of the window."""
        return self.to_gate_s + self.gate_to_restart_s

    def as_dict(self) -> Dict[str, float]:
        return {"window_to_gate_s": self.to_gate_s,
                "window_gate_to_restart_s": self.gate_to_restart_s,
                "window_after_restart_s": self.after_restart_s,
                "window_s": self.window_s}


def windows_from_journey(entries: Sequence[Tuple[str, float]],
                         now: Optional[float] = None
                         ) -> List[WindowBreakdown]:
    """Unavailability windows of ONE node's journey. A window opens at
    the first entry into a non-``outside`` state and closes at the next
    entry back into an ``outside`` state; an unterminated window closes
    at ``now`` (dropped when ``now`` is not given — a half-open window
    has no defensible segment sums)."""
    windows: List[WindowBreakdown] = []
    current: Optional[Dict[str, Any]] = None
    for i, (state, entered) in enumerate(entries):
        phase = WINDOW_PHASES.get(state, "outside")
        nxt = entries[i + 1][1] if i + 1 < len(entries) else now
        if phase == "outside":
            if current is not None:
                current["end"] = entered
                windows.append(_close_window(current))
                current = None
            continue
        if current is None:
            current = {"start": entered, "end": None, "gate_at": None,
                       "restart_at": None,
                       "dwell": {"to_gate": 0.0, "gate_to_restart": 0.0,
                                 "after_restart": 0.0}}
        if phase == "gate_to_restart" and current["gate_at"] is None:
            current["gate_at"] = entered
        if phase == "after_restart" and current["restart_at"] is None:
            current["restart_at"] = entered
        if nxt is not None:
            current["dwell"][phase] += max(0.0, nxt - entered)
    if current is not None and now is not None:
        current["end"] = now
        windows.append(_close_window(current))
    return windows


def _close_window(w: Dict[str, Any]) -> WindowBreakdown:
    return WindowBreakdown(
        to_gate_s=w["dwell"]["to_gate"],
        gate_to_restart_s=w["dwell"]["gate_to_restart"],
        after_restart_s=w["dwell"]["after_restart"],
        start=w["start"], end=w["end"],
        gate_at=w["gate_at"], restart_at=w["restart_at"])


def slice_window(journeys: Sequence[Sequence[Tuple[str, float]]],
                 now: Optional[float] = None) -> Optional[WindowBreakdown]:
    """Slice-level window across member journeys (slice-atomic upgrades
    move members in lockstep): opens at the EARLIEST member cordon,
    closes at the LATEST member uncordon, with each segment boundary at
    the earliest member entering that segment — so the three segments
    partition the slice window exactly."""
    windows = [w for j in journeys for w in windows_from_journey(j, now=now)]
    if not windows:
        return None
    start = min(w.start for w in windows)
    end = max(w.end for w in windows)
    gate = min((w.gate_at for w in windows if w.gate_at is not None),
               default=None)
    restart = min((w.restart_at for w in windows
                   if w.restart_at is not None), default=None)
    gate_t = gate if gate is not None else (restart if restart is not None
                                            else end)
    restart_t = restart if restart is not None else end
    return WindowBreakdown(
        to_gate_s=max(0.0, gate_t - start),
        gate_to_restart_s=max(0.0, restart_t - gate_t),
        after_restart_s=max(0.0, end - restart_t),
        start=start, end=end, gate_at=gate, restart_at=restart)


# ----------------------------------------------------- window attribution


def _sweep(start: float, end: float,
           intervals: List[Tuple[int, str, float, float]]
           ) -> Dict[str, float]:
    """Partition [start, end): each elementary segment goes to the
    highest-priority covering interval, else ``idle``. The returned
    phases sum to ``end - start`` by construction."""
    bounds = {start, end}
    for _, _, a, b in intervals:
        bounds.add(min(max(a, start), end))
        bounds.add(min(max(b, start), end))
    edges = sorted(bounds)
    out: Dict[str, float] = {}
    for a, b in zip(edges, edges[1:]):
        if b <= a:
            continue
        best: Optional[Tuple[int, str]] = None
        for prio, name, ia, ib in intervals:
            if ia <= a and ib >= b and (best is None or prio > best[0]):
                best = (prio, name)
        name = best[1] if best else "idle"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def attribute_downtime(ledger_records: List[Dict[str, Any]],
                       journey_entries: Sequence[Tuple[str, float]],
                       now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Split every ledger-observed unavailability window into named
    phases. One report per window::

        {"start": t0, "end": t1, "total_s": t1 - t0,
         "phases": {"drain_save": 2.0, "window_to_gate": 1.0,
                    "window_gate_to_restart": 9.8,
                    "window_after_restart": 4.5, "ckpt_restore": 1.0,
                    "rewarmup": 0.5, "idle": 0.2}}

    Workload badput phases (drain save, restore, re-warmup) outrank the
    journey segments where they overlap; the phases always sum to
    ``total_s`` (:func:`_sweep`).
    """
    from .goodput import unavailability_windows  # local: avoid cycle risk

    reports: List[Dict[str, Any]] = []
    journey_windows = windows_from_journey(journey_entries, now=now)
    phase_recs = [r for r in ledger_records if r.get("kind") == "phase"
                  and r.get("phase") in _WORKLOAD_PHASES]
    for start, end in unavailability_windows(ledger_records):
        intervals: List[Tuple[int, str, float, float]] = []
        for rec in phase_recs:
            a = rec["t"]
            b = a + rec.get("duration_s", 0.0)
            if b > start and a < end:
                intervals.append((2, rec["phase"], a, b))
        for w in journey_windows:
            for name, a, b in (
                    ("window_to_gate", w.start,
                     w.gate_at if w.gate_at is not None else w.end),
                    ("window_gate_to_restart",
                     w.gate_at if w.gate_at is not None else w.end,
                     w.restart_at if w.restart_at is not None else w.end),
                    ("window_after_restart",
                     w.restart_at if w.restart_at is not None else w.end,
                     w.end)):
                if b > a and b > start and a < end:
                    intervals.append((1, name, a, b))
        phases = _sweep(start, end, intervals)
        reports.append({"start": start, "end": end, "total_s": end - start,
                        "phases": phases})
    return reports


# -------------------------------------------------------- downtime formula


def downtime_summary(window: WindowBreakdown, *, ckpt_fetch_s: float,
                     ckpt_write_s: float, ckpt_restore_s: float,
                     rewarmup_s: float,
                     baseline_replay_s: float = 0.0) -> Dict[str, Any]:
    """The downtime formula, the shared code path: the drain save's
    device→host fetch is serial (it needs the live device runtime);
    its host→storage write overlaps the WHOLE slice-unavailability
    window — the checkpoint-uploader DaemonSet is never evicted
    (IgnoreAllDaemonSets) and the host's path to durable storage does
    not ride the accelerator driver, so the upload runs concurrently with
    eviction, driver restart, and the readiness barriers alike. The
    serialization point is the resumed job's restore: it cannot begin
    before BOTH the window closed and the upload landed.

        downtime = fetch + max(write, window) + restore + rewarmup

    ``baseline_replay_s`` is the compute an UNCOORDINATED job replays
    (half a periodic-checkpoint interval on average); the baseline pays
    the full window plus replay plus the same restore + re-warmup.
    """
    overlapped = max(ckpt_write_s, window.window_s)
    downtime = ckpt_fetch_s + overlapped + ckpt_restore_s + rewarmup_s
    baseline = (window.window_s + baseline_replay_s + ckpt_restore_s
                + rewarmup_s)
    return {
        "downtime_s": downtime,
        "baseline_downtime_s": baseline,
        "vs_baseline": (baseline / downtime) if downtime else None,
        "ckpt_fetch_s": ckpt_fetch_s,
        "ckpt_write_s": ckpt_write_s,
        "ckpt_restore_s": ckpt_restore_s,
        "rewarmup_s": rewarmup_s,
        "window_to_restart_s": window.to_restart_s,
        "overlapped_s": overlapped,
        **window.as_dict(),
        "source": "obs.attribution",
    }
