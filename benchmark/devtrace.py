"""Device time from ``torch.profiler``: what ran on the card, for how
long, and what the host was doing while the card sat idle.

:class:`DeviceTrace` profiles a span that starts and ends with the device
synchronized. From the profiler's events it keeps each device operation's
interval (kernels, copies, sets) and each host operation's. ``busy_s`` is
the length of the union of the device intervals, ``window_s`` the host's
clock over the span. An idle gap is a stretch between device intervals;
it is named by the innermost host operation running at its midpoint.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float, str]      # start s, end s, name


class DeviceTrace:
    def __init__(self, torch_module, device=None):
        self.torch = torch_module
        self.cuda = device is None or device.type == "cuda"
        self.prof = None
        self.t0 = 0.0
        self.window_s = 0.0
        self.device_ops: List[Interval] = []
        self.host_ops: List[Interval] = []

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.device_ops, self.host_ops = split_events(self.prof, self.cuda)
        self.prof = None

    # ------------------------------------------------------------ readings

    def busy_s(self) -> float:
        return sum(end - start for start, end in union(self.device_ops))

    def op_seconds(self, substring: str) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name holds
        ``substring``."""
        picked = [e - s for s, e, n in self.device_ops if substring in n]
        return sum(picked), len(picked)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device_ops:
            by[name] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> List[List]:
        return top_gaps(self.device_ops, self.host_ops, n)


def split_events(prof, cuda: bool = True
                 ) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) in seconds from the profiler's
    raw events. Without a card (``cuda`` False) the host's aten operations
    stand in for the device's, so the arithmetic runs in the tests."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        on_device = (str(ev.device_type()).endswith("CUDA") if cuda
                     else ev.name().startswith("aten::"))
        (device if on_device else host).append((start, end, ev.name()))
    device.sort()
    host.sort()
    return device, host


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end, _ in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _innermost(host: List[Interval], starts: List[float], t: float
               ) -> Optional[str]:
    """The host operation that started last among those running at t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        if host[j][1] >= t:
            return host[j][2]
    return None


def top_gaps(device: List[Interval], host: List[Interval], n: int = 10
             ) -> List[List]:
    """The idle time between device intervals, summed by the host
    operation running in each gap, the largest ``n``."""
    busy = union(device)
    starts = [h[0] for h in host]
    by: Dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        name = _innermost(host, starts, (end + start) / 2)
        by[name or "no host operation recorded"] += start - end
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:n]
