"""In-process ring-buffer time-series store — the temporal layer of obs/.

The gauges and histograms the operator already exposes are instantaneous:
every ``/metrics`` scrape shows *now*, so "how much error budget is left
this month" and "is drain latency burning budget 14x too fast" are
unanswerable from inside the process. The reference NVIDIA operator
delegates that to an external Prometheus; this self-contained stack
deliberately does not assume one, so the SLO engine (:mod:`.slo`) needs a
small history store of its own.

Design constraints, in order:

- **fixed memory** — every series is two bounded rings (a raw ring at
  scrape resolution plus a downsampled ring for long windows, one coarse
  point kept per :attr:`TimeSeriesStore.downsample_every` scrapes), and
  the series map itself is capped; a 10k-tick scrape test pins this;
- **clock-injected** — sample timestamps come from the injected clock's
  wall view, so tests and bench drive weeks of history in milliseconds;
- **counter-correct downsampling** — coarse points are *kept samples*,
  never averages: histogram ``_bucket``/``_count`` series are cumulative,
  and ``increase()`` over endpoints of kept samples is exact at coarse
  granularity where averaging would be wrong.

Scraping happens once per reconcile tick (:meth:`TimeSeriesStore.scrape`)
from a :meth:`~.metrics.MetricsHub.snapshot` plus the per-tick gauge
dicts the upgrade/health collectors already compute — no second set of
instrumentation and no hot-path synchronization; the workload stream
(model dispatch, serving steps) is never touched.

:func:`quantile_from_buckets` derives p50/p95/p99 from the already-
emitted ``_bucket`` families with Prometheus ``histogram_quantile``
semantics (linear interpolation inside the bucket, capped at the highest
finite bound), so no raw observations need to be retained.

A copy of the JAX package's ``obs/tsdb.py``; the port imports nothing
of that package.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from ..utils import threads
from ..utils.clock import Clock, RealClock

DEFAULT_RAW_POINTS = 1024
DEFAULT_DOWNSAMPLE_EVERY = 16
DEFAULT_COARSE_POINTS = 1024
DEFAULT_MAX_SERIES = 4096

_INF = float("inf")

LabelItems = Tuple[Tuple[str, str], ...]


def label_key(labels: Optional[Dict[str, str]]) -> LabelItems:
    return tuple(sorted((labels or {}).items()))


def quantile_from_buckets(buckets: List[Tuple[float, float]],
                          q: float) -> Optional[float]:
    """Estimate the ``q``-quantile from cumulative histogram buckets
    ``[(le, cumulative_count), ...]`` (le ascending, ``+Inf`` last),
    Prometheus ``histogram_quantile`` style: linear interpolation inside
    the bucket the rank falls into, lower bound 0 for the first bucket,
    estimates in the ``+Inf`` bucket capped at the highest finite bound.
    ``None`` when the histogram holds no observations."""
    if not buckets:
        return None
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = min(max(q, 0.0), 1.0) * total
    lower, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if le == _INF:
                return lower  # capped at the highest finite bound
            if count == prev_count:
                return le
            return lower + (le - lower) * ((rank - prev_count)
                                           / (count - prev_count))
        if le != _INF:
            lower, prev_count = le, count
    return lower


class _Series:
    """One labelled series: a raw ring at scrape resolution plus a coarse
    ring keeping every Nth sample for long-window queries."""

    __slots__ = ("raw", "coarse", "_adds")

    def __init__(self, raw_points: int, coarse_points: int):
        self.raw: collections.deque = collections.deque(maxlen=raw_points)
        self.coarse: collections.deque = collections.deque(
            maxlen=coarse_points)
        self._adds = 0

    def add(self, t: float, value: float, downsample_every: int) -> None:
        self.raw.append((t, value))
        self._adds += 1
        if downsample_every > 0 and self._adds % downsample_every == 0:
            self.coarse.append((t, value))

    def latest(self) -> Optional[Tuple[float, float]]:
        if self.raw:
            return self.raw[-1]
        if self.coarse:
            return self.coarse[-1]
        return None

    def samples_since(self, t0: float) -> List[Tuple[float, float]]:
        """Samples with timestamp >= t0, coarse history splicing in where
        the raw ring has already dropped points (no duplicates)."""
        oldest_raw = self.raw[0][0] if self.raw else _INF
        out = [p for p in self.coarse if t0 <= p[0] < oldest_raw]
        out.extend(p for p in self.raw if p[0] >= t0)
        return out

    def at_or_before(self, t: float) -> Optional[Tuple[float, float]]:
        """Newest sample with timestamp <= t (counter baselines)."""
        for ring in (self.raw, self.coarse):
            for p in reversed(ring):
                if p[0] <= t:
                    return p
        return None

    def truncated(self, downsample_every: int) -> bool:
        """True once the rings have dropped history — the oldest retained
        sample is then no longer the series' birth."""
        if (downsample_every > 0 and self.coarse.maxlen
                and self._adds // downsample_every > self.coarse.maxlen):
            return True
        return bool(not self.coarse and self.raw.maxlen
                    and self._adds > self.raw.maxlen)


class TimeSeriesStore:
    """Bounded in-process TSDB keyed by (fully-prefixed family name,
    sorted label items). Thread-safe: the reconcile loop scrapes while
    HTTP handlers read history for the dashboard."""

    def __init__(self, clock: Optional[Clock] = None,
                 raw_points: int = DEFAULT_RAW_POINTS,
                 downsample_every: int = DEFAULT_DOWNSAMPLE_EVERY,
                 coarse_points: int = DEFAULT_COARSE_POINTS,
                 max_series: int = DEFAULT_MAX_SERIES):
        self._clock = clock or RealClock()
        self.raw_points = int(raw_points)
        self.downsample_every = int(downsample_every)
        self.coarse_points = int(coarse_points)
        self.max_series = int(max_series)
        self._series: Dict[Tuple[str, LabelItems], _Series] = {}
        self._lock = threads.make_lock("tsdb")
        self.scrapes = 0
        self.dropped_series = 0  # writes refused at the series cap

    # ------------------------------------------------------------- writes

    def record(self, name: str, labels: Optional[Dict[str, str]],
               value: float, t: Optional[float] = None) -> None:
        key = (name, label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    # a label-cardinality explosion must degrade (newest
                    # series unrecorded) rather than grow without bound
                    self.dropped_series += 1
                    return
                series = self._series[key] = _Series(self.raw_points,
                                                     self.coarse_points)
            series.add(self._clock.wall() if t is None else t,
                       float(value), self.downsample_every)

    def scrape(self, hub=None, prefix: str = "tpu_operator",
               extra_gauges: Optional[
                   Dict[str, List[Tuple[Dict[str, str], float]]]] = None
               ) -> None:
        """One scrape tick: sample every family of ``hub`` (a
        :class:`~.metrics.MetricsHub`, via its :meth:`snapshot`) under
        ``prefix``, plus ``extra_gauges`` — already fully-prefixed
        ``{name: [(labels, value), ...]}`` from the per-tick upgrade and
        health gauge collectors."""
        t = self._clock.wall()
        if hub is not None:
            snap = hub.snapshot()
            # counters are cumulative like gauges on the wire; increase()
            # over kept samples stays exact for both
            for name, entries in list(snap["gauges"].items()) + list(
                    snap.get("counters", {}).items()):
                full = f"{prefix}_{name}" if prefix else name
                for labels, value in entries:
                    self.record(full, labels, value, t=t)
            for name, entries in snap["histograms"].items():
                full = f"{prefix}_{name}" if prefix else name
                for labels, cum_buckets, total, count in entries:
                    for le, c in cum_buckets:
                        self.record(f"{full}_bucket",
                                    {**labels, "le": repr(le)}, c, t=t)
                    self.record(f"{full}_count", labels, count, t=t)
                    self.record(f"{full}_sum", labels, total, t=t)
        for full, entries in (extra_gauges or {}).items():
            for labels, value in entries:
                self.record(full, labels, value, t=t)
        with self._lock:
            self.scrapes += 1

    # -------------------------------------------------------------- reads

    def _get(self, name: str,
             labels: Optional[Dict[str, str]]) -> Optional[_Series]:
        return self._series.get((name, label_key(labels)))

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None
               ) -> Optional[Tuple[float, float]]:
        with self._lock:
            series = self._get(name, labels)
            return series.latest() if series is not None else None

    def samples(self, name: str, labels: Optional[Dict[str, str]] = None,
                window_s: Optional[float] = None
                ) -> List[Tuple[float, float]]:
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return []
            t0 = (-_INF if window_s is None
                  else self._clock.wall() - window_s)
            return series.samples_since(t0)

    def increase(self, name: str, labels: Optional[Dict[str, str]] = None,
                 window_s: Optional[float] = None) -> float:
        """Counter increase over the trailing window: latest value minus
        the baseline at-or-before the window start. A series whose whole
        retained history is younger than the window baselines at 0 — the
        cumulative family was born (process start) inside the window, so
        everything it counted happened there. 0.0 with no data; clamped
        >= 0 (restarts)."""
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return 0.0
            last = series.latest()
            if last is None:
                return 0.0
            if window_s is None:
                return max(0.0, last[1])
            t0 = self._clock.wall() - window_s
            base = series.at_or_before(t0)
            if base is not None:
                base_value = base[1]
            elif series.truncated(self.downsample_every):
                # history shorter than the window because the rings
                # dropped it: the oldest retained sample is the best
                # (conservative) baseline we still have
                oldest = series.samples_since(-_INF)
                base_value = oldest[0][1] if oldest else last[1]
            else:
                base_value = 0.0  # series born inside the window
            return max(0.0, last[1] - base_value)

    def bucket_increases(self, family: str,
                         labels: Optional[Dict[str, str]] = None,
                         window_s: Optional[float] = None
                         ) -> List[Tuple[float, float]]:
        """Per-bucket cumulative-count increases of one histogram family
        over the trailing window → ``[(le, increase), ...]`` le-ascending
        (still cumulative in le). Empty when the family was never
        scraped. Aggregates across label sets when ``labels`` is None."""
        base_key = label_key(labels) if labels else None
        with self._lock:
            les: Dict[float, List[Tuple[str, LabelItems]]] = {}
            for (name, key), _series in self._series.items():
                if name != f"{family}_bucket":
                    continue
                items = dict(key)
                le_raw = items.pop("le", None)
                if le_raw is None:
                    continue
                if base_key is not None and label_key(items) != base_key:
                    continue
                le = _INF if le_raw in ("inf", "+Inf") else float(le_raw)
                les.setdefault(le, []).append((name, key))
        out = []
        for le in sorted(les):
            inc = sum(self.increase(name, dict(key), window_s=window_s)
                      for name, key in les[le])
            out.append((le, inc))
        return out

    def quantile(self, family: str, q: float,
                 labels: Optional[Dict[str, str]] = None,
                 window_s: Optional[float] = None) -> Optional[float]:
        """Windowed quantile of a histogram family straight from its
        scraped ``_bucket`` series."""
        return quantile_from_buckets(
            self.bucket_increases(family, labels, window_s=window_s), q)

    def time_fraction(self, name: str,
                      labels: Optional[Dict[str, str]] = None,
                      window_s: float = 3600.0,
                      predicate=None) -> Tuple[float, float]:
        """Time-weighted (matched_seconds, covered_seconds) of a gauge
        over the trailing window, step-interpolated (each sample holds
        until the next). Coverage starts at the first known sample inside
        or before the window, so sparse early history never counts as
        compliant time."""
        now = self._clock.wall()
        t0 = now - window_s
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return 0.0, 0.0
            pts = series.samples_since(t0)
            prior = series.at_or_before(t0)
        if prior is not None:
            pts = [(t0, prior[1])] + pts
        if not pts:
            return 0.0, 0.0
        matched = covered = 0.0
        for i, (t, v) in enumerate(pts):
            end = pts[i + 1][0] if i + 1 < len(pts) else now
            span = max(0.0, min(end, now) - max(t, t0))
            covered += span
            if predicate is not None and predicate(v):
                matched += span
        return matched, covered

    # -------------------------------------------------------- introspection

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def point_count(self) -> int:
        """Total retained points across every ring — the fixed-memory
        test pins that this stops growing once the rings are full."""
        with self._lock:
            return sum(len(s.raw) + len(s.coarse)
                       for s in self._series.values())
