"""Sharded reconcile execution + the shared availability-budget accountant.

The third layer of the O(changed) reconcile: once BuildState is
incremental and reads are informer-backed, the remaining per-tick wall
cost is the per-node work in
the ``process_*`` handlers (cordons, drains, restart checks, uncordons) —
serialized over 10k nodes in FLEET_r01. :class:`ShardRunner` fans that
work out across per-slice-group workers built on :mod:`..utils.threads`:

- **slice atomicity is preserved by construction** — the partition key is
  the grouper's group key, so a multi-host slice never splits across
  shards and every group barrier (restart/uncordon) evaluates against
  members a single worker owns this pass;
- **the availability budget stays one accountant** — admission decisions
  made concurrently by shards reserve slots through a single locked
  :class:`BudgetAccountant`, so the maxUnavailable contract cannot be
  overrun by parallelism (the JAX package's per-shard race harness in
  ``tools/race/harnesses.py`` explores exactly this seam);
- **determinism is a mode, not an accident** — ``parallel=False`` runs
  the same partition/merge machinery shard-by-shard in shard order on the
  calling thread, which is how the chaos campaign keeps byte-identical
  seed replay while still exercising the sharded code path (real
  interleavings are explored under ``make race`` instead).

Partitioning uses CRC-32 of the group key — stable across processes
(unlike ``hash()``, which PYTHONHASHSEED randomizes) so a shard
assignment seen in a failing run reproduces everywhere.

A copy of the JAX package's ``upgrade/sharding.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import logging
import zlib
from typing import Callable, List, Optional, Sequence

from ..utils import threads

logger = logging.getLogger(__name__)


class BudgetAccountant:
    """The maxUnavailable throttle as a single locked reservation counter.

    Mirrors the serial arithmetic of ``process_upgrade_required_nodes``
    exactly: :meth:`try_reserve` is the "enough slots" admission,
    :meth:`force_reserve` the already-cordoned bypass (charged even past
    zero, like the reference's unconditional decrement), and
    :meth:`try_admit_oversized` the deadlock-breaker that lets AT MOST one
    oversized group start per pass — all atomic under one lock so shards
    can decide concurrently."""

    def __init__(self, available: int):
        self._lock = threads.make_lock("budget-accountant")
        self._available = int(available)
        self._admitted = False

    def try_reserve(self, n: int) -> bool:
        """Reserve ``n`` slots iff they all fit; marks the pass admitted."""
        with self._lock:
            if n <= self._available:
                self._available -= n
                self._admitted = True
                return True
            return False

    def force_reserve(self, n: int) -> None:
        """Charge ``n`` slots unconditionally (may go negative): the
        already-cordoned bypass consumes budget it was never granted,
        exactly like the reference's decrement at :621-624."""
        with self._lock:
            self._available -= n
            self._admitted = True

    def try_admit_oversized(self, quiet: bool) -> bool:
        """Admit one oversized group iff the cluster is quiet (caller's
        precomputed predicate) AND nothing else was admitted this pass —
        checked and claimed atomically, so two shards can never each
        start an oversized group."""
        with self._lock:
            if self._admitted or not quiet:
                return False
            self._admitted = True
            return True

    @property
    def available(self) -> int:
        with self._lock:
            return self._available

    @property
    def admitted_this_pass(self) -> bool:
        with self._lock:
            return self._admitted


def shard_index(key: str, shards: int) -> int:
    """Deterministic shard assignment for a group key."""
    return zlib.crc32(key.encode("utf-8")) % shards


class ShardRunner:
    """Partition group-keyed items across workers and run ``work_fn`` per
    shard.

    ``work_fn(items) -> result`` receives each shard's items in their
    original relative order; results come back in shard-index order (so
    serial and parallel modes merge identically). With ``workers <= 1``
    everything runs inline as ONE shard — byte-identical to the
    pre-sharding code path. If any shard raises, every shard still
    finishes (no half-joined workers), then the lowest-indexed error is
    re-raised — callers treat it like the serial loop's first failure and
    rely on the next reconcile's idempotent retry."""

    def __init__(self, workers: int = 0, parallel: bool = True,
                 name: str = "reconcile-shard"):
        self.workers = max(0, int(workers))
        self.parallel = parallel
        self.name = name

    def run(self, items: Sequence, key_fn: Callable[[object], str],
            work_fn: Callable[[List], object]) -> List:
        items = list(items)
        if self.workers <= 1 or len(items) <= 1:
            return [work_fn(items)]
        buckets: List[List] = [[] for _ in range(self.workers)]
        for item in items:
            buckets[shard_index(key_fn(item), self.workers)].append(item)
        shards = [b for b in buckets if b]
        results: List = [None] * len(shards)
        errors: List = []

        def _one(i: int, shard: List) -> None:
            try:
                results[i] = work_fn(shard)
            except BaseException as exc:  # exc: allow — collected and re-raised after the join; a shard worker must never die silently
                errors.append((i, exc))

        if self.parallel:
            workers = [threads.spawn(f"{self.name}-{i}", _one,
                                     args=(i, shard), start=False)
                       for i, shard in enumerate(shards)]
            for t in workers:
                t.start()
            for t in workers:
                t.join()
        else:
            for i, shard in enumerate(shards):
                _one(i, shard)
        if errors:
            errors.sort(key=lambda pair: pair[0])
            raise errors[0][1]
        return results

    def run_flat(self, items: Sequence, key_fn: Callable[[object], str],
                 work_fn: Callable[[List], Optional[List]]) -> List:
        """:meth:`run`, with per-shard list results concatenated in shard
        order (``None`` results contribute nothing)."""
        out: List = []
        for result in self.run(items, key_fn, work_fn):
            if result:
                out.extend(result)
        return out
