"""Scratch components with PLANTED concurrency bugs (the port's twin of
the JAX package's ``tools/race/planted.py``).

They are the explorer's own regression oracles
(``python -m k8s_operator_libs_tpu_torch.race --self-test`` and
``tests/test_torch_race.py``): a detector that cannot find a bug it was
handed proves nothing about the clean harnesses. Each component is
written in the package's idiom (shim-made primitives, an injected clock)
with one deliberate hole.
"""

from __future__ import annotations

from ..utils import threads


class RacyCounter:
    """The classic lost update: ``incr`` reads, yields (a clock read —
    exactly where a drain worker would consult its injected clock), and
    writes back. Two workers interleaving read-read-write-write lose an
    increment. The lock exists but ``incr`` never takes it — so the
    lockset checker convicts it even on a schedule that happens not to
    lose an update."""

    def __init__(self, clock):
        self._lock = threads.make_lock("racy-counter")
        self._clock = clock
        self.value = 0

    def incr(self) -> None:
        v = self.value  # lint: ignore — the planted race IS the fixture
        self._clock.now()        # preemption point mid read-modify-write
        self.value = v + 1  # lint: ignore — the planted race IS the fixture

    def incr_safe(self) -> None:
        with self._lock:
            v = self.value
            self._clock.now()
            self.value = v + 1


def racy_counter_harness(sched, workers: int = 2, increments: int = 3,
                         safe: bool = False):
    """Spawn ``workers`` shim threads incrementing a shared counter;
    assert no update was lost. With ``safe=False`` the explorer must
    find a losing interleaving; with ``safe=True`` every schedule
    passes (the clean twin the shrinker and tests calibrate against)."""
    counter = RacyCounter(sched.clock)

    def work():
        for _ in range(increments):
            (counter.incr_safe if safe else counter.incr)()

    handles = [threads.spawn(f"incr-{i}", work) for i in range(workers)]
    for h in handles:
        h.join()
    expect = workers * increments
    assert counter.value == expect, (
        f"lost update: {counter.value} != {expect}")


class SilentlySharedFlag:
    """A flag written under the lock but read lock-free from the worker
    loop: schedules where the reader sees the flag are indistinguishable
    from schedules where it doesn't, so no assertion fires. Only the
    LOCKSET checker convicts it."""

    def __init__(self, clock):
        self._lock = threads.make_lock("shared-flag")
        self._clock = clock
        self.draining = False
        self.observed = 0

    def set_draining(self) -> None:
        with self._lock:
            self.draining = True

    def poll(self) -> bool:
        self._clock.now()
        return self.draining  # lint: ignore — the planted race IS the fixture


def shared_flag_harness(sched):
    flag = SilentlySharedFlag(sched.clock)

    def reader():
        for _ in range(3):
            flag.poll()

    def writer():
        sched.clock.sleep(0.01)
        flag.set_draining()

    r = threads.spawn("flag-reader", reader)
    w = threads.spawn("flag-writer", writer)
    r.join()
    w.join()
