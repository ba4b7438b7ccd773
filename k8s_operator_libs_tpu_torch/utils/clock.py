"""Injectable clock (a copy of the JAX package's ``utils/clock.py``).

The batcher, the server and the goodput ledger take a clock so tests can
drive time by hand; the default is the monotonic wall clock.
"""

from __future__ import annotations

import abc
import threading
import time


class Clock(abc.ABC):
    @abc.abstractmethod
    def now(self) -> float:
        """Monotonic seconds."""

    @abc.abstractmethod
    def sleep(self, seconds: float) -> None: ...

    def wall(self) -> float:
        """Unix wall-clock seconds (span start stamps)."""
        return self.now()


class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Simulated time: ``sleep`` advances the clock instead of waiting.
    Thread-safe; concurrent sleepers each advance it under a lock."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += max(0.0, seconds)
