"""Cooperative schedule explorer over the ``utils/threads`` shim (the
port's twin of the JAX package's ``tools/race/scheduler.py``).

The scheduler installs itself as the *backend* of
``k8s_operator_libs_tpu_torch.utils.threads`` (see :mod:`.explore`), so
the port's real concurrent components (drain and eviction workers,
informers, the lease renew loop, the checkpoint uploader, the router
ticker) run exactly one thread at a time, with a **preemption point** at
every shim lock or event operation and every read or sleep of the
injected clock. Where more than one task is runnable the scheduler makes
a seeded choice and records it; the recorded trace replays the same
schedule from the same seed.

Mechanics: every task is a real OS thread gated by a private baton
semaphore; the driver loop holds a control semaphore, so at any moment
exactly one of {driver, one task} executes and the scheduler's own state
needs no lock. Blocking is virtual: a task waiting on a held lock, an
unset event, a sleep or a join is *descheduled*; when no task is
runnable the clock jumps to the earliest timed wake, and if there is
none the run fails with a :class:`DeadlockError` naming every task's
wait, a readable report where a real run would hang.

Determinism: given the same harness and seed, the sequence of runnable
sets is the same, so the choices, the trace and the failure are the
same. A harness routes all its randomness and time through the
scheduler.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import threads as shim
from ..utils.clock import Clock


class DeadlockError(AssertionError):
    """No runnable task, no timed wake — every live task waits forever."""


class BudgetExceeded(AssertionError):
    """The schedule did not terminate inside the decision budget."""


class _Aborted(BaseException):
    """Raised inside a task when the run tears down early. Derives from
    BaseException so components' ``except Exception`` recovery paths
    cannot swallow the abort."""


# the stdlib backend, which makes the OS threads the tasks run on
_OS_THREADS = shim.RealBackend()

RUNNABLE = "runnable"
RUNNING = "running"
BLOCKED = "blocked"
DONE = "done"
NEW = "new"


class _Task:
    def __init__(self, index: int, name: str, target: Callable,
                 args: tuple, kwargs: dict, daemon: bool):
        self.index = index
        self.name = name
        self.target = target
        self.args = args
        self.kwargs = kwargs
        self.daemon = daemon
        self.state = NEW
        self.baton = threading.Semaphore(0)
        self.os_thread: Optional[threading.Thread] = None
        self.wait_reason: Optional[str] = None
        self.wait_obj: Optional[object] = None
        self.wake_at: Optional[float] = None
        self.timed_out = False
        self.exc: Optional[BaseException] = None

    def describe(self) -> str:
        if self.state == BLOCKED:
            extra = f" on {self.wait_reason}"
            if self.wake_at is not None:
                extra += f" until t={self.wake_at:.3f}"
            return f"{self.name}: blocked{extra}"
        return f"{self.name}: {self.state}"


class CoopThreadHandle:
    """What the shim's ``spawn`` returns under this backend — the same
    surface as a ``threading.Thread`` the call sites use."""

    def __init__(self, sched: "CoopScheduler", task: _Task):
        self._sched = sched
        self._task = task

    @property
    def name(self) -> str:
        return self._task.name

    @property
    def daemon(self) -> bool:
        return self._task.daemon

    @property
    def ident(self) -> Optional[int]:
        t = self._task.os_thread
        return t.ident if t is not None else None

    def start(self) -> None:
        self._sched._start_task(self._task)

    def is_alive(self) -> bool:
        return self._task.state not in (NEW, DONE)

    def join(self, timeout: Optional[float] = None) -> None:
        self._sched._join(self._task, timeout)
        if self._task.state == DONE:
            # happens-before edge for the lockset checker: the joined
            # task's exclusive state becomes the joiner's
            shim.notify_join(f"coop-{self._task.name}")


class CoopLock:
    def __init__(self, sched: "CoopScheduler", name: str):
        self._sched = sched
        self.name = name
        self.holder: Optional[_Task] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        sched._preempt(f"acquire:{self.name}")
        task = sched._current()
        if self._try_take(task):
            return True
        if not blocking:
            return False
        deadline = None if timeout is None or timeout < 0 \
            else sched.clock.peek() + timeout
        while not self._try_take(task):
            if not sched._block(task, f"lock:{self.name}", self, deadline):
                return False  # timed out with the lock still held
        return True

    def _try_take(self, task: Optional[_Task]) -> bool:
        if self.holder is None:
            self.holder = task
            shim._push_held(self)
            return True
        return False

    def release(self) -> None:
        self.holder = None
        shim._pop_held(self)
        self._sched._wake_waiters(self)
        self._sched._preempt(f"release:{self.name}")

    def locked(self) -> bool:
        return self.holder is not None

    def __enter__(self) -> "CoopLock":
        self.acquire()  # lint: ignore — context-manager protocol; __exit__ releases
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class CoopRLock(CoopLock):
    def __init__(self, sched: "CoopScheduler", name: str):
        super().__init__(sched, name)
        self.depth = 0

    def _try_take(self, task: Optional[_Task]) -> bool:
        if self.holder is None or self.holder is task:
            self.holder = task
            self.depth += 1
            shim._push_held(self)
            return True
        return False

    def release(self) -> None:
        self.depth -= 1
        shim._pop_held(self)
        if self.depth <= 0:
            self.holder = None
            self._sched._wake_waiters(self)
        self._sched._preempt(f"release:{self.name}")


class CoopEvent:
    def __init__(self, sched: "CoopScheduler", name: str):
        self._sched = sched
        self.name = name
        self._flag = False

    def is_set(self) -> bool:
        self._sched._preempt(f"event-poll:{self.name}")
        return self._flag

    def set(self) -> None:
        self._sched._preempt(f"event-set:{self.name}")
        self._flag = True
        self._sched._wake_waiters(self)

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        sched._preempt(f"event-wait:{self.name}")
        if self._flag:
            return True
        task = sched._current()
        deadline = None if timeout is None \
            else sched.clock.peek() + max(0.0, timeout)
        while not self._flag:
            if not sched._block(task, f"event:{self.name}", self, deadline):
                break  # timed out
        return self._flag


class SchedClock(Clock):
    """The scheduler's virtual clock: reads are preemption points, sleeps
    deschedule the task, and time advances only when every task is
    blocked — so a 300 s drain timeout costs nothing and a
    wait-vs-timeout race is a schedulable choice, not a flake."""

    def __init__(self, sched: "CoopScheduler", start: float):
        self._sched = sched
        self._now = start

    def peek(self) -> float:
        """Current virtual time WITHOUT a preemption point (used by the
        primitives to compute deadlines mid-operation)."""
        return self._now

    def now(self) -> float:
        self._sched._preempt("clock.now")
        return self._now

    def wall(self) -> float:
        return self.now()

    def sleep(self, seconds: float) -> None:
        self._sched._sleep(max(0.0, seconds))


@dataclasses.dataclass
class RunReport:
    """One schedule's outcome."""

    seed: int
    trace: List[str]
    decisions: int
    elapsed_virtual: float
    failure: Optional[str] = None          # first failure, human-readable
    failure_kind: Optional[str] = None     # exception|deadlock|budget
    task_states: List[str] = dataclasses.field(default_factory=list)
    result: Any = None                     # harness return value

    @property
    def failed(self) -> bool:
        return self.failure is not None


class CoopScheduler:
    """One exploration run: backend + scheduler + virtual clock."""

    def __init__(self, seed: int = 0, replay: Optional[List[str]] = None,
                 max_decisions: int = 200_000, start_time: float = 1000.0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.replay = list(replay) if replay is not None else None
        self._replay_i = 0
        self.trace: List[str] = []
        self.clock = SchedClock(self, start_time)
        self._start_time = start_time
        self.tasks: List[_Task] = []
        self._ident: Dict[int, _Task] = {}
        self._control = threading.Semaphore(0)
        self.current: Optional[_Task] = None
        self.decisions = 0
        self.max_decisions = max_decisions
        self.aborting = False
        self.failure: Optional[Tuple[str, str]] = None   # (kind, message)
        self._ran = False

    # ------------------------------------------------------ backend surface

    def thread(self, name: str, target: Callable, args: tuple,
               kwargs: dict, daemon: bool) -> CoopThreadHandle:
        task = _Task(len(self.tasks), name, target, args, kwargs, daemon)
        self.tasks.append(task)
        return CoopThreadHandle(self, task)

    def lock(self, name: str) -> CoopLock:
        return CoopLock(self, name)

    def rlock(self, name: str) -> CoopRLock:
        return CoopRLock(self, name)

    def event(self, name: str) -> CoopEvent:
        return CoopEvent(self, name)

    def condition(self, name: str, lock=None):
        raise NotImplementedError(
            "no library component uses a Condition; add a CoopCondition "
            "when one does")

    # ------------------------------------------------------------ task side

    def _current(self) -> Optional[_Task]:
        return self._ident.get(threading.get_ident())

    def _start_task(self, task: _Task) -> None:
        if task.state != NEW:
            raise RuntimeError(f"task {task.name} started twice")
        os_thread = self._os_thread(task)
        task.os_thread = os_thread
        task.state = RUNNABLE
        os_thread.start()
        # the new task may legitimately run before the spawner's next line
        self._preempt(f"spawn:{task.name}")

    def _os_thread(self, task: _Task) -> threading.Thread:
        """The OS thread a task runs on, made by the stdlib backend (the
        shim's current backend is this scheduler)."""
        return _OS_THREADS.thread(f"coop-{task.name}", self._task_main,
                                  (task,), {}, True)

    def _task_main(self, task: _Task) -> None:
        self._ident[threading.get_ident()] = task
        task.baton.acquire()  # lint: ignore — baton semaphore, released by the driver
        try:
            if not self.aborting:
                task.target(*task.args, **task.kwargs)
        except _Aborted:
            pass
        except BaseException as exc:  # noqa: BLE001 — the report surface
            task.exc = exc
            if self.failure is None and not self.aborting:
                self.failure = (
                    "exception",
                    f"task {task.name!r} raised "
                    f"{type(exc).__name__}: {exc}")
        finally:
            task.state = DONE
            self._wake_waiters(task)   # joiners
            self._control.release()

    def _preempt(self, label: str) -> None:
        """A potential context switch: yield to the driver, which may
        resume this task immediately or run another runnable one."""
        task = self._current()
        if task is None or self.current is not task:
            return  # called outside a scheduled task (driver/teardown)
        if self.aborting:
            raise _Aborted()
        task.state = RUNNABLE
        task.wait_reason = label
        self._control.release()
        task.baton.acquire()  # lint: ignore — baton handoff, not a lock
        if self.aborting:
            raise _Aborted()

    def _block(self, task: Optional[_Task], reason: str,
               wait_obj: Optional[object],
               deadline: Optional[float]) -> bool:
        """Deschedule until :meth:`_wake_waiters` (returns True) or the
        virtual deadline (returns False)."""
        if task is None or self.current is not task:
            # not under scheduler control (teardown path): do not block
            return True
        if self.aborting:
            raise _Aborted()
        task.state = BLOCKED
        task.wait_reason = reason
        task.wait_obj = wait_obj
        task.wake_at = deadline
        task.timed_out = False
        self._control.release()
        task.baton.acquire()  # lint: ignore — baton handoff, not a lock
        if self.aborting:
            raise _Aborted()
        timed_out = task.timed_out
        task.timed_out = False
        return not timed_out

    def _sleep(self, seconds: float) -> None:
        task = self._current()
        if task is None or self.current is not task:
            return
        if seconds == 0.0:
            self._preempt("sleep:0")
            return
        self._block(task, "sleep", None, self.clock.peek() + seconds)

    def _join(self, target: _Task, timeout: Optional[float]) -> None:
        task = self._current()
        if target.state == DONE or target.state == NEW:
            self._preempt(f"join:{target.name}")
            return
        deadline = None if timeout is None \
            else self.clock.peek() + max(0.0, timeout)
        while target.state != DONE:
            if not self._block(task, f"join:{target.name}", target,
                               deadline):
                return  # join timeout — caller re-checks is_alive()

    def _wake_waiters(self, obj: object) -> None:
        for t in self.tasks:
            if t.state == BLOCKED and t.wait_obj is obj:
                t.state = RUNNABLE
                t.wait_obj = None
                t.wake_at = None
                t.timed_out = False

    # --------------------------------------------------------- driver side

    def _choose(self, runnable: List[_Task]) -> _Task:
        runnable = sorted(runnable, key=lambda t: t.index)
        if len(runnable) == 1:
            return runnable[0]
        if self.replay is not None:
            if self._replay_i < len(self.replay):
                want = self.replay[self._replay_i]
                self._replay_i += 1
                pick = next((t for t in runnable if t.name == want), None)
                if pick is None:
                    pick = runnable[0]  # shrunk trace drift: default
            else:
                pick = runnable[0]      # trace exhausted: deterministic
        else:
            pick = self.rng.choice(runnable)
        self.trace.append(pick.name)
        return pick

    def _advance_time(self) -> bool:
        """No runnable task: jump to the earliest timed wake. Returns
        False when there is none (deadlock or all done)."""
        timed = [t for t in self.tasks
                 if t.state == BLOCKED and t.wake_at is not None]
        if not timed:
            return False
        wake = min(t.wake_at for t in timed)
        self.clock._now = max(self.clock._now, wake)
        for t in timed:
            if t.wake_at <= self.clock._now:
                t.state = RUNNABLE
                t.timed_out = True
                t.wait_obj = None
                t.wake_at = None
        return True

    def run(self, main_fn: Callable, *args, name: str = "main",
            **kwargs) -> RunReport:
        """Run ``main_fn(*args, **kwargs)`` as the root task to
        completion of ALL tasks (or first failure)."""
        if self._ran:
            raise RuntimeError("CoopScheduler instances are single-use; "
                               "make a new one per schedule")
        self._ran = True
        root = self.thread(name, main_fn, args, kwargs, True)
        # start the root OS thread without a preempt (no current task yet)
        task = root._task
        os_thread = self._os_thread(task)
        task.os_thread = os_thread
        task.state = RUNNABLE
        os_thread.start()

        while self.failure is None:
            # a timed wait whose deadline is already due (e.g. wait(0))
            # is runnable NOW, not only once every other task blocks
            for t in self.tasks:
                if t.state == BLOCKED and t.wake_at is not None \
                        and t.wake_at <= self.clock.peek():
                    t.state = RUNNABLE
                    t.timed_out = True
                    t.wait_obj = None
                    t.wake_at = None
            runnable = [t for t in self.tasks if t.state == RUNNABLE]
            if not runnable:
                if all(t.state in (DONE, NEW) for t in self.tasks):
                    break
                if not self._advance_time():
                    self.failure = (
                        "deadlock",
                        "deadlock: no runnable task and no timed wake — "
                        + "; ".join(t.describe() for t in self.tasks
                                    if t.state not in (DONE, NEW)))
                    break
                continue
            self.decisions += 1
            if self.decisions > self.max_decisions:
                self.failure = (
                    "budget",
                    f"schedule did not terminate within "
                    f"{self.max_decisions} decisions — livelock or an "
                    f"unbounded poll loop")
                break
            chosen = self._choose(runnable)
            chosen.state = RUNNING
            self.current = chosen
            chosen.baton.release()
            self._control.acquire()  # lint: ignore — driver waits for the task to yield
            self.current = None

        self._teardown()
        return RunReport(
            seed=self.seed, trace=list(self.trace),
            decisions=self.decisions,
            elapsed_virtual=self.clock.peek() - self._start_time,
            failure=self.failure[1] if self.failure else None,
            failure_kind=self.failure[0] if self.failure else None,
            task_states=[t.describe() for t in self.tasks])

    def _teardown(self) -> None:
        """Abort every unfinished task and join its OS thread: the next
        schedule must start with no leftover runner poking at shared
        component state."""
        self.aborting = True
        for t in self.tasks:
            if t.state not in (DONE, NEW):
                t.baton.release()
        for t in self.tasks:
            if t.os_thread is not None:
                t.os_thread.join(timeout=5.0)
