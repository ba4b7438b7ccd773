"""Named threads, locks and events (a copy of the JAX package's
``utils/threads.py``).

The port's threads, locks and events are made here, each under the
name the JAX package gives it (``obs/trace.py`` keeps raw locks, as the
reference does), so every thread has a name (:func:`live_threads`
answers which one leaked after a stop) and each thread keeps the stack
of named locks it holds (:func:`held_locks`). A backend with the
:class:`RealBackend` surface may be installed in place of the stdlib
one (:func:`use_backend`): ``race/scheduler.py``'s cooperative
scheduler is one, and runs the real components one thread at a time.

Usage::

    from ..utils import threads

    self._lock = threads.make_lock("router-front")
    stop = threads.make_event("router-ticker-stop")
    t = threads.spawn("router-ticker", ticker)
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

__all__ = [
    "spawn", "make_lock", "make_rlock", "make_event", "make_condition",
    "live_threads", "join_all", "held_locks", "add_join_hook",
    "remove_join_hook", "notify_join",
    "get_backend", "set_backend", "use_backend", "RealBackend",
]


# --------------------------------------------------------- held-lock stack
#
# Per-OS-thread stack of named locks currently held. A backend's locks
# call _push_held/_pop_held, whichever backend is installed.

class _Held(threading.local):
    def __init__(self):
        self.stack: List[object] = []


_held = _Held()


def _push_held(lock: object) -> None:
    _held.stack.append(lock)


def _pop_held(lock: object) -> None:
    # release() from a non-owning thread is legal for a plain Lock; the
    # releasing thread may simply not carry it — drop silently then.
    stack = _held.stack
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is lock:
            del stack[i]
            return


def held_locks() -> Tuple[object, ...]:
    """The shim locks the CURRENT thread holds, innermost last."""
    return tuple(_held.stack)


# ------------------------------------------------------------- join hooks
#
# A successful join is a happens-before edge: everything the joined
# thread did is visible to the joiner. A lockset checker registers a hook
# here so ownership of exclusively-accessed state can pass to the joiner.
# Backends call :func:`notify_join` after a join observes the target
# finished.

_join_hooks: List[Callable] = []


def add_join_hook(fn: Callable) -> None:
    _join_hooks.append(fn)


def remove_join_hook(fn: Callable) -> None:
    if fn in _join_hooks:
        _join_hooks.remove(fn)


def notify_join(joined_os_name: str) -> None:
    """Called by a backend on the JOINING thread once the joined thread
    is known finished. ``joined_os_name`` is the OS-thread name the
    joined work ran under."""
    for fn in list(_join_hooks):
        fn(joined_os_name)


# ------------------------------------------------------------ real backend

class _NamedLock:
    """threading.Lock with a name and held-stack accounting."""

    __slots__ = ("name", "_raw")

    def __init__(self, name: str, raw):
        self.name = name
        self._raw = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._raw.acquire(blocking, timeout)  # lint: ignore — the wrapper IS the lock; callers own release discipline
        if ok:
            _push_held(self)
        return ok

    def release(self) -> None:
        _pop_held(self)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "_NamedLock":
        self.acquire()  # lint: ignore — context-manager protocol; __exit__ releases
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class _NamedRLock(_NamedLock):
    __slots__ = ()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12-ish
        raw = getattr(self._raw, "locked", None)
        return raw() if raw is not None else False


class _NamedEvent:
    __slots__ = ("name", "_raw")

    def __init__(self, name: str, raw):
        self.name = name
        self._raw = raw

    def is_set(self) -> bool:
        return self._raw.is_set()

    def set(self) -> None:
        self._raw.set()

    def clear(self) -> None:
        self._raw.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._raw.wait(timeout)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class RealBackend:
    """The production backend: stdlib primitives behind named wrappers."""

    def thread(self, name: str, target: Callable, args: tuple,
               kwargs: dict, daemon: bool):
        return threading.Thread(target=target, name=name, args=args,
                                kwargs=kwargs, daemon=daemon)

    def lock(self, name: str):
        return _NamedLock(name, threading.Lock())

    def rlock(self, name: str):
        return _NamedRLock(name, threading.RLock())

    def event(self, name: str):
        return _NamedEvent(name, threading.Event())

    def condition(self, name: str, lock=None):
        raw = lock._raw if isinstance(lock, _NamedLock) else lock
        return threading.Condition(raw)


# --------------------------------------------------------- backend switch

_backend_lock = threading.Lock()
_backend: object = RealBackend()


def get_backend():
    return _backend


def set_backend(backend) -> object:
    """Install ``backend`` (anything with the RealBackend surface);
    returns the previous one. The cooperative explorer uses
    :class:`use_backend` instead — restore is exception-safe there."""
    global _backend
    with _backend_lock:
        prev = _backend
        _backend = backend
    return prev


class use_backend:
    """``with use_backend(sched): ...`` — scoped backend installation."""

    def __init__(self, backend):
        self._backend = backend
        self._prev = None

    def __enter__(self):
        self._prev = set_backend(self._backend)
        return self._backend

    def __exit__(self, *exc) -> bool:
        set_backend(self._prev)
        return False


# ------------------------------------------------------- thread registry

_registry_lock = threading.Lock()
_registry: List[object] = []          # handles of every spawned thread


def _finished(handle) -> bool:
    """Started once and no longer alive. A ``start=False`` handle whose
    caller hasn't started it yet (``ident`` unset) is NOT finished."""
    return not handle.is_alive() and getattr(handle, "ident", None) is not None


def _register(handle) -> None:
    with _registry_lock:
        # prune the finished so the registry stays bounded across a
        # process that spawns many short-lived workers
        _registry[:] = [h for h in _registry if not _finished(h)]
        _registry.append(handle)


def spawn(name: str, target: Callable, *, args: tuple = (),
          kwargs: Optional[dict] = None, daemon: bool = True,
          start: bool = True):
    """Create (and by default start) a named thread through the current
    backend, registering it for :func:`live_threads` accounting. With
    ``start=False`` the caller owns ``.start()`` (construct-in-init,
    start-in-start lifecycles)."""
    handle = _backend.thread(name, target, tuple(args), dict(kwargs or {}),
                             daemon)
    _register(handle)
    if start:
        handle.start()
    return handle


def make_lock(name: str):
    return _backend.lock(name)


def make_rlock(name: str):
    return _backend.rlock(name)


def make_event(name: str):
    return _backend.event(name)


def make_condition(name: str, lock=None):
    return _backend.condition(name, lock)


def live_threads(prefix: Optional[str] = None) -> List[object]:
    """Registered threads that are still alive — the shutdown-hygiene
    surface: after a clean component stop, ``live_threads(prefix=...)``
    for that component's name prefix must be empty. Threads spawned
    before their ``.start()`` (``start=False``) don't count until
    started."""
    with _registry_lock:
        _registry[:] = [h for h in _registry if not _finished(h)]
        out = [h for h in _registry if h.is_alive()]
    if prefix is not None:
        out = [h for h in out if (h.name or "").startswith(prefix)]
    return out


def join_all(prefix: Optional[str] = None, timeout: float = 5.0,
             clock=None) -> List[object]:
    """Join every live registered thread (optionally filtered by name
    prefix) under ONE shared deadline measured on ``clock`` (default:
    stdlib monotonic), so a wedged daemon thread cannot hold a binary's
    exit forever. Returns the threads still alive at the deadline
    (empty = clean)."""
    if clock is not None:
        now = clock.now
    else:
        import time
        now = time.monotonic
    deadline = now() + timeout
    stuck: List[object] = []
    for handle in live_threads(prefix):
        remaining = deadline - now()
        if remaining > 0:
            handle.join(remaining)
        if handle.is_alive():
            stuck.append(handle)
    return stuck
