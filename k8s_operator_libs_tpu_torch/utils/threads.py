"""Named threads, locks and events (a copy of the JAX package's
``utils/threads.py``).

The router binary's lock and drain-watch ticker, the request recorder's
lock and the replica pool's registry lock are made here, so every
thread has a name (:func:`live_threads` answers which one leaked after
a stop) and each thread keeps the stack of named locks it holds
(:func:`held_locks`). A backend with the :class:`RealBackend` surface
may be installed in place of the stdlib one (:func:`use_backend`), as a
cooperative scheduler that runs the real components one thread at a
time does.

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
    "spawn", "make_lock", "make_event", "live_threads", "held_locks",
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


# ------------------------------------------------------------ real backend

class _NamedLock:
    """threading.Lock with a name and held-stack accounting."""

    __slots__ = ("name", "_raw")

    def __init__(self, name: str, raw):
        self.name = name
        self._raw = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            _push_held(self)
        return ok

    def release(self) -> None:
        _pop_held(self)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "_NamedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


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

    def event(self, name: str):
        return _NamedEvent(name, threading.Event())


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


def make_event(name: str):
    return _backend.event(name)


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
