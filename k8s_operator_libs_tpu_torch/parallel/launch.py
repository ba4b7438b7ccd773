"""Run a function on n ranks of a fresh process group, on one host.

:func:`run` starts n processes with the ``spawn`` start method (a child
re-imports ``fn``'s module, which must therefore be importable without
side effects), joins them in a process group that rendezvouses through a
``file://`` path (no port to collide on), calls ``fn(*args)`` in each
and returns the results in rank order. Each rank's CUDA device is
``cuda:(i % device_count)``, ``i`` the process's index in the job: on a
host with one card every rank shares it, which gloo allows and NCCL does
not. A rank that raises, dies or outlives
``timeout`` fails the whole call, and every rank still running is then
killed: a deadlocked collective ends in an error, never a hang.

An elastic job (:class:`Job`) adds ranks to a running one: each process
is a member of a generation of the group
(:class:`..parallel.distributed.Membership`), and joiners started into
generation g wait at its rendezvous until the running members re-form
the group over them. A rank that leaves the group (an elastic shrink
reclaimed it) and returns is a success like any other; its result says
what it did. In a rank, :func:`membership` is the generation it joined.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from .distributed import Membership, cluster_membership


class RankFailed(RuntimeError):
    pass


_MEMBERSHIP: Optional[Membership] = None   # set in a launched rank only


def membership() -> Optional[Membership]:
    """The generation this launched rank joined (None outside one)."""
    return _MEMBERSHIP


def _entry(index: int, member: Membership, fn: Callable, args: tuple,
           results) -> None:
    global _MEMBERSHIP
    import torch
    import torch.distributed as dist
    reported = False
    name = member.me
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(index % torch.cuda.device_count())
        member.join()
        _MEMBERSHIP = member
        try:
            out = fn(*args)
        except BaseException:
            # reported before the group is torn down: the peers then fail
            # on the closed connections, after this rank's report
            results.put((name, False, traceback.format_exc()))
            reported = True
            raise
        finally:
            # a rank an elastic shrink reclaimed has left its group
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((name, True, out))
    except BaseException:       # reported to the parent, which fails
        if not reported:
            results.put((name, False, traceback.format_exc()))
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Job:
    """Processes of one job on this host, each a member of a generation
    of its process group, with one time limit for all of them
    (``timeout`` seconds from the job's start). ``rendezvous`` is
    ``"file"`` (a path under ``workdir``) or ``"tcp"`` (a store on
    localhost; generation g's at the job's port + g). Use it as a
    context manager: leaving it kills every process still running."""

    def __init__(self, backend: str = "gloo", timeout: float = 120.0,
                 workdir: Optional[str] = None, rendezvous: str = "file"):
        self.backend = backend
        self.timeout = timeout
        self._ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="rdv-", dir=workdir)
        if rendezvous == "file":
            self.rendezvous = f"file://{os.path.join(self._tmp, 'store')}"
        elif rendezvous == "tcp":
            self.rendezvous = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError(f"rendezvous {rendezvous!r}: file or tcp")
        self._results = self._ctx.Queue()
        self._procs: Dict[str, Any] = {}
        self._out: Dict[str, Any] = {}
        self._deadline = time.monotonic() + timeout

    @staticmethod
    def members(first: int, count: int) -> List[str]:
        """Member names ``localhost/<i>`` for i in [first, first + count):
        ``i`` also picks the process's card."""
        return [f"localhost/{i}" for i in range(first, first + count)]

    def start(self, fn: Callable, members: Sequence[str], *args: Any,
              generation: int = 0,
              only: Optional[Sequence[str]] = None) -> None:
        """Start a process for each of ``only`` (default every member),
        each joining generation ``generation`` over ``members`` and then
        calling ``fn(*args)``."""
        for name in (members if only is None else only):
            self._spawn(fn, Membership(self.rendezvous, tuple(members), name,
                                       self.backend, generation),
                        int(name.rsplit("/", 1)[-1]), args)

    def _spawn(self, fn: Callable, member: Membership, index: int,
               args: tuple) -> None:
        """One process that joins as ``member`` on card ``index`` (modulo
        the cards there are) and calls ``fn(*args)``."""
        if member.me in self._procs:
            raise ValueError(f"member {member.me} already started")
        p = self._ctx.Process(target=_entry, daemon=True,
                              args=(index, member, fn, args, self._results))
        p.start()
        self._procs[member.me] = p

    def _failures(self, name: str, trace: str, wait: float = 3.0) -> str:
        """The first failure and those the other ranks report within
        ``wait`` seconds, or until every rank has exited (a rank whose
        peer died fails too: the first to arrive need not be the
        cause)."""
        parts = [f"rank {name} failed:\n{trace}"]
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            try:
                other, ok, value = self._results.get(timeout=0.1)
            except queue_mod.Empty:
                if all(p.exitcode is not None
                       for p in self._procs.values()):
                    break
                continue
            if not ok:
                parts.append(f"rank {other} failed:\n{value}")
        return "\n".join(parts)

    def wait(self, until: Optional[Callable[[], bool]] = None
             ) -> Dict[str, Any]:
        """Collect results until every started process has returned one,
        or, with ``until``, until ``until()`` is true (polled about once a
        second); the results so far, by member. Raises
        :class:`RankFailed` with the failing rank's traceback, or when the
        job's time limit passes first."""
        # drain the queue before joining: a child blocks on its put
        while len(self._out) < len(self._procs):
            if until is not None and until():
                return dict(self._out)
            left = self._deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(self._procs) - set(self._out))
                raise RankFailed(f"{len(self._procs)} ranks: no result "
                                 f"from {missing} within "
                                 f"{self.timeout:.0f} s")
            try:
                name, ok, value = self._results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [n for n, p in self._procs.items()
                        if n not in self._out and p.exitcode is not None]
                if not dead:
                    continue
                # a result may have landed between the get and the
                # check: look once more before failing
                try:
                    name, ok, value = self._results.get(timeout=1.0)
                except queue_mod.Empty:
                    raise RankFailed(
                        f"rank {dead[0]} exited with code "
                        f"{self._procs[dead[0]].exitcode} and no result"
                    ) from None
            if not ok:
                raise RankFailed(self._failures(name, value))
            self._out[name] = value
        for p in self._procs.values():
            p.join(max(1.0, self._deadline - time.monotonic()))
        return dict(self._out)

    def close(self) -> None:
        for p in self._procs.values():
            if p.is_alive():
                p.kill()
                p.join(10)
        self._results.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "Job":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run(fn: Callable, world: int, *args: Any, backend: str = "gloo",
        timeout: float = 120.0, workdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` ranks; the list of their results by
    rank (each must pickle). Raises :class:`RankFailed` with the failing
    rank's traceback, or when ``timeout`` seconds pass first."""
    with Job(backend, timeout, workdir) as job:
        members = job.members(0, world)
        job.start(fn, members, *args)
        out = job.wait()
    return [out[m] for m in members]


def run_placed(fn: Callable, envs: Sequence[dict], *args: Any,
               backend: str = "gloo", timeout: float = 120.0,
               workdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` in one process per env: each a placed pod's env
    (``gpu/scheduler.py``) with the ``LOCAL_RANK`` of one of the
    processes the pod starts, joined through
    :func:`..parallel.distributed.cluster_membership` at the env's
    coordinator, on card ``LOCAL_RANK``. The results in rank order."""
    placed = [(cluster_membership(env, backend), env) for env in envs]
    if any(m is None for m, _ in placed):
        raise ValueError("an env names no process group")
    members = placed[0][0].members
    if sorted(m.me for m, _ in placed) != sorted(members):
        raise ValueError(f"the envs are not one process for each of "
                         f"{list(members)}")
    with Job(backend, timeout, workdir) as job:
        for member, env in placed:
            job._spawn(fn, member, int(env.get("LOCAL_RANK", "0")), args)
        out = job.wait()
    return [out[m] for m in members]
