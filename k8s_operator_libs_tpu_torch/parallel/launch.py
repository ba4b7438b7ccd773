"""Run a function on n ranks of a fresh process group, on one host.

:func:`run` starts n processes with the ``spawn`` start method (a child
re-imports ``fn``'s module, which must therefore be importable without
side effects), joins them in a process group that rendezvouses through a
``file://`` path (no port to collide on), calls ``fn(*args)`` in each and
returns the results in rank order. Each rank's CUDA device is
``cuda:(rank % device_count)``: on a host with one card every rank shares
it, which gloo allows and NCCL does not. A rank that raises, dies or
outlives ``timeout`` fails the whole call, and every rank still running
is then killed: a deadlocked collective ends in an error, never a hang.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


class RankFailed(RuntimeError):
    pass


def _entry(rank: int, world: int, init_method: str, backend: str,
           fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist
    reported = False
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            out = fn(*args)
        except BaseException:
            # reported before the group is torn down: the peers then fail
            # on the closed connections, after this rank's report
            results.put((rank, False, traceback.format_exc()))
            reported = True
            raise
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which fails
        if not reported:
            results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, procs, rank: int, trace: str,
              wait: float = 3.0) -> str:
    """The first failure and those the other ranks report within
    ``wait`` seconds, or until every rank has exited (a rank whose peer
    died fails too: the first to arrive need not be the cause)."""
    parts = [f"rank {rank} failed:\n{trace}"]
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            r, ok, value = results.get(timeout=0.1)
        except queue_mod.Empty:
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if not ok:
            parts.append(f"rank {r} failed:\n{value}")
    return "\n".join(parts)


def run(fn: Callable, world: int, *args: Any, backend: str = "gloo",
        timeout: float = 120.0, workdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` ranks; the list of their results by
    rank (each must pickle). Raises :class:`RankFailed` with the failing
    rank's traceback, or when ``timeout`` seconds pass first."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rdv-", dir=workdir)
    init_method = f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, world, init_method, backend, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a child blocks on its put
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailed(f"{world} ranks: no result from ranks "
                                 f"{sorted(set(range(world)) - set(out))} "
                                 f"within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a result may have landed between the get and the
                    # check: look once more before failing
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RankFailed(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RankFailed(_failures(results, procs, rank, value))
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
