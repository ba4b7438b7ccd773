"""Multi-host ``torch.distributed`` initialization from the operator's pod
env.

Port of the JAX package's ``parallel/distributed.py`` (``cluster_env``
:27, ``maybe_initialize_from_env`` :57). The SliceScheduler places one pod
per host and injects ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``JAX_COORDINATOR_ADDRESS`` (``host:port`` behind the workload's headless
Service) and, for a job over several slices, ``MEGASCALE_NUM_SLICES`` and
``MEGASCALE_SLICE_ID``. The same env read here gives the process group's
rank, world size and rendezvous: a TCP store at the coordinator's address
(rank 0 serves it). A single-process job returns None and initializes
nothing, so one entry point runs everywhere.

Where the reference's one process per host drives every chip of the
host, the port runs one process per GPU: a pod that starts
``LOCAL_WORLD_SIZE`` processes (the GPU scheduler's env says how many,
``gpu/scheduler.py``; ``torchrun --nproc-per-node`` sets it too) gives
each its ``LOCAL_RANK``, and the host's ranks are consecutive. Without
``LOCAL_WORLD_SIZE`` a host is one rank, as in the reference.

An elastic job re-forms its group when ranks leave or join
(:class:`Membership`): a ``torch.distributed`` world cannot add or drop a
rank in place, so every member destroys the group (and with it every
subgroup) and the members of the next generation join a new one, through
a rendezvous of that generation alone.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import time
from typing import Optional, Sequence
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def cluster_env(environ=None) -> Optional[dict]:
    """The scheduler's env as ``init_process_group`` arguments
    (``init_method``, ``world_size``, ``rank``); None when the job is one
    process or the env is incomplete, where the reference returns None.
    World size is hosts x slices x ``LOCAL_WORLD_SIZE`` and the rank
    (slice x hosts + worker) x ``LOCAL_WORLD_SIZE`` + ``LOCAL_RANK``: the
    reference's process ids with each host's local ranks in between."""
    env = os.environ if environ is None else environ
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
                 if h]
    num_slices = int(env.get("MEGASCALE_NUM_SLICES", "1"))
    num_hosts = len(hostnames)
    local, local_rank = _local(env)
    # a job over several single-host slices is several processes too
    if num_hosts * num_slices * local < 2:
        return None
    worker_id = env.get("TPU_WORKER_ID")
    coordinator = env.get("JAX_COORDINATOR_ADDRESS")
    if worker_id is None or not coordinator:
        return None
    host = int(worker_id)
    if num_slices > 1:
        # hosts are unique over the job: slice_id * hosts + worker_id
        host += int(env.get("MEGASCALE_SLICE_ID", "0")) * num_hosts
    return {"init_method": f"tcp://{coordinator}",
            "world_size": num_hosts * num_slices * local,
            "rank": host * local + local_rank}


def _local(env) -> tuple:
    """(processes on this host, this process's index among them) from
    ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK``; (1, 0) without them."""
    local = int(env.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", "0"))
    if local < 1 or not 0 <= local_rank < local:
        raise ValueError(f"LOCAL_RANK {local_rank} is not one of the "
                         f"{local} local ranks (LOCAL_WORLD_SIZE)")
    return local, local_rank


def cluster_membership(environ=None,
                       backend: Optional[str] = None
                       ) -> Optional["Membership"]:
    """This process's :class:`Membership` of the group
    :func:`cluster_env` describes, its members named
    ``"<hostname>/cuda:<local rank>"`` in rank order; None where
    :func:`cluster_env` is None or the job spans slices (the env names
    only this slice's hosts)."""
    env = os.environ if environ is None else environ
    kwargs = cluster_env(env)
    if kwargs is None or int(env.get("MEGASCALE_NUM_SLICES", "1")) > 1:
        return None
    hosts = [h for h in env["TPU_WORKER_HOSTNAMES"].split(",") if h]
    local, _ = _local(env)
    members = tuple(f"{h}/cuda:{i}" for h in hosts for i in range(local))
    return Membership(rendezvous=kwargs["init_method"], members=members,
                      me=members[kwargs["rank"]],
                      backend=backend or default_backend())


@dataclasses.dataclass(frozen=True)
class Membership:
    """One generation of an elastic job's process group. ``members`` name
    the ranks' devices (opaque strings, e.g. ``"<host>/cuda:<i>"``) in
    rank order; ``me`` is this process's. ``rendezvous`` is the job's
    ``init_method``: ``file://<path>`` (one host or a shared file
    system) or ``tcp://<host>:<port>``."""

    rendezvous: str
    members: Sequence[str]
    me: str
    backend: str
    generation: int = 0

    @property
    def rank(self) -> int:
        return list(self.members).index(self.me)

    def init_method(self) -> str:
        """This generation's rendezvous. A file store is never reused
        across inits (a stale file deadlocks or mis-ranks the next one),
        so each generation has its own path. A TCP store is served by
        rank 0, so generation g's is served by its first member, on the
        host its name starts with, at the job's port + g: it does not
        depend on a rank that left."""
        if self.generation == 0:
            return self.rendezvous
        if self.rendezvous.startswith("file://"):
            return f"{self.rendezvous}.g{self.generation}"
        url = urlsplit(self.rendezvous)
        if url.scheme != "tcp" or url.port is None:
            raise ValueError(f"rendezvous {self.rendezvous!r} is neither "
                             f"file:// nor tcp://host:port")
        host = str(self.members[0]).split("/")[0]
        return f"tcp://{host}:{url.port + self.generation}"

    def port_taken(self) -> Optional[str]:
        """Why this member cannot serve this generation's TCP store (its
        port is held by another socket on this host), or None: where the
        rendezvous is a file, or another member serves it. A member that
        joined a store some other process holds would wait for it
        without end."""
        url = urlsplit(self.init_method())
        if url.scheme != "tcp" or self.me != self.members[0]:
            return None
        with socket.socket() as s:
            # as the store binds: a socket left in TIME_WAIT is no obstacle
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("", url.port))
            except OSError as exc:
                return (f"generation {self.generation}'s rendezvous port "
                        f"{url.port} on {url.hostname} is taken "
                        f"({exc.strerror}): its first member {self.me} "
                        f"cannot serve the group's store")
        return None

    def join(self) -> None:
        """Join this generation's group as ``rank``. Raises
        :class:`RendezvousPortTaken` where this member serves the store
        and its port is taken."""
        taken = self.port_taken()
        if taken:
            raise RendezvousPortTaken(taken)
        logger.info("joining generation %d as rank %d of %d",
                    self.generation, self.rank, len(self.members))
        dist.init_process_group(self.backend,
                                init_method=self.init_method(),
                                world_size=len(self.members),
                                rank=self.rank)

    def reform(self, members: Sequence[str]) -> Optional["Membership"]:
        """Leave this generation's group and, when ``me`` is among
        ``members``, join the next generation's over them (their order is
        the new rank order); None for a member that left. Every member of
        this generation calls it with the same list; a new member joins
        with ``Membership(..., members, me, generation=g + 1).join()``.
        The next generation's first member checks its store's port and
        tells the others over this generation's group before they leave
        it: where the port is taken, every member raises
        :class:`RendezvousPortTaken` and none waits at that port."""
        nxt = dataclasses.replace(self, members=tuple(members),
                                  generation=self.generation + 1)
        if dist.is_available() and dist.is_initialized():
            said = [None] * dist.get_world_size()
            dist.all_gather_object(said, nxt.port_taken())
            dist.destroy_process_group()
            taken = next((m for m in said if m), None)
            if taken:
                raise RendezvousPortTaken(taken)
        if self.me not in nxt.members:
            return None
        nxt.join()
        return nxt


class RendezvousPortTaken(RuntimeError):
    """A generation's TCP store cannot be served: its port is taken."""


# the store key each rank adds one to once it has torn its group down
LEFT_KEY = "left-process-group"


def leave_process_group(timeout: float = 60.0) -> None:
    """Leave the default process group with every rank together. A
    barrier first; then each rank tears its group down and checks out on
    the group's store, and rank 0, which serves a TCP store, returns
    only once every rank has checked out (or ``timeout`` seconds pass).
    A rank that tore its group down while the store's owner had already
    exited could abort in the store's or the backend's teardown
    ("terminate called without an active exception")."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.barrier()
    dist.destroy_process_group()
    store.add(LEFT_KEY, 1)
    if rank != 0:
        return
    deadline = time.monotonic() + timeout  # det: allow — a real rendezvous over the process group's store
    while store.add(LEFT_KEY, 0) < world:
        if time.monotonic() > deadline:  # det: allow — a real rendezvous over the process group's store
            logger.warning("%d of %d ranks checked out of the process "
                           "group in %.0f s; leaving anyway",
                           store.add(LEFT_KEY, 0), world, timeout)
            return
        time.sleep(0.01)  # det: allow — polls real ranks checking out of the store


def default_backend(device: str = "cuda", environ=None) -> str:
    """The backend for ranks that train on ``device``: NCCL on GPUs, gloo
    for CPU ranks and where a host starts more ranks
    (``LOCAL_WORLD_SIZE``) than it has GPUs, since NCCL refuses two ranks
    on one device; gloo then stages the collectives through host
    memory."""
    env = os.environ if environ is None else environ
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local = int(env.get("LOCAL_WORLD_SIZE", "1"))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def maybe_initialize_from_env(environ=None, _initialize=None,
                              backend: Optional[str] = None) -> bool:
    """Join the process group the pod env describes; True when it ran.
    Safe to call unconditionally: a single-host job returns False.
    ``_initialize`` replaces ``torch.distributed.init_process_group`` (a
    test seam)."""
    kwargs = cluster_env(environ)
    if kwargs is None:
        return False
    if _initialize is None:
        _initialize = dist.init_process_group
    logger.info("joining torch.distributed process group: %s", kwargs)
    _initialize(backend=backend or default_backend(), **kwargs)
    return True
