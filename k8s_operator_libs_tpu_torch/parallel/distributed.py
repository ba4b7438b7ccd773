"""Multi-host ``torch.distributed`` initialization from the operator's pod
env.

Port of the JAX package's ``parallel/distributed.py`` (``cluster_env``
:27, ``maybe_initialize_from_env`` :57). The SliceScheduler places one pod
per host and injects ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``JAX_COORDINATOR_ADDRESS`` (``host:port`` behind the workload's headless
Service) and, for a job over several slices, ``MEGASCALE_NUM_SLICES`` and
``MEGASCALE_SLICE_ID``. The same env read here gives the process group's
rank, world size and rendezvous: a TCP store at the coordinator's address
(rank 0 serves it). A single-host job returns None and initializes
nothing, so one entry point runs everywhere.

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
from typing import Optional, Sequence
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def cluster_env(environ=None) -> Optional[dict]:
    """The scheduler's env as ``init_process_group`` arguments
    (``init_method``, ``world_size``, ``rank``); None when the job is one
    process or the env is incomplete, where the reference returns None."""
    env = os.environ if environ is None else environ
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
                 if h]
    num_slices = int(env.get("MEGASCALE_NUM_SLICES", "1"))
    num_hosts = len(hostnames)
    # a job over several single-host slices is several processes too
    if num_hosts * num_slices < 2:
        return None
    worker_id = env.get("TPU_WORKER_ID")
    coordinator = env.get("JAX_COORDINATOR_ADDRESS")
    if worker_id is None or not coordinator:
        return None
    rank = int(worker_id)
    if num_slices > 1:
        # ranks are unique over the job: slice_id * hosts + worker_id
        rank += int(env.get("MEGASCALE_SLICE_ID", "0")) * num_hosts
    return {"init_method": f"tcp://{coordinator}",
            "world_size": num_hosts * num_slices, "rank": rank}


def cluster_membership(environ=None,
                       backend: Optional[str] = None
                       ) -> Optional["Membership"]:
    """This host's :class:`Membership` of the group :func:`cluster_env`
    describes, its members named ``"<hostname>/cuda:0"`` in rank order;
    None where :func:`cluster_env` is None or the job spans slices (the
    env names only this slice's hosts)."""
    env = os.environ if environ is None else environ
    kwargs = cluster_env(env)
    if kwargs is None or int(env.get("MEGASCALE_NUM_SLICES", "1")) > 1:
        return None
    hosts = [h for h in env["TPU_WORKER_HOSTNAMES"].split(",") if h]
    members = tuple(f"{h}/cuda:0" for h in hosts)
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

    def join(self) -> None:
        """Join this generation's group as ``rank``."""
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
        with ``Membership(..., members, me, generation=g + 1).join()``."""
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        nxt = dataclasses.replace(self, members=tuple(members),
                                  generation=self.generation + 1)
        if self.me not in nxt.members:
            return None
        nxt.join()
        return nxt


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
