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
"""

from __future__ import annotations

import logging
import os
from typing import Optional

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
