"""Checkpoint, resume and drain-coordinated exit for the training loop.

Port of the JAX package's ``train/harness.py`` (``CheckpointingTrainer``
:138, ``init_or_resume`` :221, ``save`` :241, ``run`` :258) on one device.
The contract with the operator is the reference's: when the job's node is
drained, ``drain_signal`` turns true (SIGTERM in a pod, see
``cli.py``), the trainer writes a checkpoint synchronously and returns
with ``preempted=True``; the rescheduled job restores the latest
checkpoint and continues the same data stream.

A checkpoint is one directory per step, ``<checkpoint_dir>/<step>/``,
holding ``torch.save`` of the whole state (parameters, both optimizer
moments, the optimizer count and the step). It is written into a
temporary ``.tmp-*`` directory and moved into place with ``os.replace``,
so a reader (and :attr:`CheckpointingTrainer.latest_step`) never sees
half of one.

Periodic saves are asynchronous, as the reference's orbax saves are: the
state is copied into host buffers on the device's stream (the train step
updates parameters and moments in place, and the next step's update is
ordered after the copy), then a writer thread waits for the copy and
writes the file while the loop trains on. At most one save is in flight;
the drain save (``save(state, wait=True)``) and :meth:`close` wait for
it.

Under a mesh (the reference's ``mesh=``, :139-220) every rank runs the
loop on the same global batches. A checkpoint does not depend on the
mesh, as orbax's does not: rank 0 writes the whole tensors in the
one-device format (each leaf all-gathered over every axis its spec
splits it over, which every rank joins), and a restore at any mesh reads
them and keeps this rank's slices. So a run saved at 2 ranks resumes at
1, and one saved at 1 resumes at 2. A drain is agreed: each rank's
signal is all-reduced (over a gloo group on the host, so the loop does
not wait for the device) before every step, and all ranks stop at the
same step for the one drain save. So is a resume: every rank restores
the step rank 0 sees. Only rank 0 writes files; give only its trainer a
ledger.

With a :class:`~..obs.goodput.GoodputLedger` the loop records goodput
windows and badput phases (the first step, which on the card includes the
kernels' ``nvcc`` build; checkpoint save and restore; the drain save) and
synchronizes with the device only every ``metrics_sync_every`` steps and
at checkpoint, drain and end boundaries.

Elastic mode (the reference's ``elastic=True``, ``ReclaimNotice``,
``GrowNotice``, ``_resize``): a partial reclaim shrinks the job and
returned capacity grows it, each a drain save, a process group re-formed
over the new members (:class:`..parallel.distributed.Membership`: a
``torch.distributed`` world cannot change its ranks in place), the mesh,
step and init rebuilt for it, and a restore of the save: one continuous
run, whose window on fewer ranks than its baseline the ledger prices as
``degraded``. Rank 0's notice is broadcast with the drain flag, so every
rank resizes at the same step. Every rank joins the save; then the
reclaimed ranks leave the group and return (``reclaimed=True``), and the
survivors, with the joiners a grow started (each constructs a trainer
over the new group and calls :meth:`CheckpointingTrainer.init_or_resume`
and :meth:`CheckpointingTrainer.run` for the steps left), restore it.
Rank 0 of each generation writes the checkpoints and the ledger, so
every rank's trainer may hold the same ledger (one file): a shrink that
reclaims rank 0 hands both to the new rank 0, and the run stays one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.llama import LlamaConfig
from ..parallel.fsdp import (AdamWState, ClippedAdamW, TrainState, _tree_map,
                             full_leaf, full_shape, init_train_state,
                             make_train_step)
from ..parallel.distributed import Membership
from ..utils.device import DeviceLike, resolve_device
from ..utils.mesh import Mesh, make_mesh, param_specs, shard

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


@dataclasses.dataclass
class ReclaimNotice:
    """A spot or preemption reclaim of part of the job's devices:
    ``surviving_devices`` are the members the job keeps (empty: a total
    reclaim), ``deadline_s`` the grace before the others disappear. The
    platform delivers it as a node taint and a deadline annotation
    (the operator's ``chaos/faults.py`` ``RECLAIM_TAINT_KEY``); the
    ``reclaim_signal`` given to :meth:`CheckpointingTrainer.run` adapts
    that to the loop."""

    surviving_devices: Sequence[str]
    deadline_s: float = 120.0


@dataclasses.dataclass
class GrowNotice:
    """Returned capacity (the capacity arbiter ending a trade, or a spot
    pool refilled): ``devices`` is the full member list the job may now
    run on, a superset of the current one, in the new rank order, a
    current member first (it keeps rank 0's checkpoint writer and
    ledger). A notice is an order: hysteresis is the arbiter's job."""

    devices: Sequence[str]


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    steps_done: int
    preempted: bool          # True = exited for a drain, checkpoint saved
    last_checkpoint_step: int
    wall_time_s: float
    reshards: int = 0        # elastic mode: resizes done
    device_count: Optional[int] = None   # members at exit
    reclaimed: bool = False  # a shrink reclaimed this rank: it left


def state_dict(state: TrainState) -> dict:
    opt = state.opt_state
    return {"step": state.step, "params": state.params,
            "opt": {"count": opt.count, "mu": opt.mu, "nu": opt.nu}}


def from_state_dict(d: dict) -> TrainState:
    opt = d["opt"]
    return TrainState(params=d["params"],
                      opt_state=AdamWState(count=int(opt["count"]),
                                           mu=opt["mu"], nu=opt["nu"]),
                      step=int(d["step"]))


def _batch_tokens(batch) -> int:
    """Trained tokens in one [B, T + 1] batch: B * T targets."""
    shape = getattr(batch, "shape", None)
    if shape is not None and len(shape) == 2 and shape[1] > 1:
        return int(shape[0]) * (int(shape[1]) - 1)
    return 0


class CheckpointingTrainer:
    keep = 3                 # checkpoints kept on disk, newest first

    def __init__(self, cfg: LlamaConfig, checkpoint_dir: str,
                 optimizer: Optional[ClippedAdamW] = None,
                 checkpoint_interval: int = 100,
                 device: DeviceLike = "cuda",
                 step_fn: Optional[Callable] = None,
                 init_fn: Optional[Callable] = None,
                 ledger=None, metrics_sync_every: int = 10,
                 mesh: Optional[Mesh] = None, specs=None,
                 elastic: bool = False,
                 membership: Optional[Membership] = None,
                 mesh_factory: Optional[Callable] = None,
                 step_factory: Optional[Callable] = None,
                 init_factory: Optional[Callable] = None):
        """``step_fn(state, batch) -> (state, metrics)`` and
        ``init_fn(seed) -> TrainState`` default to the Llama pair of
        :mod:`..parallel.fsdp` on ``device`` (FSDP over ``mesh``'s fsdp
        axis when given); pass both to train another model family (MoE) or
        parallelism (sequence parallel) through the same checkpoint and
        drain machinery. A batch is an int array [B, T + 1], the global
        batch on every rank. ``specs`` is the spec tree of the state's
        parameters over ``mesh`` (the path's ``*_param_specs``; the
        moments share it); None keeps every leaf whole, except for the
        trainer's own FSDP pair, which takes the FSDP rule.

        ``ledger`` (a :class:`~..obs.goodput.GoodputLedger`, duck-typed)
        turns the run loop into a goodput recorder.
        ``metrics_sync_every`` bounds how often the loop blocks on the
        device: every that many steps and at checkpoint, drain and end
        boundaries, never per step. Only rank 0 writes to it.

        ``elastic=True`` turns a partial :class:`ReclaimNotice` into a
        shrink and a :class:`GrowNotice` into a grow. Over a process
        group, ``membership`` is the generation this rank joined; the
        trainer re-forms the group at each resize, then builds the mesh
        with ``mesh_factory(members)`` (default :func:`..utils.mesh.
        make_mesh`, pure FSDP over the new group). Without one (a single
        controller) every member survives and ``mesh_factory`` alone
        makes the mesh. The default step and init are rebuilt for the new
        mesh; a custom ``step_fn`` / ``init_fn`` needs
        ``step_factory(mesh)`` / ``init_factory(mesh)`` to rebuild it."""
        if elastic and step_fn is not None and step_factory is None:
            raise ValueError("elastic=True with a custom step_fn needs a "
                             "step_factory(mesh) to rebuild it on resize")
        if elastic and init_fn is not None and init_factory is None:
            raise ValueError("elastic=True with a custom init_fn needs an "
                             "init_factory(mesh) to rebuild it on resize")
        self.cfg = cfg
        self.dir = Path(checkpoint_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.checkpoint_interval = checkpoint_interval
        self.ledger = ledger
        self.metrics_sync_every = max(1, int(metrics_sync_every))
        self.mesh = mesh
        # how the state is sliced over the mesh; None keeps every leaf
        # whole (one rank, the sequence-parallel state)
        self._given_specs = specs
        self._default_pair = step_fn is None
        self._specs = self._pick_specs(mesh)
        self._join_group()
        self.elastic = bool(elastic)
        if self.elastic and membership is None and self._ctl is not None:
            raise ValueError("elastic=True over a process group needs its "
                             "membership (parallel/distributed.py)")
        self.membership = membership
        self._mesh_factory = mesh_factory or (lambda members: make_mesh())
        self._step_factory = step_factory
        self._init_factory = init_factory
        if membership is not None:
            self._device_count = len(membership.members)
        else:
            self._device_count = (dist.get_world_size()
                                  if dist.is_available()
                                  and dist.is_initialized() else 1)
        self._resume_seed = 0
        self._step_fn = step_fn or make_train_step(cfg, optimizer,
                                                   mesh=mesh)
        self._init_fn = init_fn or self._default_init(mesh)
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-writer")
        self._pending: Optional[Future] = None
        self._host = None            # host snapshot buffers, reused
        # the last finished save's split on the trainer's clock: its device->host
        # snapshot (from the copy's enqueue to its end, device work queued
        # before it included) and its file write
        self.last_fetch_s: Optional[float] = None
        self.last_write_s: Optional[float] = None

    def _pick_specs(self, mesh: Optional[Mesh]):
        if mesh is None:
            return None
        if self._given_specs is None and self._default_pair \
                and mesh.size("fsdp") > 1:
            return param_specs()
        return self._given_specs

    def _join_group(self) -> None:
        """Rank 0 writes; the control all-reduce stays on the host (the
        world group under gloo, a gloo group beside NCCL)."""
        multi = dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1
        self._writer_rank = not multi or dist.get_rank() == 0
        self._ctl = None
        if multi:
            self._ctl = (dist.group.WORLD if dist.get_backend() == "gloo"
                         else dist.new_group(backend="gloo"))

    def _default_init(self, mesh: Optional[Mesh]) -> Callable:
        return lambda seed: init_train_state(self.cfg, seed, self.optimizer,
                                             self.device, mesh, self._specs)

    @property
    def _book(self):
        """The ledger where this rank writes it (rank 0), else None."""
        return self.ledger if self._writer_rank else None

    @property
    def _now(self) -> Callable[[], float]:
        """The trainer's monotonic clock: the ledger's injected one, else
        the process's. The loop's windows and the checkpoint's
        fetch/write split read the same clock as the ledger's phases."""
        return (self.ledger.clock.now if self.ledger is not None
                else time.monotonic)

    # ------------------------------------------------------------ lifecycle

    def _steps(self):
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    @property
    def latest_step(self) -> Optional[int]:
        """The newest finished checkpoint (an in-flight one is not)."""
        steps = self._steps()
        return steps[-1] if steps else None

    def init_or_resume(self, seed: int = 0) -> TrainState:
        """Fresh init, or the latest checkpoint loaded onto the device
        (this trainer's own save in flight included: it is waited for)."""
        self.wait()
        self._resume_seed = seed
        latest = self._agreed_latest()
        if latest is None:
            logger.info("no checkpoint found, initializing from scratch")
            return self._init_fn(seed)
        logger.info("resuming from checkpoint step %d", latest)
        if self._book is not None:
            with self._book.phase("ckpt_restore"):
                return self._restore(latest)
        return self._restore(latest)

    def _agreed_latest(self) -> Optional[int]:
        """The newest finished checkpoint as rank 0, the writer, sees it,
        on every rank: another rank listing the directory itself could
        miss the write rank 0 is still finishing and resume from an older
        step, out of step with rank 0."""
        latest = self.latest_step
        if self._ctl is None:
            return latest
        t = torch.tensor([-1 if latest is None else latest])
        dist.broadcast(t, src=0, group=self._ctl)
        return None if int(t.item()) < 0 else int(t.item())

    def _restore(self, step: int) -> TrainState:
        path = self.dir / str(step) / STATE_FILE
        # mapped, not read: a rank pages in only the slices it keeps, so
        # ranks sharing a host do not each hold the whole state
        d = torch.load(path, map_location="cpu", mmap=True,
                       weights_only=True)
        tensors = {"params": d["params"], "mu": d["opt"]["mu"],
                   "nu": d["opt"]["nu"]}

        def keep(t, spec=None):
            # copy=True: no leaf stays backed by the file
            part = t if spec is None else shard(t, spec, self.mesh)
            return part.to(self.device, copy=True)

        if self._specs is None:
            held = _tree_map(keep, tensors)
        else:
            held = _tree_map(keep, tensors, {"params": self._specs,
                                             "mu": self._specs,
                                             "nu": self._specs})
        self._sync()
        return from_state_dict({"step": d["step"], "params": held["params"],
                                "opt": {"count": d["opt"]["count"],
                                        "mu": held["mu"],
                                        "nu": held["nu"]}})

    def save(self, state: TrainState, wait: bool = False) -> int:
        """Checkpoint ``state``: wait for the save in flight, snapshot the
        state into host buffers, and write it on the writer thread.
        ``wait=True`` returns once the checkpoint is on disk."""
        step = int(state.step)
        self.wait()
        d = state_dict(state)
        tensors = {"params": d["params"], "mu": d["opt"]["mu"],
                   "nu": d["opt"]["nu"]}
        specs = (None if self._specs is None else
                 {"params": self._specs, "mu": self._specs,
                  "nu": self._specs})
        if specs is None:
            specs = _tree_map(lambda t: None, tensors)
        if self._host is None and self._writer_rank:
            pinned = self.device.type == "cuda"
            self._host = _tree_map(
                lambda t, spec: torch.empty(
                    t.shape if spec is None else full_shape(t, spec,
                                                            self.mesh),
                    dtype=t.dtype, device="cpu", pin_memory=pinned),
                tensors, specs)

        def snapshot(src, spec, dst=None):
            # every rank joins the gather; rank 0 copies the whole leaf
            full = src if spec is None else full_leaf(src, spec, self.mesh)
            if dst is not None:
                dst.copy_(full, non_blocking=True)

        t0 = self._now()
        if not self._writer_rank:
            _tree_map(snapshot, tensors, specs)
            return step
        _tree_map(snapshot, tensors, specs, self._host)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        snapshot = {"step": step, "params": self._host["params"],
                    "opt": {"count": d["opt"]["count"],
                            "mu": self._host["mu"], "nu": self._host["nu"]}}
        self._pending = self._writer.submit(self._write, step, snapshot,
                                            ready, t0)
        if wait:
            self.wait()
        return step

    def _write(self, step: int, snapshot: dict, ready, t0: float) -> None:
        if ready is not None:
            self._sync(ready)
        now = self._now
        t1 = now()
        final = self.dir / str(step)
        tmp = self.dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(snapshot, tmp / STATE_FILE)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[:-self.keep]:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)
        self.last_fetch_s, self.last_write_s = t1 - t0, now() - t1

    def wait(self) -> None:
        """Block until the save in flight is on disk; re-raise its
        error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        """Wait for the save in flight and stop the writer thread."""
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)

    def _agreed(self, drain: bool, notice=None):
        """(whether any rank's ``drain`` is true, rank 0's ``notice``), on
        every rank: one all-reduce, then a broadcast only when rank 0 has
        a notice."""
        if self._ctl is None:
            return drain, notice
        t = torch.tensor([int(drain), int(notice is not None
                                          and self._writer_rank)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._ctl)
        drain, has_notice = bool(t[0]), bool(t[1])
        if not has_notice:
            return drain, None
        box = [notice]
        dist.broadcast_object_list(box, src=0, group=self._ctl)
        return drain, box[0]

    def _sync(self, event=None) -> None:
        """The one place the trainer waits for the device: the loop for
        all of its work, the checkpoint writer for the recorded ``event``
        its snapshot's copies must pass."""
        if event is not None:
            event.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save_phase(self, phase: str, state: TrainState,
                    wait: bool) -> int:
        """``save`` timed as a ledger phase; a synchronous save's record
        carries its ``fetch_s``/``write_s`` split."""
        book = self._book
        if book is None:
            return self.save(state, wait=wait)
        clock = book.clock
        t0, t0_wall = clock.now(), clock.wall()
        step = self.save(state, wait=wait)
        extra = ({"fetch_s": self.last_fetch_s, "write_s": self.last_write_s}
                 if wait else {})
        book.record_phase(phase, t0_wall, max(0.0, clock.now() - t0),
                          **extra)
        return step

    # ------------------------------------------------------------ run loop

    def run(self, state: TrainState, data: Iterator[Any], num_steps: int,
            drain_signal: Optional[Callable[[], bool]] = None,
            on_step: Optional[Callable[[int, dict], None]] = None,
            reclaim_signal: Optional[
                Callable[[], Optional[ReclaimNotice]]] = None,
            grow_signal: Optional[Callable[[], Optional[GrowNotice]]] = None
            ) -> TrainResult:
        """Train until ``num_steps`` more steps are done or a drain is
        signalled. Drain -> synchronous checkpoint -> return
        (``preempted=True``). Every ``checkpoint_interval`` steps (counted
        from the run's start or its last resize, as a joiner's run counts
        them) a checkpoint is dispatched asynchronously.

        ``reclaim_signal()`` returning a :class:`ReclaimNotice` is the spot
        and preemption path: a total reclaim, or any reclaim of an
        inelastic trainer, is a drain; an elastic trainer with survivors
        shrinks and resumes instead. ``grow_signal()`` returning a
        :class:`GrowNotice` over more members than the job has grows an
        elastic trainer (an inelastic one logs and ignores it). Before
        every step the drain is checked first, then the reclaim, then the
        grow; rank 0's signals decide, for every rank, and a drain on any
        rank wins over a notice at the same step. The open goodput window
        is booked before each save; the ledger prices each window on
        fewer members than the baseline (the count at the run's start,
        raised by any grow above it) as ``degraded``, closed or re-priced
        at the next resize.

        ``on_step(step, metrics)`` gets the host step counter and the
        step's metrics, device tensors still in flight: reading one waits
        for the device. The loop itself waits only at sync boundaries:
        every ``metrics_sync_every`` steps, at checkpoint boundaries,
        after the first step (its own ledger segment: compile or
        re-warmup badput) and at the end."""
        clock = self.ledger.clock if self.ledger is not None else None
        now = self._now
        t0 = now()
        start_step = int(state.step)
        if self._book is not None:
            self._book.run_started(start_step)
        last_ckpt = self.latest_step or start_step
        done = 0
        ckpt_from = 0            # the periodic saves count from here
        preempted = reclaimed = False
        reshards = 0
        baseline = self._device_count
        # the open degraded window: (start wall, baseline at open,
        # members now), or None at full capacity
        degraded = {"open": None}
        win_t0 = now()       # start of the current unsynced step window
        win_steps = win_tokens = 0

        def book_window():
            nonlocal win_steps, win_tokens
            if self._book is not None and win_steps > 0:
                self._sync()
                self._book.steps(start_step + done, win_steps,
                                 max(0.0, now() - win_t0), win_tokens)
            win_steps = win_tokens = 0

        def close_degraded():
            if degraded["open"] is not None and self._book is not None:
                s0, b0, a0 = degraded["open"]
                self._book.degraded(s0, max(0.0, clock.wall() - s0), b0, a0)
            degraded["open"] = None

        while done < num_steps:
            drain = drain_signal is not None and drain_signal()
            notice = None
            if self._writer_rank and not drain:
                if reclaim_signal is not None:
                    notice = reclaim_signal()
                if notice is None and grow_signal is not None:
                    notice = grow_signal()
            drain, notice = self._agreed(drain, notice)
            shrink = isinstance(notice, ReclaimNotice)
            if drain or (shrink and not (self.elastic
                                         and notice.surviving_devices)):
                logger.info("%s at step %d: checkpoint + exit",
                            "drain signalled" if drain else
                            "reclaim notice", start_step + done)
                book_window()
                last_ckpt = self._save_phase("drain_save", state, wait=True)
                preempted = True
                break
            if isinstance(notice, GrowNotice):
                if not self.elastic:
                    logger.info("grow notice ignored: trainer is not "
                                "elastic")
                    notice = None
                elif len(notice.devices) <= self._device_count:
                    notice = None
            if notice is not None:
                members = list(notice.surviving_devices if shrink
                               else notice.devices)
                book_window()
                close_degraded()
                state, last_ckpt, left = self._resize(
                    state, members, "shrink" if shrink else "grow")
                if left:
                    preempted = reclaimed = True
                    break
                reshards += 1
                if clock is not None and len(members) < baseline:
                    # a shrink, or a grow still short of the baseline:
                    # the loss is priced (again) from here
                    degraded["open"] = (clock.wall(), baseline,
                                        len(members))
                baseline = max(baseline, len(members))
                ckpt_from = done
                win_t0 = now()
                continue
            batch = torch.as_tensor(next(data), device=self.device)
            state, metrics = self._step_fn(state, batch)
            done += 1
            win_steps += 1
            win_tokens += _batch_tokens(batch)
            host_step = start_step + done
            at_ckpt = (done - ckpt_from) % self.checkpoint_interval == 0
            if (win_steps >= self.metrics_sync_every or at_ckpt
                    or done == num_steps or done == 1):
                self._sync()
                elapsed = max(0.0, now() - win_t0)
                if self._book is not None:
                    if done == win_steps == 1:
                        self._book.first_step(host_step, elapsed, win_tokens)
                    else:
                        self._book.steps(host_step, win_steps, elapsed,
                                         win_tokens)
                win_t0 = now()
                win_steps = win_tokens = 0
            if on_step is not None:
                on_step(host_step, metrics)
            if at_ckpt:
                last_ckpt = self._save_phase("ckpt_save", state, wait=False)
        close_degraded()
        if self._book is not None:
            self._book.run_ended(start_step + done, preempted)
        return TrainResult(state=state, steps_done=done, preempted=preempted,
                           last_checkpoint_step=last_ckpt,
                           wall_time_s=max(0.0, now() - t0),
                           reshards=reshards,
                           device_count=self._device_count,
                           reclaimed=reclaimed)

    def _resize(self, state: TrainState, members: List[str], kind: str):
        """An elastic resize, one path for both directions: a synchronous
        drain save that every rank joins, the group re-formed over
        ``members``, the mesh, step and init rebuilt for it, and the save
        restored onto the new mesh (booked as ``ckpt_restore``, like any
        resume). Returns (state, checkpoint step, whether this rank left
        the group)."""
        if (self.membership is not None and kind == "grow"
                and members[0] not in self.membership.members):
            raise ValueError(f"grow to {members}: the first member must be "
                             f"a current one (it keeps rank 0's writer)")
        ckpt_step = self._save_phase("drain_save", state, wait=True)
        if self._ctl is not None:
            # the writer's checkpoint is in place before any rank leaves
            # the group or reads it
            dist.barrier(group=self._ctl)
        if self.membership is not None:
            self.membership = self.membership.reform(members)
            if self.membership is None:
                logger.info("elastic %s: reclaimed at step %d, leaving",
                            kind, ckpt_step)
                self._writer_rank, self._ctl, self._host = False, None, None
                return state, ckpt_step, True
        mesh = self._mesh_factory(members)
        self._join_group()
        if not self._writer_rank:
            self._host = None        # the new writer allocates its own
        self.mesh = mesh
        self._specs = self._pick_specs(mesh)
        self._step_fn = (self._step_factory(mesh)
                         if self._step_factory is not None else
                         make_train_step(self.cfg, self.optimizer, mesh=mesh))
        self._init_fn = (self._init_factory(mesh)
                         if self._init_factory is not None else
                         self._default_init(mesh))
        restored = self.init_or_resume(self._resume_seed)
        self._device_count = len(members)
        logger.info("elastic %s: resumed at step %d on %d members", kind,
                    int(restored.step), len(members))
        return restored, ckpt_step, False
