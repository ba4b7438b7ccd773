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
at checkpoint, drain and end boundaries. The reference's elastic resize
(``ReclaimNotice``/``GrowNotice``) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from ..models.llama import LlamaConfig
from ..parallel.fsdp import (AdamWState, ClippedAdamW, TrainState, _tree_map,
                             full_leaf, full_shape, init_train_state,
                             make_train_step)
from ..parallel.mesh import Mesh, param_specs, shard
from ..utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    steps_done: int
    preempted: bool          # True = exited for a drain, checkpoint saved
    last_checkpoint_step: int
    wall_time_s: float


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
                 mesh: Optional[Mesh] = None, specs=None):
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
        boundaries, never per step."""
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
        if specs is None and step_fn is None and mesh is not None \
                and mesh.size("fsdp") > 1:
            specs = param_specs()
        self._specs = specs if mesh is not None else None
        multi = dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1
        self._writer_rank = not multi or dist.get_rank() == 0
        # the drain flag's all-reduce stays on the host
        self._ctl = None
        if multi:
            self._ctl = (dist.group.WORLD if dist.get_backend() == "gloo"
                         else dist.new_group(backend="gloo"))
        self._step_fn = step_fn or make_train_step(cfg, optimizer,
                                                   mesh=mesh)
        self._init_fn = init_fn or (
            lambda seed: init_train_state(self.cfg, seed, self.optimizer,
                                          self.device, mesh, self._specs))
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-writer")
        self._pending: Optional[Future] = None
        self._host = None            # host snapshot buffers, reused
        # the last finished save's split, host seconds: its device->host
        # snapshot (from the copy's enqueue to its end, device work queued
        # before it included) and its file write
        self.last_fetch_s: Optional[float] = None
        self.last_write_s: Optional[float] = None

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
        latest = self._agreed_latest()
        if latest is None:
            logger.info("no checkpoint found, initializing from scratch")
            return self._init_fn(seed)
        logger.info("resuming from checkpoint step %d", latest)
        if self.ledger is not None:
            with self.ledger.phase("ckpt_restore"):
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

        t0 = time.monotonic()
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
            ready.synchronize()
        t1 = time.monotonic()
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
        self.last_fetch_s, self.last_write_s = t1 - t0, time.monotonic() - t1

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

    def _agreed(self, flag: bool) -> bool:
        """True on every rank when any rank's ``flag`` is."""
        if self._ctl is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._ctl)
        return bool(t.item())

    def _sync(self) -> None:
        """The one place the loop waits for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save_phase(self, phase: str, state: TrainState,
                    wait: bool) -> int:
        """``save`` timed as a ledger phase; a synchronous save's record
        carries its ``fetch_s``/``write_s`` split."""
        if self.ledger is None:
            return self.save(state, wait=wait)
        clock = self.ledger.clock
        t0, t0_wall = clock.now(), clock.wall()
        step = self.save(state, wait=wait)
        extra = ({"fetch_s": self.last_fetch_s, "write_s": self.last_write_s}
                 if wait else {})
        self.ledger.record_phase(phase, t0_wall,
                                 max(0.0, clock.now() - t0), **extra)
        return step

    # ------------------------------------------------------------ run loop

    def run(self, state: TrainState, data: Iterator[Any], num_steps: int,
            drain_signal: Optional[Callable[[], bool]] = None,
            on_step: Optional[Callable[[int, dict], None]] = None
            ) -> TrainResult:
        """Train until ``num_steps`` more steps are done or a drain is
        signalled. Drain -> synchronous checkpoint -> return
        (``preempted=True``). Every ``checkpoint_interval`` steps a
        checkpoint is dispatched asynchronously.

        ``on_step(step, metrics)`` gets the host step counter and the
        step's metrics, device tensors still in flight: reading one waits
        for the device. The loop itself waits only at sync boundaries:
        every ``metrics_sync_every`` steps, at checkpoint boundaries, after the first step (its own ledger
        segment: compile or re-warmup badput) and at the end. A drain
        books the steps since the last boundary before its save."""
        ledger = self.ledger
        now = ledger.clock.now if ledger is not None else time.monotonic
        t0 = now()
        start_step = int(state.step)
        if ledger is not None:
            ledger.run_started(start_step)
        last_ckpt = self.latest_step or start_step
        done = 0
        preempted = False
        win_t0 = now()       # start of the current unsynced step window
        win_steps = win_tokens = 0
        while done < num_steps:
            if self._agreed(drain_signal is not None and drain_signal()):
                logger.info("drain signalled at step %d: checkpoint + exit",
                            start_step + done)
                if ledger is not None and win_steps > 0:
                    self._sync()
                    ledger.steps(start_step + done, win_steps,
                                 max(0.0, now() - win_t0), win_tokens)
                    win_steps = win_tokens = 0
                last_ckpt = self._save_phase("drain_save", state, wait=True)
                preempted = True
                break
            batch = torch.as_tensor(next(data), device=self.device)
            state, metrics = self._step_fn(state, batch)
            done += 1
            win_steps += 1
            win_tokens += _batch_tokens(batch)
            host_step = start_step + done
            at_ckpt = done % self.checkpoint_interval == 0
            if (win_steps >= self.metrics_sync_every or at_ckpt or done == num_steps
                    or done == 1):
                self._sync()
                elapsed = max(0.0, now() - win_t0)
                if ledger is not None:
                    if done == win_steps == 1:
                        ledger.first_step(host_step, elapsed, win_tokens)
                    else:
                        ledger.steps(host_step, win_steps, elapsed,
                                     win_tokens)
                win_t0 = now()
                win_steps = win_tokens = 0
            if on_step is not None:
                on_step(host_step, metrics)
            if at_ckpt:
                last_ckpt = self._save_phase("ckpt_save", state, wait=False)
        if ledger is not None:
            ledger.run_ended(start_step + done, preempted)
        return TrainResult(state=state, steps_done=done, preempted=preempted,
                           last_checkpoint_step=last_ckpt,
                           wall_time_s=max(0.0, now() - t0))
