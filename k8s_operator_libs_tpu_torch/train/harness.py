"""Checkpoint, resume and drain-coordinated exit for the training loop.

Port of ``k8s_operator_libs_tpu/train/harness.py`` (``CheckpointingTrainer``
:138, ``init_or_resume`` :221, ``save`` :241, ``run`` :258) on one device.
The contract with the operator is the reference's: when the job's node is
drained, ``drain_signal`` turns true (SIGTERM in a pod, see
``cli.py``), the trainer writes a checkpoint synchronously and returns
with ``preempted=True``; the rescheduled job restores the latest
checkpoint and continues the same data stream.

A checkpoint is one directory per step, ``<checkpoint_dir>/<step>/``,
holding ``torch.save`` of the whole state (parameters, both optimizer
moments, the optimizer count and the step). It is written into a
temporary directory and moved into place with ``os.replace``, so a
reader never sees half of one. Saves are synchronous: the reference's
asynchronous orbax save, its goodput ledger, elastic resizing
(``ReclaimNotice``/``GrowNotice``) and the compilation cache wait for
later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from ..models.llama import LlamaConfig
from ..parallel.fsdp import (AdamWState, ClippedAdamW, TrainState,
                             init_train_state, make_train_step)
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


class CheckpointingTrainer:
    keep = 3                 # checkpoints kept on disk, newest first

    def __init__(self, cfg: LlamaConfig, checkpoint_dir: str,
                 optimizer: Optional[ClippedAdamW] = None,
                 checkpoint_interval: int = 100,
                 device: DeviceLike = "cuda"):
        """The Llama train step and state of :mod:`..parallel.fsdp` on
        ``device``; a batch is an int array [B, T + 1]."""
        self.cfg = cfg
        self.dir = Path(checkpoint_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.checkpoint_interval = checkpoint_interval
        self._step_fn = make_train_step(cfg, optimizer)

    # ------------------------------------------------------------ lifecycle

    def _steps(self):
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def init_or_resume(self, seed: int = 0) -> TrainState:
        """Fresh init, or the latest checkpoint loaded onto the device."""
        latest = self.latest_step
        if latest is None:
            logger.info("no checkpoint found, initializing from scratch")
            return init_train_state(self.cfg, seed, self.optimizer,
                                    self.device)
        logger.info("resuming from checkpoint step %d", latest)
        d = torch.load(self.dir / str(latest) / STATE_FILE,
                       map_location=self.device, weights_only=True)
        return from_state_dict(d)

    def save(self, state: TrainState) -> int:
        """Write the state's checkpoint (synchronously) and keep the
        ``keep`` newest."""
        step = int(state.step)
        final = self.dir / str(step)
        tmp = self.dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state_dict(state), tmp / STATE_FILE)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[:-self.keep]:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)
        return step

    def close(self) -> None:
        """Nothing is in flight: every save is synchronous."""

    # ------------------------------------------------------------ run loop

    def run(self, state: TrainState, data: Iterator[Any], num_steps: int,
            drain_signal: Optional[Callable[[], bool]] = None,
            on_step: Optional[Callable[[int, dict], None]] = None
            ) -> TrainResult:
        """Train until ``num_steps`` more steps are done or a drain is
        signalled. Drain -> synchronous checkpoint -> return
        (``preempted=True``). A checkpoint is written every
        ``checkpoint_interval`` steps. ``on_step(step, metrics)`` gets the
        host step counter and the step's metrics (device tensors: reading
        one waits for the device)."""
        t0 = time.monotonic()
        start_step = int(state.step)
        last_ckpt = self.latest_step or start_step
        done = 0
        preempted = False
        while done < num_steps:
            if drain_signal is not None and drain_signal():
                logger.info("drain signalled at step %d: checkpoint + exit",
                            start_step + done)
                last_ckpt = self.save(state)
                preempted = True
                break
            batch = torch.as_tensor(next(data), device=self.device)
            state, metrics = self._step_fn(state, batch)
            done += 1
            if on_step is not None:
                on_step(start_step + done, metrics)
            if done % self.checkpoint_interval == 0:
                last_ckpt = self.save(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return TrainResult(state=state, steps_done=done, preempted=preempted,
                           last_checkpoint_step=last_ckpt,
                           wall_time_s=time.monotonic() - t0)
