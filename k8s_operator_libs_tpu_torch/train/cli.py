"""Training CLI of the PyTorch port: a Llama or MoE model on one GPU or
over the ranks of a process group, with checkpoint, resume, a drain on
SIGTERM, a goodput ledger and a profiler.

Port of ``cmd/train.py`` for ``--parallel none|fsdp|sp``: TokenDataset ->
the train step (flash attention kernels on the card; ``build_parallel``
wires ``--parallel`` to a mesh, step and init, as the reference's
:24-157 does) -> CheckpointingTrainer. In a pod, kubelet's SIGTERM during
a drain triggers a synchronous checkpoint and a clean exit; the same
command then resumes from the latest checkpoint and continues the data
stream where it left. Periodic checkpoints are written asynchronously.
The goodput ledger (``--goodput-log``, by default ``goodput.jsonl`` beside
the checkpoints, continued by a resumed job) books step windows and
badput phases; at the end the CLI prints its summary and, with
``--metrics-textfile``, writes the ``tpu_workload`` exposition.

Ranks. Under the operator each pod is one rank: the scheduler's env
(``parallel/distributed.py``) gives the process group. On one host,
``torchrun --nproc-per-node N -m k8s_operator_libs_tpu_torch.train ...``
starts N ranks (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` in the env). A
program that already joined a process group calls :func:`main` in each
rank. The backend follows from the ranks: NCCL on GPUs, gloo on the CPU
and where a host starts more ranks than it has GPUs (NCCL refuses two
ranks on one device), the collectives then going through host memory.
Only rank 0 prints and writes the ledger. Rank 0 writes the checkpoints
and every rank reads them on resume, so across hosts ``--ckpt`` must be
storage they share.

Example (on a machine with an NVIDIA GPU):
    python -m k8s_operator_libs_tpu_torch.train --data tokens.bin \
        --ckpt /ckpt/run1 --model moe_tiny --steps 1000 --batch 8 \
        --seq 512 --profile /tmp/trace
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)

from ..data.loader import TokenDataset
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig
from ..models.moe import init_params as moe_init
from ..obs.goodput import (GoodputLedger, publish_summary, read_ledger,
                           summarize)
from ..obs.metrics import MetricsHub
from ..parallel.distributed import default_backend, maybe_initialize_from_env
from ..parallel.expert import moe_reference_loss
from ..parallel.fsdp import (TrainState, default_optimizer, init_train_state,
                             make_train_step_from_loss)
from ..parallel.long_context import make_sp_train_step
from ..parallel.mesh import make_mesh
from .harness import CheckpointingTrainer

MODELS = {"tiny": LlamaConfig.tiny, "small": LlamaConfig.small,
          "llama3_8b": LlamaConfig.llama3_8b}


def _moe_pair(cfg, optimizer, device):
    """(step_fn, init_fn) of the MoE family: dense dispatch on one
    device."""
    def init_fn(seed):
        params = moe_init(cfg, seed=seed, device=device)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0)

    return make_train_step_from_loss(moe_reference_loss(cfg),
                                     optimizer), init_fn


def build_parallel(cfg, args, optimizer, device, n: int):
    """(mesh, step_fn, init_fn) for ``--parallel`` over the process
    group's ``n`` ranks; None for the trainer's defaults. One rank trains
    on one device whatever ``--parallel`` says, as the reference does."""
    if args.model == "moe_tiny":
        if args.parallel != "none" and n > 1:
            raise SystemExit(f"--model moe_tiny supports --parallel none "
                             f"only (expert parallelism is not ported), "
                             f"not {args.parallel} on {n} ranks")
        step_fn, init_fn = _moe_pair(cfg, optimizer, device)
        return None, step_fn, init_fn
    if args.parallel == "fsdp" and n > 1:
        if args.batch % n:
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"the {n}-way data·fsdp mesh")
        return make_mesh(), None, None      # the trainer's FSDP defaults
    if args.parallel == "sp" and n > 1:
        if args.seq % n:
            raise SystemExit(f"--seq {args.seq} must be divisible by the "
                             f"{n}-way seq mesh")
        if args.sp_attn == "ulysses" and cfg.n_heads % n:
            raise SystemExit(f"--sp-attn ulysses needs head count "
                             f"{cfg.n_heads} divisible by {n} devices "
                             "(use ring, which has no head limit)")
        mesh = make_mesh(seq=n, fsdp=1)
        return (mesh,
                make_sp_train_step(cfg, mesh, optimizer,
                                   attn_impl=args.sp_attn),
                lambda seed: init_train_state(cfg, seed, optimizer, device))
    return None, None, None


def _join_process_group(device: str) -> bool:
    """Join the operator's or torchrun's process group when the env
    names one and none is joined yet, over the backend that ranks on
    ``device`` need (:func:`..parallel.distributed.default_backend`);
    True when this call joined it."""
    if dist.is_initialized():
        return False
    backend = default_backend(device)
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
    if maybe_initialize_from_env(backend=backend):
        return True
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def _start_profiler(directory: str, cuda: bool):
    """A started ``torch.profiler`` whose trace goes to ``directory`` (one
    ``*.pt.trace.json`` per capture, for TensorBoard or Perfetto) when it
    stops."""
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(directory))
    prof.start()
    return prof


def main(argv=None, drain_signal: Optional[Callable[[], bool]] = None
         ) -> int:
    """Run the CLI. ``drain_signal``, polled before every step beside
    SIGTERM, lets an embedding program drain the job at a chosen step."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, help="token file (TOKS format)")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory (shared storage when the "
                        "ranks span hosts: rank 0 writes, every rank "
                        "reads)")
    p.add_argument("--model", default="tiny",
                   choices=sorted(MODELS) + ["moe_tiny"])
    p.add_argument("--parallel", default="none",
                   choices=["none", "fsdp", "sp"],
                   help="over the process group's ranks: fsdp (ZeRO-3) or "
                        "sp (sequence parallel); one rank trains on one "
                        "device either way")
    p.add_argument("--sp-attn", default="ring", choices=["ring", "ulysses"],
                   help="sequence-parallel attention: ring (K/V chunks "
                        "travel the ranks, any degree) or ulysses (head<->"
                        "sequence all-to-all; ranks must divide the heads)")
    p.add_argument("--moe-dispatch", default="dense",
                   choices=["dense", "a2a"],
                   help="MoE dispatch; a2a needs expert parallelism over "
                        "more than one device")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-interval", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the steps after "
                        "the first (which builds the kernels) to DIR")
    p.add_argument("--goodput-log", default="auto", metavar="PATH",
                   help="goodput-ledger JSONL path ('auto' = goodput.jsonl "
                        "next to the checkpoints, so a resumed job "
                        "continues it; 'off' disables)")
    p.add_argument("--goodput-sync-every", type=int, default=10,
                   help="steps between telemetry syncs with the device "
                        "(the ledger never blocks per step)")
    p.add_argument("--metrics-textfile", default=None, metavar="PATH",
                   help="write the job's tpu_workload exposition (step and "
                        "badput families plus the goodput-summary gauges) "
                        "to PATH at exit")
    args = p.parse_args(argv)
    if args.moe_dispatch != "dense":
        raise SystemExit("--moe-dispatch a2a requires --model moe_tiny "
                         "--parallel ep on >1 device")

    joined = _join_process_group(args.device)
    try:
        return _train(args, drain_signal)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, drain_signal) -> int:
    optimizer = default_optimizer(args.lr)
    if args.model == "moe_tiny":
        cfg = MoEConfig.tiny(max_seq_len=args.seq)
    else:
        cfg = MODELS[args.model](max_seq_len=args.seq)
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh, step_fn, init_fn = build_parallel(cfg, args, optimizer,
                                            args.device, n)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    ledger = hub = None
    if args.goodput_log != "off" and main_rank:
        hub = MetricsHub()
        ledger = (GoodputLedger.for_checkpoint_dir(args.ckpt, metrics=hub)
                  if args.goodput_log == "auto"
                  else GoodputLedger(args.goodput_log, metrics=hub))
    trainer = CheckpointingTrainer(cfg, args.ckpt, optimizer=optimizer,
                                   checkpoint_interval=args.ckpt_interval,
                                   device=args.device, step_fn=step_fn,
                                   init_fn=init_fn, ledger=ledger,
                                   metrics_sync_every=args.goodput_sync_every,
                                   mesh=mesh)
    state = trainer.init_or_resume(0)
    start_step = int(state.step)

    # drain coordination: SIGTERM (kubelet eviction) -> checkpoint + exit
    draining = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: draining.update(flag=True))
    last = {"loss": None}
    profiler = {"prof": None}

    def drained() -> bool:
        return draining["flag"] or (drain_signal is not None
                                    and drain_signal())

    def on_step(step, metrics):
        if args.profile and profiler["prof"] is None and step > start_step:
            # the first step (kernel build) is done; trace the steady state
            profiler["prof"] = _start_profiler(
                args.profile, trainer.device.type == "cuda")
        last["loss"] = metrics["loss"]
        if step % 10 == 0:
            say(f"step {step} loss {float(metrics['loss']):.4f}",
                flush=True)

    ds = TokenDataset(args.data)
    try:
        # start_step: a resumed job continues the exact data stream at its
        # restored step (counter-based sampling)
        result = trainer.run(state, ds.batches(args.batch, args.seq + 1,
                                               start_step=start_step),
                             num_steps=args.steps - start_step,
                             drain_signal=drained, on_step=on_step)
    finally:
        # flush the trace even when a step raises: a crash is when the
        # profile is wanted, and a profiler left running breaks the next
        try:
            if profiler["prof"] is not None:
                profiler["prof"].stop()
                say(f"profiler trace written to {args.profile}")
        finally:
            signal.signal(signal.SIGTERM, previous)
            ds.close()
            trainer.close()
            if ledger is not None:
                ledger.close()
    if ledger is not None:
        s = summarize(read_ledger(ledger.path))
        frac = s["goodput_fraction"]
        print(f"goodput: {s['goodput_s']:.1f}s over {s['steps']} steps "
              f"({frac:.1%} of accounted time)" if frac is not None else
              f"goodput ledger at {ledger.path}")
        publish_summary(s, hub)
        if args.metrics_textfile:
            with open(args.metrics_textfile, "w", encoding="utf-8") as fh:
                fh.write(hub.render(prefix="tpu_workload"))
    if result.preempted:
        say(f"preempted at step {int(result.state.step)}; checkpoint "
            f"{result.last_checkpoint_step} saved — exiting for upgrade")
        return 0
    loss = "" if last["loss"] is None else (
        f" (step {int(result.state.step)} loss {float(last['loss']):.7f})")
    say(f"done: {result.steps_done} steps in {result.wall_time_s:.1f}s"
          f"{loss}")
    return 0
