"""Training CLI of the PyTorch port: a Llama or MoE model on one GPU or
over the ranks of a process group, with checkpoint, resume, a drain on
SIGTERM, a goodput ledger and a profiler.

Port of ``cmd/train.py``: TokenDataset -> the train step (flash
attention kernels on the card; ``build_parallel`` wires ``--model`` x
``--parallel none|fsdp|sp|pp|ep|3d`` and ``--moe-dispatch`` to a mesh,
step, init and spec tree, with the reference's checks and messages,
:24-157) -> CheckpointingTrainer. ``--parallel`` defaults to fsdp, as
the reference's does; one rank trains on one device whatever it says. In
a pod, kubelet's SIGTERM during a drain triggers a synchronous
checkpoint and a clean exit; the same command then resumes from the
latest checkpoint and continues the data stream where it left. Periodic
checkpoints are written asynchronously.
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

Examples (on a machine with NVIDIA GPUs):
    python -m k8s_operator_libs_tpu_torch.train --data tokens.bin \
        --ckpt /ckpt/run1 --model moe_tiny --parallel none --steps 1000 \
        --batch 8 --seq 512 --profile /tmp/trace
    torchrun --nproc-per-node 4 -m k8s_operator_libs_tpu_torch.train \
        --data tokens.bin --ckpt /ckpt/run2 --model small --parallel 3d
"""

from __future__ import annotations

import argparse
import math
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
from ..parallel.composed import (composed_param_specs, init_composed_state,
                                 init_moe_composed_state,
                                 make_composed_train_step,
                                 make_moe_composed_train_step,
                                 moe_composed_param_specs)
from ..parallel.distributed import default_backend, maybe_initialize_from_env
from ..parallel.expert import (ep_param_specs, init_ep_state,
                               make_ep_train_step, moe_reference_loss)
from ..parallel.fsdp import (TrainState, default_optimizer, init_train_state,
                             make_train_step_from_loss)
from ..parallel.long_context import make_sp_train_step
from ..parallel.mesh import make_mesh
from ..parallel.pipeline import (init_pp_state, make_pp_train_step,
                                 pp_param_specs)
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


def _moe_parallel(cfg, args, optimizer, device, n: int, say):
    """:func:`build_parallel` for ``--model moe_tiny`` (the reference's
    :43-95)."""
    if args.parallel == "ep" and n > 1:
        t = math.gcd(n, cfg.n_experts)
        if t < 2:
            raise SystemExit(f"expert parallelism needs gcd(devices={n}, "
                             f"experts={cfg.n_experts}) ≥ 2")
        if t < n:
            say(f"ep: using {t} of {n} devices "
                f"(gcd with {cfg.n_experts} experts)", flush=True)
        if args.moe_dispatch == "a2a" and args.batch % t:
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"the {t}-way mesh for a2a dispatch")
        # the ranks past t repeat the first t's work on the same batch
        mesh = make_mesh(tensor=t, data=n // t, fsdp=1)
        return (mesh, make_ep_train_step(cfg, mesh, optimizer,
                                         dispatch=args.moe_dispatch),
                lambda seed: init_ep_state(cfg, seed, mesh, optimizer,
                                           device), ep_param_specs())
    if args.parallel == "3d" and n > 1:
        if n % 4:
            raise SystemExit(f"--parallel 3d needs a multiple of 4 "
                             f"devices (stage=2 x tensor=2), have {n}")
        if cfg.n_layers % 2 or cfg.n_experts % 2:
            raise SystemExit("moe 3d needs even layers/experts")
        dp, micro = n // 4, 2
        if args.batch % (dp * micro):
            raise SystemExit(f"--batch {args.batch} must be divisible "
                             f"by data({dp}) x microbatches({micro})")
        mesh = make_mesh(stage=2, data=dp, fsdp=1, tensor=2)
        return (mesh, make_moe_composed_train_step(cfg, mesh, micro,
                                                   optimizer),
                lambda seed: init_moe_composed_state(cfg, seed, mesh,
                                                     optimizer, device),
                moe_composed_param_specs())
    if args.parallel not in ("none", "ep", "3d"):
        raise SystemExit(f"--model moe_tiny supports --parallel "
                         f"none|ep|3d, not {args.parallel}")
    step_fn, init_fn = _moe_pair(cfg, optimizer, device)
    return None, step_fn, init_fn, None


def build_parallel(cfg, args, optimizer, device, n: int, say=print):
    """(mesh, step_fn, init_fn, specs) for ``--model`` x ``--parallel``
    over the process group's ``n`` ranks, ``specs`` the state's spec tree
    over the mesh; None for the trainer's defaults (FSDP, one device).
    One rank trains on one device whatever ``--parallel`` says, as the
    reference does. Where the reference uses the first s of its devices
    (``pp`` and ``ep`` take a gcd with the layers or experts), the ranks
    past s repeat their work on the same batch (the mesh's data axis)."""
    if args.moe_dispatch != "dense" and not (
            args.model == "moe_tiny" and args.parallel == "ep" and n > 1):
        raise SystemExit("--moe-dispatch a2a requires --model moe_tiny "
                         "--parallel ep on >1 device")
    if args.model == "moe_tiny":
        return _moe_parallel(cfg, args, optimizer, device, n, say)
    if args.parallel == "fsdp" and n > 1:
        if args.batch % n:
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"the {n}-way data·fsdp mesh")
        return make_mesh(), None, None, None  # the trainer's FSDP defaults
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
                lambda seed: init_train_state(cfg, seed, optimizer, device),
                None)
    if args.parallel == "pp" and n > 1:
        s = math.gcd(n, cfg.n_layers)
        if s < 2:
            raise SystemExit(f"pipeline needs gcd(devices={n}, "
                             f"layers={cfg.n_layers}) ≥ 2")
        if args.batch % 2:
            raise SystemExit("--batch must be divisible by 2 for pp")
        micro = 4 if args.batch % 4 == 0 else 2
        mesh = make_mesh(stage=s, data=n // s, fsdp=1)
        return (mesh, make_pp_train_step(cfg, mesh, micro, optimizer),
                lambda seed: init_pp_state(cfg, seed, mesh, optimizer,
                                           device), pp_param_specs())
    if args.parallel == "3d" and n > 1:
        if n % 4:
            raise SystemExit(f"--parallel 3d needs a multiple of 4 devices "
                             f"(stage=2 x tensor=2), have {n}")
        if cfg.n_heads % 2 or cfg.n_kv_heads % 2 or cfg.n_layers % 2:
            raise SystemExit("--parallel 3d needs even heads/kv-heads/layers")
        dp, micro = n // 4, 2
        if args.batch % (dp * micro):
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"data({dp}) x microbatches({micro})")
        mesh = make_mesh(stage=2, data=dp, fsdp=1, tensor=2)
        return (mesh, make_composed_train_step(cfg, mesh, micro, optimizer),
                lambda seed: init_composed_state(cfg, seed, mesh, optimizer,
                                                 device),
                composed_param_specs())
    if args.parallel == "ep":
        raise SystemExit("--parallel ep requires --model moe_tiny")
    return None, None, None, None


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
    p.add_argument("--parallel", default="fsdp",
                   choices=["none", "fsdp", "sp", "pp", "ep", "3d"],
                   help="over the process group's ranks: fsdp (ZeRO-3), sp "
                        "(sequence parallel), pp (GPipe over the layers), "
                        "ep (experts, moe_tiny), 3d (stage 2 x data x "
                        "tensor 2); one rank trains on one device whatever "
                        "it says")
    p.add_argument("--sp-attn", default="ring", choices=["ring", "ulysses"],
                   help="sequence-parallel attention: ring (K/V chunks "
                        "travel the ranks, any degree) or ulysses (head<->"
                        "sequence all-to-all; ranks must divide the heads)")
    p.add_argument("--moe-dispatch", default="dense",
                   choices=["dense", "a2a"],
                   help="EP dispatch: dense (replicated tokens) or "
                        "capacity-based all-to-all (needs --parallel ep "
                        "over more than one rank)")
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
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    mesh, step_fn, init_fn, specs = build_parallel(cfg, args, optimizer,
                                                   args.device, n, say)
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
                                   mesh=mesh, specs=specs)
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
