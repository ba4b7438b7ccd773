"""Training CLI of the PyTorch port: a Llama or MoE model on one GPU, with
checkpoint, resume, a drain on SIGTERM, a goodput ledger and a profiler.

Port of ``cmd/train.py`` for ``--parallel none``: TokenDataset -> the
single-device train step (flash attention kernels on the card) ->
CheckpointingTrainer. In a pod, kubelet's SIGTERM during a drain triggers
a synchronous checkpoint and a clean exit; the same command then resumes
from the latest checkpoint and continues the data stream where it left.
Periodic checkpoints are written asynchronously. The goodput ledger
(``--goodput-log``, by default ``goodput.jsonl`` beside the checkpoints,
continued by a resumed job) books step windows and badput phases; at the
end the CLI prints its summary and, with ``--metrics-textfile``, writes
the ``tpu_workload`` exposition.

Example (on a machine with an NVIDIA GPU):
    python -m k8s_operator_libs_tpu_torch.train --data tokens.bin \
        --ckpt /ckpt/run1 --model moe_tiny --steps 1000 --batch 8 \
        --seq 512 --profile /tmp/trace
"""

from __future__ import annotations

import argparse
import signal
from typing import Callable, Optional

from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)

from ..data.loader import TokenDataset
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig
from ..models.moe import init_params as moe_init
from ..obs.goodput import (GoodputLedger, publish_summary, read_ledger,
                           summarize)
from ..obs.metrics import MetricsHub
from ..parallel.expert import moe_reference_loss
from ..parallel.fsdp import (TrainState, default_optimizer,
                             make_train_step_from_loss)
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
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--model", default="tiny",
                   choices=sorted(MODELS) + ["moe_tiny"])
    p.add_argument("--parallel", default="none", choices=["none"],
                   help="one device; the multi-GPU modes are not ported")
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

    optimizer = default_optimizer(args.lr)
    step_fn = init_fn = None
    if args.model == "moe_tiny":
        cfg = MoEConfig.tiny(max_seq_len=args.seq)
        step_fn, init_fn = _moe_pair(cfg, optimizer, args.device)
    else:
        cfg = MODELS[args.model](max_seq_len=args.seq)
    ledger = hub = None
    if args.goodput_log != "off":
        hub = MetricsHub()
        ledger = (GoodputLedger.for_checkpoint_dir(args.ckpt, metrics=hub)
                  if args.goodput_log == "auto"
                  else GoodputLedger(args.goodput_log, metrics=hub))
    trainer = CheckpointingTrainer(cfg, args.ckpt, optimizer=optimizer,
                                   checkpoint_interval=args.ckpt_interval,
                                   device=args.device, step_fn=step_fn,
                                   init_fn=init_fn, ledger=ledger,
                                   metrics_sync_every=args.goodput_sync_every)
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
            print(f"step {step} loss {float(metrics['loss']):.4f}",
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
                print(f"profiler trace written to {args.profile}")
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
        print(f"preempted at step {int(result.state.step)}; checkpoint "
              f"{result.last_checkpoint_step} saved — exiting for upgrade")
        return 0
    loss = "" if last["loss"] is None else (
        f" (step {int(result.state.step)} loss {float(last['loss']):.7f})")
    print(f"done: {result.steps_done} steps in {result.wall_time_s:.1f}s"
          f"{loss}")
    return 0
