"""Training CLI of the PyTorch port: a Llama model on one GPU, with
checkpoint, resume and a drain on SIGTERM.

Port of ``cmd/train.py:158-307`` for ``--parallel none``: TokenDataset ->
the single-device train step (flash attention kernels on the card) ->
CheckpointingTrainer. In a pod, kubelet's SIGTERM during a drain triggers
a synchronous checkpoint and a clean exit; the same command then resumes
from the latest checkpoint and continues the data stream where it left.

Example (on a machine with an NVIDIA GPU):
    python -m k8s_operator_libs_tpu_torch.train --data tokens.bin \
        --ckpt /ckpt/run1 --model small --steps 1000 --batch 8 --seq 512
"""

from __future__ import annotations

import argparse
import signal
from typing import Callable, Optional

from ..data.loader import TokenDataset
from ..models.llama import LlamaConfig
from ..parallel.fsdp import default_optimizer
from .harness import CheckpointingTrainer

MODELS = {"tiny": LlamaConfig.tiny, "small": LlamaConfig.small,
          "llama3_8b": LlamaConfig.llama3_8b}


def main(argv=None, drain_signal: Optional[Callable[[], bool]] = None
         ) -> int:
    """Run the CLI. ``drain_signal``, polled before every step beside
    SIGTERM, lets an embedding program drain the job at a chosen step."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, help="token file (TOKS format)")
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--model", default="tiny", choices=sorted(MODELS))
    p.add_argument("--parallel", default="none", choices=["none"],
                   help="one device; the multi-GPU modes are not ported")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-interval", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = MODELS[args.model](max_seq_len=args.seq)
    trainer = CheckpointingTrainer(cfg, args.ckpt,
                                   optimizer=default_optimizer(args.lr),
                                   checkpoint_interval=args.ckpt_interval,
                                   device=args.device)
    state = trainer.init_or_resume(0)
    start_step = int(state.step)

    # drain coordination: SIGTERM (kubelet eviction) -> checkpoint + exit
    draining = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: draining.update(flag=True))
    last = {"loss": None}

    def drained() -> bool:
        return draining["flag"] or (drain_signal is not None
                                    and drain_signal())

    def on_step(step, metrics):
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
        signal.signal(signal.SIGTERM, previous)
        ds.close()
        trainer.close()
    if result.preempted:
        print(f"preempted at step {int(result.state.step)}; checkpoint "
              f"{result.last_checkpoint_step} saved — exiting for upgrade")
        return 0
    loss = "" if last["loss"] is None else (
        f" (step {int(result.state.step)} loss {float(last['loss']):.7f})")
    print(f"done: {result.steps_done} steps in {result.wall_time_s:.1f}s"
          f"{loss}")
    return 0
