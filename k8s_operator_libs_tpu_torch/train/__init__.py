"""Training on one GPU: the checkpointing trainer (:mod:`.harness`) and
the CLI (:mod:`.cli`, run as ``python -m k8s_operator_libs_tpu_torch.train``).
"""

from .cli import main

__all__ = ["main"]
