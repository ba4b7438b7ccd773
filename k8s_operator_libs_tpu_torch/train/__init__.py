"""Training: the checkpointing trainer (:mod:`.harness`, elastic over a
re-formed process group), the checkpoint uploader (:mod:`.uploader`) and
the CLI (:mod:`.cli`, run as ``python -m k8s_operator_libs_tpu_torch.train``).
"""

from .cli import main
from .uploader import CheckpointUploader, mirror_once

__all__ = ["CheckpointUploader", "main", "mirror_once"]
