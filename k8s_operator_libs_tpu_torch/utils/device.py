"""Device selection for the port's entry points.

Entry points default to ``"cuda"``. A missing GPU is an error, never a
silent fall back to the CPU: only an explicit ``device="cpu"`` (as the
tests pass) runs there.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev
