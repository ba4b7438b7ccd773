"""Weight bridge between the JAX package's parameter pytree and the port.

``to_torch`` takes the reference pytree with numpy leaves (what
``jax.device_get`` returns) and gives the port's dict of tensors in the
same layout; ``to_numpy`` goes back. bfloat16 crosses bit-exactly through
its raw bytes: numpy sees it as a 2-byte dtype named ``"bfloat16"``, which
is viewed as ``uint16`` and then as ``torch.bfloat16``. Nothing here
imports ml_dtypes; going back, a ``bfloat16`` numpy dtype is used where the
process has one registered, else the ``uint16`` bits are returned.

The same element conversions serve the KV wire format (``models/paged.py``),
whose dtype strings are numpy's names. ``parallel/fsdp.py:
train_state_to_torch`` carries a reference training state, optax's AdamW
moments included (found by :func:`_adam_state`), into the port's
``TrainState``.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device

# the element types of parameters, activations and KV pools
_BY_NAME = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _NAME_OF[dtype]


def torch_dtype(name: str) -> torch.dtype:
    return _BY_NAME[str(name)]


def tensor_from_numpy(arr: Any, device: DeviceLike = "cpu") -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16,
                                                                copy=False)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(torch.device(device))


def _numpy_bfloat16():
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 becomes numpy's
    ``bfloat16`` where one is registered, else its ``uint16`` bits."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        bf16 = _numpy_bfloat16()
        return bits.view(bf16) if bf16 is not None else bits.copy()
    return t.numpy().copy()


def tensor_bytes(t: torch.Tensor) -> bytes:
    """Raw little-endian bytes of a tensor (bfloat16 as its bits)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def tensor_from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    tdt = torch_dtype(dtype)
    if tdt == torch.bfloat16:
        arr = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).copy()
    return torch.from_numpy(arr).reshape(shape)


Tree = Union[Dict[str, Any], Any]


def to_torch(tree: Tree, device: DeviceLike = "cuda") -> Tree:
    """Reference parameter pytree (numpy leaves) -> dict of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def to_numpy(params: Tree) -> Tree:
    """The port's parameters -> pytree of numpy arrays (the inverse)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    return tensor_to_numpy(params)


def _adam_state(tree: Any):
    """The ``ScaleByAdamState(count, mu, nu)`` inside an optax state
    (nested tuples: ``(clip state, (adam state, wd state, lr state))``)."""
    if all(hasattr(tree, name) for name in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _adam_state(item)
            if found is not None:
                return found
    return None
