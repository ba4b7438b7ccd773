"""The device mesh over a process group's ranks, and the sharding rules.

Port of the JAX package's ``parallel/mesh.py``. Axes, outermost
first: ``stage`` (pipeline), ``data`` (replicated data parallelism),
``fsdp`` (data parallelism with parameters and optimizer state sharded,
ZeRO-3), ``seq`` (sequence parallelism: ring attention or Ulysses) and
``tensor`` (Megatron-style), the innermost. :func:`make_mesh` lays the
world's ranks onto that shape in rank order and gives this rank its
coordinates and one process group per axis: the ranks that share every
other coordinate.

The reference asks ``mesh_utils.create_device_mesh`` to lay the axes onto
a TPU slice's ICI torus (``physical=True``, :72-81). There is no
counterpart here: ranks are placed in rank order, which on a host of
NVLink-joined GPUs (all pairs one hop apart) loses nothing; across hosts
the launcher's rank order decides which axis crosses the network.

A spec is the port's ``PartitionSpec``: a tuple with one entry per dim of
a leaf, the mesh axis that dim is split over or None. :func:`shard_dim`
reads which dim of a leaf a rank holds a slice of along one axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("stage", "data", "fsdp", "seq", "tensor")

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``groups[axis]`` is the process
    group of the ranks along ``axis`` through this rank: the world group
    where the axis spans the world, None for an axis of size 1 in a larger
    world (nothing to communicate)."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape[axis]


def mesh_shape(world: int, data: int = 1, fsdp: Optional[int] = None,
               seq: int = 1, tensor: int = 1,
               stage: int = 1) -> Dict[str, int]:
    """The axis sizes; ``fsdp=None`` takes every rank the others leave
    (the common pure-FSDP case)."""
    if fsdp is None:
        denom = data * seq * tensor * stage
        if world % denom:
            raise ValueError(f"{world} ranks not divisible by {denom}")
        fsdp = world // denom
    shape = dict(zip(AXES, (stage, data, fsdp, seq, tensor)))
    if int(np.prod(list(shape.values()))) != world:
        raise ValueError(f"mesh {tuple(shape.values())} needs "
                         f"{int(np.prod(list(shape.values())))} ranks, "
                         f"have {world}")
    return shape


def coordinates(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank -> its index on each axis (row-major over AXES)."""
    idx = np.unravel_index(rank, tuple(shape[a] for a in AXES))
    return {a: int(i) for a, i in zip(AXES, idx)}


def axis_ranks(shape: Dict[str, int], axis: str):
    """Every group along ``axis``, each a list of ranks in axis order, in
    one fixed order (every rank must create the groups alike)."""
    dims = tuple(shape[a] for a in AXES)
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    k = AXES.index(axis)
    moved = np.moveaxis(ranks, k, -1).reshape(-1, dims[k])
    return [list(map(int, row)) for row in moved]


def local_mesh() -> Mesh:
    """The mesh of one rank: every axis of size 1 and no groups, so each
    collective over it is the identity."""
    shape = mesh_shape(1)
    return Mesh(shape=shape, rank=0, coords=coordinates(shape, 0),
                groups={axis: None for axis in AXES})


def make_mesh(data: int = 1, fsdp: Optional[int] = None, seq: int = 1,
              tensor: int = 1, stage: int = 1) -> Mesh:
    """The mesh over the initialized process group's ranks (one rank, no
    groups, when ``torch.distributed`` is not initialized). Every rank
    must call it, with the same sizes: it creates the axes' groups."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    me = dist.get_rank() if initialized else 0
    shape = mesh_shape(world, data, fsdp, seq, tensor, stage)
    groups: Dict[str, object] = {}
    for axis in AXES:
        groups[axis] = None
        if not initialized:
            continue
        if shape[axis] == world:
            groups[axis] = dist.group.WORLD
            continue
        if shape[axis] == 1:
            continue
        for ranks in axis_ranks(shape, axis):
            group = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = group
    return Mesh(shape=shape, rank=me, coords=coordinates(shape, me),
                groups=groups)


# ------------------------------------------------------------- shardings

_PARAM_SPECS = {
    "embed": ("fsdp", "tensor"),
    "blocks": {
        "attn_norm": (None, None),
        "wq": (None, "fsdp", "tensor"),
        "wk": (None, "fsdp", "tensor"),
        "wv": (None, "fsdp", "tensor"),
        "wo": (None, "tensor", "fsdp"),
        "mlp_norm": (None, None),
        "w_gate": (None, "fsdp", "tensor"),
        "w_up": (None, "fsdp", "tensor"),
        "w_down": (None, "tensor", "fsdp"),
    },
    "final_norm": (None,),
    "lm_head": ("fsdp", "tensor"),
}


def _match(params, specs):
    if isinstance(params, dict):
        if not isinstance(specs, dict) or set(params) != set(specs):
            raise ValueError(f"param tree keys {sorted(params)} do not "
                             f"match the sharding rule's")
        return {k: _match(params[k], specs[k]) for k in params}
    if len(specs) != params.dim():
        raise ValueError(f"spec {specs} for a {params.dim()}-d leaf")
    return specs


def param_specs(params=None) -> Dict:
    """The FSDP rule of the Llama tree (``models/llama.py`` layout): each
    weight's input or output dim over ``fsdp`` and the other model dim
    over ``tensor`` (column-parallel wq/wk/wv/w_gate/w_up, row-parallel
    wo/w_down), the stacked layer dim never split, norms replicated.
    Checked against ``params`` when given."""
    if params is None:
        return _PARAM_SPECS
    return _match(params, _PARAM_SPECS)


def replicated_specs(params) -> Dict:
    """Every leaf replicated (the sequence-parallel path shards
    activations, not weights)."""
    if isinstance(params, dict):
        return {k: replicated_specs(v) for k, v in params.items()}
    return (None,) * params.dim()


def batch_spec() -> Spec:
    """Tokens [B, T]: rows over the data-like axes, the sequence over
    ``seq``."""
    return (("data", "fsdp"), "seq")


def shard_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim of a leaf split over ``axis``, or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            return d
    return None


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a leaf is split over, in AXES order."""
    return tuple(a for a in AXES if shard_dim(spec, a) is not None)


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full leaf along every axis ``spec`` names
    (a dim split over several axes, as ``("data", "fsdp")``, is split
    over them in that order, outermost first): a copy, so the full tensor
    can be freed, except where it is split over no axis of more than one
    rank, where the slice is the leaf itself."""
    part, sliced = x, False
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            n = mesh.size(axis) if axis is not None else 1
            if n == 1:
                continue
            if part.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} not divisible "
                                 f"by the {n}-way {axis} axis")
            part, sliced = part.chunk(n, dim=d)[mesh.coords[axis]], True
    return part.clone() if sliced else x
