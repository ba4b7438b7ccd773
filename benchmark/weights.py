"""Seeded weights, made on the device: the input both sides are given.

Every (leaf, layer) slab has a generator of its own, seeded from the run's
seed and the slab's name, so any slab can be made again alone: the plain
references rebuild the weights they need layer by layer from the seed, and
the training comparison rebuilds the initial value of a leaf to measure
how far the program moved it. A stacked leaf is filled one layer slab per
call (an expert stack's slab holds all its experts), each call drawing
normal values straight into the served dtype on the device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from .models import Dims, leaf_specs


def slab_seed(seed: int, name: str, layer: int = -1) -> int:
    """A 63-bit generator seed for one slab, from the run's seed (any
    integer) and the slab's name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}:{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _fill(out: torch.Tensor, kind: str, fan_in: int, seed: int, name: str,
          layer: int) -> torch.Tensor:
    if kind == "ones":
        return out.fill_(1.0)
    gen = torch.Generator(device=out.device)
    gen.manual_seed(slab_seed(seed, name, layer))
    return out.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


def _dtype(d: Dims, kind: str) -> torch.dtype:
    return getattr(torch, d.dtype) if kind == "dense" else torch.float32


def make_params(d: Dims, seed: int, device) -> Dict:
    """The whole parameter tree in the port's layout on ``device``."""
    params: Dict = {"blocks": {}}
    for name, shape, fan_in, kind in leaf_specs(d):
        dt = _dtype(d, kind)
        if name.startswith("blocks."):
            leaf = torch.empty((d.n_layers, *shape), dtype=dt,
                               device=device)
            for i in range(d.n_layers):
                _fill(leaf[i], kind, fan_in, seed, name, i)
            params["blocks"][name[len("blocks."):]] = leaf
        else:
            params[name] = _fill(torch.empty(shape, dtype=dt,
                                             device=device),
                                 kind, fan_in, seed, name, -1)
    return params


def make_slab(d: Dims, seed: int, name: str, layer: int, device,
              dtype=None) -> torch.Tensor:
    """One slab as :func:`make_params` makes it (``layer`` -1 for a leaf
    that is not stacked), optionally cast to ``dtype`` afterwards."""
    for leaf, shape, fan_in, kind in leaf_specs(d):
        if leaf == name:
            out = torch.empty(shape, dtype=_dtype(d, kind), device=device)
            out = _fill(out, kind, fan_in, seed, name, layer)
            return out if dtype is None else out.to(dtype)
    raise KeyError(name)


def make_layer(d: Dims, seed: int, layer: int, device,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every stacked leaf's slab of one layer, cast to ``dtype``, keyed
    without the ``blocks.`` prefix."""
    return {name[len("blocks."):]: make_slab(d, seed, name, layer, device,
                                             dtype)
            for name, _, _, _ in leaf_specs(d) if name.startswith("blocks.")}


def leaf_of(params: Dict, leaf: str) -> torch.Tensor:
    """A compared leaf (``blocks.wq.7``, ``embed``) of a parameter tree in
    the port's layout."""
    if leaf.startswith("blocks."):
        _, name, layer = leaf.split(".")
        return params["blocks"][name][int(layer)]
    return params[leaf]


def initial_of(d: Dims, seed: int, leaf: str, device) -> torch.Tensor:
    """The value :func:`make_params` gave a compared leaf."""
    if leaf.startswith("blocks."):
        _, name, layer = leaf.split(".")
        return make_slab(d, seed, f"blocks.{name}", int(layer), device)
    return make_slab(d, seed, leaf, -1, device)
