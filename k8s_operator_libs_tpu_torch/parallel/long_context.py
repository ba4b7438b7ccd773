"""Long-context training: the whole model under sequence parallelism.

Port of the JAX package's ``parallel/long_context.py``. The sequence
is split over the mesh's ``seq`` axis and each rank runs the full forward
on its chunk: embeddings, norms and MLPs are position-local; attention,
the one op across positions, is the ring (:mod:`.ring_attention`) or
Ulysses (:mod:`.ulysses`); RoPE positions are offset by rank x Tl; the
causal shift crosses chunk boundaries, so tokens [B, n*Tl + 1] are
shifted globally before each rank takes its chunk.

The loss is the psum-weighted global mean (:func:`.comm.psum`, whose
backward passes the cotangent through): each rank backpropagates its
chunk's NLL sum over the global count. The parameters are replicated
(:func:`.comm.replicate` on each leaf where it is used), so their
gradients are summed over the ``seq`` group in the backward, as
``shard_map``'s transpose sums them. :func:`make_sp_train_step` puts the
loss in the shared train step, so the trainer and its checkpoints are
those of the FSDP path.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..models.llama import LlamaConfig, forward
from . import comm
from .fsdp import ClippedAdamW, make_train_step_from_loss
from .mesh import Mesh
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

ATTN_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def make_sp_loss(cfg: LlamaConfig, mesh: Mesh, axis_name: str = "seq",
                 attn_impl: str = "ring") -> Callable:
    """``loss(params, tokens [B, n*Tl + 1])``, every rank given the same
    global tokens and replicated parameters; the value is the global mean
    NLL on every rank. ``attn_impl``: "ring" or "ulysses" (the axis size
    must divide the head count)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} "
                         "(expected 'ring' or 'ulysses')")
    group = mesh.groups[axis_name]
    n, my = mesh.size(axis_name), mesh.coords[axis_name]
    attn = functools.partial(ATTN_IMPLS[attn_impl], group=group,
                             causal=True)

    def replicated(name, w):
        return comm.replicate(w, group)

    def loss(params, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        B, T = inputs.shape
        if T % n:
            raise ValueError(f"sequence {T} not divisible by the {n}-way "
                             f"{axis_name} axis")
        Tl = T // n
        chunk = slice(my * Tl, (my + 1) * Tl)
        positions = my * Tl + torch.arange(
            Tl, device=tokens.device).expand(B, Tl)
        logits = forward(params, inputs[:, chunk], cfg, positions=positions,
                         attn_fn=attn, gather=replicated)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1,
                            targets[:, chunk].long()[..., None])[..., 0]
        total = comm.psum(nll.sum(), group)
        return total / (nll.numel() * n)

    return loss


def make_sp_train_step(cfg: LlamaConfig, mesh: Mesh,
                       optimizer: Optional[ClippedAdamW] = None,
                       axis_name: str = "seq",
                       attn_impl: str = "ring") -> Callable:
    """The sequence-parallel ``train_step(state, tokens [B, n*Tl + 1])``
    over replicated parameters (``init_train_state`` without a mesh)."""
    return make_train_step_from_loss(
        make_sp_loss(cfg, mesh, axis_name, attn_impl), optimizer)
