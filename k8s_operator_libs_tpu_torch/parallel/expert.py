"""Expert parallelism: the MoE's expert stacks split over ``tensor``.

Port of the JAX package's ``parallel/expert.py``. Each rank holds E/n
contiguous experts of every layer (the [L, E, ...] stacks split on their
expert dim, :func:`ep_param_specs`); the router, attention, embed and
lm_head are replicated. Two dispatch strategies behind one step
(:func:`make_ep_train_step`):

- **dense** (:func:`make_ep_loss`): the tokens replicated, each rank runs
  its local experts on the whole stream and the layer's psum merges them
  (``models/moe.py:moe_ffn`` with ``experts_slice``/``ep_group``); the aux
  term is summed over the ranks once, at the end.
- **all-to-all** (:func:`make_ep_a2a_loss`): the batch split over the
  ranks, capacity-bounded buffers travel to their experts and back
  (``models/moe.py:moe_ffn_a2a``); the loss and the aux term are means
  over the ranks. Every replicated parameter meets a rank's own rows, so
  each is marked replicated over the axis (:func:`.fsdp.replicated`: its
  gradient summed over the ranks).

:func:`moe_reference_loss` is the one-device loss (``moe_reference_loss``
:139-149), the step of ``--parallel none``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

import torch

from ..models.moe import MoEConfig, forward, moe_ffn_a2a
from ..models.moe import init_params as moe_init
from ..utils.device import DeviceLike
from . import comm
from .fsdp import (ClippedAdamW, TrainState, init_train_state,
                   make_train_step_from_loss, replicated,
                   sharded_global_norm)
from .mesh import Mesh

AXIS = "tensor"


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def moe_reference_loss(cfg: MoEConfig,
                       attn_fn: Optional[Callable] = None) -> Callable:
    """``loss(params, tokens [B, T + 1])`` on one device: the mean NLL
    plus ``router_aux_coef`` times the summed aux; ``attn_fn`` overrides
    the attention primitive as in :func:`..models.moe.forward`."""

    def loss(params, tokens):
        logits, aux = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
        return _nll(logits, tokens[:, 1:]).mean() + cfg.router_aux_coef * aux

    return loss


def ep_param_specs() -> Dict:
    """The expert stacks over ``tensor`` on their expert dim; every other
    leaf replicated."""
    blocks = {
        "attn_norm": (None, None),
        "wq": (None, None, None), "wk": (None, None, None),
        "wv": (None, None, None), "wo": (None, None, None),
        "mlp_norm": (None, None),
        "router": (None, None, None),
        "w_gate": (None, AXIS, None, None),
        "w_up": (None, AXIS, None, None),
        "w_down": (None, AXIS, None, None),
    }
    return {"embed": (None, None), "blocks": blocks,
            "final_norm": (None,), "lm_head": (None, None)}


def _check_experts(cfg: MoEConfig, n: int) -> None:
    if cfg.n_experts % n:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"{n}-way expert parallelism")


def make_ep_loss(cfg: MoEConfig, mesh: Mesh) -> Callable:
    """Dense dispatch: ``loss(params, tokens [B, T + 1])`` with the
    global tokens on every rank and the expert stacks split over the
    mesh's tensor axis."""
    n = mesh.size(AXIS)
    _check_experts(cfg, n)
    local_e = cfg.n_experts // n
    experts = (mesh.coords[AXIS] * local_e, local_e)
    group = mesh.groups[AXIS]

    def loss(params, tokens):
        logits, aux_partial = forward(params, tokens[:, :-1], cfg,
                                      experts_slice=experts, ep_group=group)
        aux = comm.psum(aux_partial, group)
        return _nll(logits, tokens[:, 1:]).mean() + cfg.router_aux_coef * aux

    return loss


def make_ep_a2a_loss(cfg: MoEConfig, mesh: Mesh,
                     capacity_factor: float = 2.0,
                     record: Optional[list] = None) -> Callable:
    """All-to-all dispatch: ``loss(params, tokens [B, T + 1])``, the
    global tokens on every rank, which takes its B/n rows (B divisible by
    n). Per (source rank, expert) buffer capacity C = min(G, ceil(cf x
    top_k x G / E)), G = B/n x T local tokens; cf >= E/top_k makes it
    lossless (C = G). ``record`` collects each layer's routed and kept
    (token, expert) masks (:func:`..models.moe.moe_ffn_a2a`)."""
    n = mesh.size(AXIS)
    _check_experts(cfg, n)
    r, group = mesh.coords[AXIS], mesh.groups[AXIS]
    specs = ep_param_specs()

    def loss(params, tokens):
        B = tokens.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n}-way a2a "
                             f"expert parallelism")
        Bl = B // n
        rows = tokens[r * Bl:(r + 1) * Bl]
        G = Bl * (rows.shape[1] - 1)
        cap = min(G, math.ceil(capacity_factor * cfg.top_k * G
                               / cfg.n_experts))
        ffn = functools.partial(moe_ffn_a2a, cfg=cfg, group=group,
                                capacity=cap, record=record)
        logits, aux_local = forward(replicated(params, specs, mesh, (AXIS,)),
                                    rows[:, :-1], cfg, ffn_fn=ffn)
        aux = comm.pmean(aux_local, (group,))
        return (comm.pmean(_nll(logits, rows[:, 1:]).mean(), (group,))
                + cfg.router_aux_coef * aux)

    return loss


def make_ep_train_step(cfg: MoEConfig, mesh: Mesh,
                       optimizer: Optional[ClippedAdamW] = None,
                       dispatch: str = "dense",
                       capacity_factor: float = 2.0) -> Callable:
    """``dispatch``: "dense" (:func:`make_ep_loss`) or "a2a"
    (:func:`make_ep_a2a_loss`)."""
    if dispatch == "dense":
        loss_fn = make_ep_loss(cfg, mesh)
    elif dispatch == "a2a":
        loss_fn = make_ep_a2a_loss(cfg, mesh, capacity_factor)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    return make_train_step_from_loss(
        loss_fn, optimizer, grad_norm=sharded_global_norm(mesh,
                                                          ep_param_specs()))


def init_ep_state(cfg: MoEConfig, seed: int, mesh: Mesh,
                  optimizer: Optional[ClippedAdamW] = None,
                  device: DeviceLike = "cuda") -> TrainState:
    """This rank's experts (:func:`ep_param_specs`) of the one-rank MoE
    init, the rest whole, and moments made from them."""
    return init_train_state(cfg, seed, optimizer, device, mesh,
                            pspecs=ep_param_specs(), params_init=moe_init)
