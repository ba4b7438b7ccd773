"""Composed 3-D parallelism: pipeline x FSDP x tensor (+ data) in one step.

Port of the JAX package's ``parallel/composed.py``. One loss over the
whole (stage, data, fsdp, tensor) mesh, each axis as the reference's
single ``shard_map`` has it:

- **stage**: the GPipe schedule of :mod:`.pipeline` over the stacked
  layers;
- **data**: each data replica pipelines its own rows of the global batch
  and the loss is the mean over the replicas;
- **fsdp**: ZeRO-3 storage: one model dim of each weight is split over
  ``fsdp`` and all-gathered once per step (:func:`.comm.all_gather`,
  whose backward reduce-scatters the gradients back onto the shards);
- **tensor**: Megatron heads and FFN columns within each stage
  (column-parallel wq/wk/wv/w_gate/w_up, row-parallel wo/w_down, one psum
  after each of the two row-parallel matmuls per block: the tensor hooks
  of :func:`..models.llama._block`), embed and lm_head vocab-sharded over
  ``tensor`` (the one-hot lookup psum and the distributed cross-entropy of
  :mod:`.pipeline`).

What ``shard_map``'s transpose adds is written out with
:func:`.comm.replicate`: on the normed input of every column-parallel
matmul (:func:`column_input`) and of the vocab-sharded head (each tensor
rank sees part of its gradient), and on each parameter over the axes its
spec does not split among stage, data and fsdp (every data replica and
fsdp rank computes a part of the mean loss; embed, lm_head and the final
norm are used for the loss on the last stage and for the lookup on the
first only). The loss is ``pmean`` over data and fsdp, so each fsdp rank
backpropagates 1/fsdp of its replica's loss and the gather's reduce-
scatter sums the fsdp ranks' parts.

The MoE family composes pipeline x expert parallelism (on ``tensor``) x
data (:func:`make_moe_composed_loss`): each stage's layers run their
local experts on the replicated token stream (``models/moe.py``'s
``experts_slice``/``ep_group``), and the aux term is accumulated over
exactly the real microbatch ticks, summed over stage and tensor and
divided by M.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.llama import LlamaConfig, _block, _default_attn, rms_norm
from ..models.moe import init_params as moe_init
from ..models.moe import moe_block
from ..utils import comm
from ..utils.device import DeviceLike
from ..utils.mesh import Mesh
from .fsdp import (ClippedAdamW, TrainState, init_train_state,
                   make_train_step_from_loss, replicated,
                   sharded_global_norm)
from .pipeline import (gpipe_schedule, head_input, stage_layers,
                       vocab_parallel_embed, vocab_parallel_nll)

# the dim each weight is all-gathered over fsdp on
_FSDP_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
             "w_down": 2}


def composed_param_specs() -> Dict:
    """Storage specs: layer stacks over ``stage``, one model dim over
    ``fsdp``, the Megatron-legal dim over ``tensor``; embed and lm_head
    vocab-sharded over ``tensor`` with their D over ``fsdp``."""
    return {
        "embed": ("tensor", "fsdp"),
        "blocks": {
            "attn_norm": ("stage", None),
            "wq": ("stage", "fsdp", "tensor"),
            "wk": ("stage", "fsdp", "tensor"),
            "wv": ("stage", "fsdp", "tensor"),
            "wo": ("stage", "tensor", "fsdp"),
            "mlp_norm": ("stage", None),
            "w_gate": ("stage", "fsdp", "tensor"),
            "w_up": ("stage", "fsdp", "tensor"),
            "w_down": ("stage", "tensor", "fsdp"),
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tensor"),
    }


def _check_divisibility(cfg: LlamaConfig, mesh: Mesh) -> None:
    S, tp, fs = mesh.size("stage"), mesh.size("tensor"), mesh.size("fsdp")
    if cfg.n_layers % S:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{S} stages")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads {cfg.n_heads}/kv {cfg.n_kv_heads} not "
                         f"divisible by {tp}-way tensor parallelism")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by {tp}-way "
                         f"tensor parallelism")
    if cfg.d_model % fs or cfg.d_ff % fs:
        raise ValueError(f"d_model {cfg.d_model}/d_ff {cfg.d_ff} not "
                         f"divisible by {fs}-way fsdp")
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by "
                         f"{tp}-way tensor parallelism (vocab-sharded "
                         f"embed/lm_head)")


def _check_batch(B: int, dp: int, M: int) -> None:
    if B % (dp * M):
        raise ValueError(f"batch {B} not divisible by data({dp}) x "
                         f"microbatches({M})")


def column_input(h: torch.Tensor, group) -> torch.Tensor:
    """The normed activations entering a column-parallel matmul: the same
    on every tensor rank, each of which computes part of their gradient,
    so replicated over the group."""
    return comm.replicate(h, group)


def _data_rows(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data replica's rows of the global batch."""
    dp, d = mesh.size("data"), mesh.coords["data"]
    Bd = tokens.shape[0] // dp
    return tokens[d * Bd:(d + 1) * Bd]


def make_composed_loss(cfg: LlamaConfig, mesh: Mesh, num_microbatches: int
                       ) -> Callable:
    """``loss(params, tokens [B, T + 1])``, params laid out by
    :func:`composed_param_specs`, the global tokens on every rank (B
    divisible by data x ``num_microbatches``); the mean NLL on every
    rank."""
    S, dp, M = mesh.size("stage"), mesh.size("data"), num_microbatches
    _check_divisibility(cfg, mesh)
    s, tgroup = mesh.coords["stage"], mesh.groups["tensor"]
    fgroup = mesh.groups["fsdp"]
    specs = composed_param_specs()

    def tp_in(h):
        return column_input(h, tgroup)

    def tp_out(y):
        return comm.psum(y, tgroup)

    def loss(params, tokens):
        _check_batch(tokens.shape[0], dp, M)
        rows = _data_rows(tokens, mesh)
        inputs, targets = rows[:, :-1], rows[:, 1:]
        Bd, T = inputs.shape
        Bm = Bd // M
        positions = torch.arange(T, device=tokens.device).expand(Bm, T)
        p = replicated(params, specs, mesh, ("stage", "data", "fsdp"))
        # ZeRO-3: this stage's layers gathered over fsdp once per step
        blocks = {k: (comm.all_gather(w, fgroup, _FSDP_DIM[k])
                      if k in _FSDP_DIM else w)
                  for k, w in p["blocks"].items()}
        layers = stage_layers({"blocks": blocks})
        embed = comm.all_gather(p["embed"], fgroup, 1)          # [V/tp, D]
        lm_head = comm.all_gather(p["lm_head"], fgroup, 0)      # [D, V/tp]
        v_start = mesh.coords["tensor"] * embed.shape[0]

        def stage_apply(x):
            for layer in layers:
                x = _block(cfg, _default_attn, x, layer, positions,
                           tp_in=tp_in, tp_out=tp_out)
            return x

        def project_nll(y, mb_t):
            h = head_input(rms_norm(y, p["final_norm"]), tgroup)
            return vocab_parallel_nll(h, lm_head, mb_t, v_start, tgroup)

        total, count = gpipe_schedule(
            S, M, s, mesh.groups["stage"], inputs, targets,
            lambda mb: vocab_parallel_embed(mb, embed, v_start, tgroup),
            stage_apply, project_nll,
            torch.zeros((Bm, T, cfg.d_model), dtype=embed.dtype,
                        device=embed.device))
        # the mean over data replicas; over fsdp the values are equal
        return comm.pmean(total / count, (mesh.groups["data"], fgroup))

    return loss


def make_composed_train_step(cfg: LlamaConfig, mesh: Mesh,
                             num_microbatches: int = 4,
                             optimizer: Optional[ClippedAdamW] = None
                             ) -> Callable:
    """The pp x fsdp x tp (+ dp) ``train_step(state, tokens)``; the
    gradients arrive on the parameters' own slices and the optimizer runs
    on them."""
    return make_train_step_from_loss(
        make_composed_loss(cfg, mesh, num_microbatches), optimizer,
        grad_norm=sharded_global_norm(mesh, composed_param_specs()))


def init_composed_state(cfg: LlamaConfig, seed: int, mesh: Mesh,
                        optimizer: Optional[ClippedAdamW] = None,
                        device: DeviceLike = "cuda") -> TrainState:
    """This rank's slices (:func:`composed_param_specs`) of the one-rank
    init, and moments made from them."""
    return init_train_state(cfg, seed, optimizer, device, mesh,
                            pspecs=composed_param_specs())


# ------------------------------------------------------------ MoE

def moe_composed_param_specs() -> Dict:
    """pp x ep storage: layer stacks over ``stage``, the expert stacks
    also over ``tensor`` on their expert dim; attention, the router,
    embed and lm_head replicated (as in :mod:`.expert`'s dense
    dispatch)."""
    blocks = {
        "attn_norm": ("stage", None),
        "wq": ("stage", None, None), "wk": ("stage", None, None),
        "wv": ("stage", None, None), "wo": ("stage", None, None),
        "mlp_norm": ("stage", None),
        "router": ("stage", None, None),
        "w_gate": ("stage", "tensor", None, None),
        "w_up": ("stage", "tensor", None, None),
        "w_down": ("stage", "tensor", None, None),
    }
    return {"embed": (None, None), "blocks": blocks,
            "final_norm": (None,), "lm_head": (None, None)}


def make_moe_composed_loss(cfg, mesh: Mesh, num_microbatches: int
                           ) -> Callable:
    """``loss(params, tokens [B, T + 1])`` of the MoE family over
    stage x data x tensor (fsdp and seq of one rank), params laid out by
    :func:`moe_composed_param_specs`: the mean NLL plus
    ``router_aux_coef`` times the aux summed over layers and experts and
    averaged over the M microbatches."""
    S, tp = mesh.size("stage"), mesh.size("tensor")
    dp, M = mesh.size("data"), num_microbatches
    if mesh.size("fsdp") != 1 or mesh.size("seq") != 1:
        raise ValueError("moe composed path supports stage x data x tensor "
                         "meshes (fsdp=seq=1)")
    if cfg.n_layers % S:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{S} stages")
    if cfg.n_experts % tp:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"{tp}-way expert parallelism")
    local_e = cfg.n_experts // tp
    experts = (mesh.coords["tensor"] * local_e, local_e)
    s, tgroup = mesh.coords["stage"], mesh.groups["tensor"]
    sgroup = mesh.groups["stage"]
    specs = moe_composed_param_specs()

    def loss(params, tokens):
        _check_batch(tokens.shape[0], dp, M)
        rows = _data_rows(tokens, mesh)
        inputs, targets = rows[:, :-1], rows[:, 1:]
        Bd, T = inputs.shape
        Bm = Bd // M
        positions = torch.arange(T, device=tokens.device).expand(Bm, T)
        p = replicated(params, specs, mesh, ("stage", "data"))
        layers = stage_layers(p)

        def stage_apply(x):
            aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in layers:
                x, aux = moe_block(x, layer, cfg, positions,
                                   experts_slice=experts, ep_group=tgroup)
                aux_tot = aux_tot + aux
            return x, aux_tot

        def project_nll(y, mb_t):
            h = rms_norm(y, p["final_norm"])
            logp = torch.log_softmax((h @ p["lm_head"]).float(), dim=-1)
            return -torch.gather(logp, -1, mb_t.long()[..., None])[..., 0]

        total, count, aux_tot = gpipe_schedule(
            S, M, s, sgroup, inputs, targets,
            lambda mb: torch.nn.functional.embedding(mb.long(), p["embed"]),
            stage_apply, project_nll,
            torch.zeros((Bm, T, cfg.d_model), dtype=p["embed"].dtype,
                        device=p["embed"].device),
            stage_aux=True)
        aux = comm.psum(comm.psum(aux_tot, sgroup), tgroup) / M
        return comm.pmean(total / count + cfg.router_aux_coef * aux,
                          (mesh.groups["data"],))

    return loss


def make_moe_composed_train_step(cfg, mesh: Mesh, num_microbatches: int = 4,
                                 optimizer: Optional[ClippedAdamW] = None
                                 ) -> Callable:
    """The pp x ep (+ dp) MoE ``train_step(state, tokens)``."""
    return make_train_step_from_loss(
        make_moe_composed_loss(cfg, mesh, num_microbatches), optimizer,
        grad_norm=sharded_global_norm(mesh, moe_composed_param_specs()))


def init_moe_composed_state(cfg, seed: int, mesh: Mesh,
                            optimizer: Optional[ClippedAdamW] = None,
                            device: DeviceLike = "cuda") -> TrainState:
    """This rank's slices (:func:`moe_composed_param_specs`) of the
    one-rank MoE init, and moments made from them."""
    return init_train_state(cfg, seed, optimizer, device, mesh,
                            pspecs=moe_composed_param_specs(),
                            params_init=moe_init)
