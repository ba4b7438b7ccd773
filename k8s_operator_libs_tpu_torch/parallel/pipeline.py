"""Pipeline parallelism: the stacked layers split over the ``stage`` axis.

Port of the JAX package's ``parallel/pipeline.py``. The per-layer
weights are stacked on a leading [L, ...] dim, so a stage holds L/S
contiguous layers by splitting exactly that dim over the mesh's
``stage`` axis (:func:`pp_param_specs`). The schedule is GPipe
(:func:`gpipe_schedule`): the batch splits into M microbatches; at tick
t stage s runs microbatch t - s, and the boundary activations hop to the
next stage by :func:`.comm.ppermute`. The backward is autograd through
the ticks (the ppermutes' backward sends the activations' gradients back
a stage), as the reference's is JAX's transpose of its scans.

Embed and lm_head are vocab-sharded over ``stage`` (V/S rows or columns
per stage): each tick's microbatch embedding assembles full rows with
one psum, and the loss is a distributed cross-entropy
(:func:`vocab_parallel_nll`: a pmax and two psums over the per-stage
logit shards), so the full ``[*, V]`` logits never exist on a rank.

What ``shard_map`` adds to the reference's backward is written out with
:func:`.comm.replicate` (the identity, whose backward sums the gradient
over the group): after the embedding psum (the rows are used on stage 0
only, and every stage's owned rows need that gradient), on the head's
input ``h`` (each stage's vocab shard sees part of it) and on the NLL
(its masked sum reaches the last stage only). Every stage runs the same
collectives in the same order, forward and backward: the stage and the
real microbatch ticks are selected with :func:`torch.where`, never by
control flow on the stage index, and the bubble ticks compute on zeros,
as the reference's do. A pipeline rank therefore runs the flash kernels
(L/S)(S + M - 1) times per step, each direction. The reference's last
tick also sends its output on, into a carry nobody reads; that send is
not made.

Bubble fraction is (S - 1)/(S - 1 + M).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.llama import LlamaConfig, _block, _default_attn, rms_norm
from ..utils.device import DeviceLike
from . import comm
from .fsdp import (ClippedAdamW, TrainState, init_train_state,
                   make_train_step_from_loss, sharded_global_norm)
from .mesh import Mesh

AXIS = "stage"

_BLOCK_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                 "w_up", "w_down")


def _flag(cond: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(bool(cond), device=like.device)


def gpipe_schedule(S: int, M: int, stage_index: int, group,
                   inputs: torch.Tensor, targets: torch.Tensor,
                   embed_mb: Callable, stage_apply: Callable,
                   project_nll: Callable, init_x: torch.Tensor,
                   stage_aux: bool = False):
    """The GPipe tick loop, shared by :func:`make_pp_loss` and the
    composed paths (:mod:`.composed`); the reference's :45-120. At tick t
    stage s holds microbatch t - s: stage 0 takes ``embed_mb(tokens)``,
    every stage runs ``stage_apply(x)``, and the output hops on. The M
    ticks at which the last stage finishes microbatches 0..M-1 are
    stacked into one window [M * Bm, T, D] (m-major, in the targets' row
    order), which ``project_nll(window, targets)`` turns into per-token
    NLL once; the total is kept on the last stage and summed over the
    group.

    ``stage_aux=True``: ``stage_apply(x) -> (y, aux)``, and aux is summed
    over exactly the ticks at which this stage holds a real microbatch
    (t in [s, s + M)), the MoE's load-balance term.

    Returns (total NLL, token count), plus the accumulated aux with
    ``stage_aux``."""
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    Bm = inputs.shape[0] // M
    s = stage_index
    first = _flag(s == 0, init_x)
    x = init_x
    aux_tot = torch.zeros((), dtype=torch.float32, device=init_x.device)
    ys = []
    ticks = S + M - 1
    for t in range(ticks):
        m_in = min(t, M - 1)
        x = torch.where(first, embed_mb(inputs[m_in * Bm:(m_in + 1) * Bm]),
                        x)
        if stage_aux:
            y, aux = stage_apply(x)
            real = _flag(s <= t < s + M, aux)
            aux_tot = aux_tot + torch.where(real, aux, torch.zeros_like(aux))
        else:
            y = stage_apply(x)
        if t >= S - 1:
            ys.append(y)
        if t + 1 < ticks:
            x = comm.ppermute(y, group, fwd_perm)
    nll = project_nll(torch.cat(ys), targets[:M * Bm])
    last = _flag(s == S - 1, nll)
    nll_sum = nll.sum()
    total = comm.psum(torch.where(last, nll_sum, torch.zeros_like(nll_sum)),
                      group)
    count = nll.numel()
    if stage_aux:
        return total, count, aux_tot
    return total, count


def vocab_parallel_nll(h: torch.Tensor, head: torch.Tensor,
                       targets: torch.Tensor, v_start: int,
                       group) -> torch.Tensor:
    """Per-token NLL over a vocab-sharded head: this rank's logit shard
    ``(h @ head)`` in fp32 [.., V/n], the logsumexp assembled from a pmax
    (a stabilizer, no gradient) and a psum of the shards' exp sums, and
    the target logit from the shard that owns it, psummed. The whole
    logits never exist."""
    logits = (h @ head).float()
    m = comm.pmax(logits.detach().amax(dim=-1), group)
    se = comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    lse = m + torch.log(se)
    idx, owned = local_index(targets, v_start, logits.shape[-1])
    tl = torch.gather(logits, -1, idx[..., None])[..., 0]
    return lse - comm.psum(torch.where(owned, tl, torch.zeros_like(tl)),
                           group)


def local_index(tokens: torch.Tensor, v_start: int, v_local: int):
    """(index into this rank's vocab shard, clipped; whether it owns the
    token)."""
    idx = tokens.long() - v_start
    owned = (idx >= 0) & (idx < v_local)
    return idx.clamp(0, v_local - 1), owned


def vocab_parallel_embed(tokens: torch.Tensor, embed: torch.Tensor,
                         v_start: int, group) -> torch.Tensor:
    """Embedding rows from a vocab-sharded table: each rank's owned rows,
    zeros elsewhere, psummed into whole rows."""
    idx, owned = local_index(tokens, v_start, embed.shape[0])
    rows = torch.nn.functional.embedding(idx, embed)
    return comm.psum(torch.where(owned[..., None], rows,
                                 torch.zeros_like(rows)), group)


def head_input(h: torch.Tensor, group) -> torch.Tensor:
    """The normed window entering a vocab-sharded head: replicated over
    the group, since each rank's shard sees part of its gradient."""
    return comm.replicate(h, group)


def pp_param_specs() -> Dict:
    """Layer stacks over ``stage`` on their layer dim; embed [V, D] and
    lm_head [D, V] vocab-sharded over ``stage``; the final norm
    replicated."""
    blocks = {k: ("stage", None) if k.endswith("norm")
              else ("stage", None, None) for k in _BLOCK_LEAVES}
    return {"embed": ("stage", None), "blocks": blocks,
            "final_norm": (None,), "lm_head": (None, "stage")}


def stage_layers(params: Dict) -> list:
    """This stage's layers, one dict per layer (one unbind per stacked
    leaf: its backward stacks the layers' gradients once)."""
    blocks = params["blocks"]
    names = list(blocks)
    return [dict(zip(names, ws))
            for ws in zip(*(blocks[n].unbind(0) for n in names))]


def make_pp_loss(cfg: LlamaConfig, mesh: Mesh, num_microbatches: int
                 ) -> Callable:
    """``loss(params, tokens [B, T + 1])`` over the mesh's stage axis,
    params laid out by :func:`pp_param_specs`, the global tokens on every
    rank (B divisible by ``num_microbatches``); the mean NLL on every
    rank."""
    S, M = mesh.size(AXIS), num_microbatches
    if cfg.n_layers % S:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{S} stages")
    if cfg.vocab_size % S:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by "
                         f"{S} stages (embed/lm_head are vocab-sharded)")
    group, s = mesh.groups[AXIS], mesh.coords[AXIS]

    def loss(params, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        B, T = inputs.shape
        Bm = B // M
        positions = torch.arange(T, device=tokens.device).expand(Bm, T)
        embed, lm_head = params["embed"], params["lm_head"]
        v_start = s * embed.shape[0]
        layers = stage_layers(params)
        last = _flag(s == S - 1, embed)

        def embed_mb(mb):
            # every stage contributes its owned rows; the rows are used on
            # stage 0, so their gradient is summed over the stages
            return comm.replicate(vocab_parallel_embed(mb, embed, v_start,
                                                       group), group)

        def stage_apply(x):
            for layer in layers:
                x = _block(cfg, _default_attn, x, layer, positions)
            return x

        def project_nll(win, mb_t):
            # the window exists on the last stage: broadcast it, then each
            # stage computes its vocab shard of the logits
            win = comm.psum(torch.where(last, win, torch.zeros_like(win)),
                            group)
            h = head_input(rms_norm(win, params["final_norm"]), group)
            nll = vocab_parallel_nll(h, lm_head, mb_t, v_start, group)
            # the same on every stage; the schedule keeps the last's sum
            return comm.replicate(nll, group)

        total, count = gpipe_schedule(
            S, M, s, group, inputs, targets, embed_mb, stage_apply,
            project_nll, torch.zeros((Bm, T, cfg.d_model), dtype=embed.dtype,
                                     device=embed.device))
        return total / count

    return loss


def init_pp_state(cfg: LlamaConfig, seed: int, mesh: Mesh,
                  optimizer: Optional[ClippedAdamW] = None,
                  device: DeviceLike = "cuda") -> TrainState:
    """This rank's slices (:func:`pp_param_specs`) of the one-rank init,
    and moments made from them."""
    return init_train_state(cfg, seed, optimizer, device, mesh,
                            pspecs=pp_param_specs())


def make_pp_train_step(cfg: LlamaConfig, mesh: Mesh,
                       num_microbatches: int = 4,
                       optimizer: Optional[ClippedAdamW] = None) -> Callable:
    """The pipeline-parallel ``train_step(state, tokens [B, T + 1])``."""
    return make_train_step_from_loss(
        make_pp_loss(cfg, mesh, num_microbatches), optimizer,
        grad_norm=sharded_global_norm(mesh, pp_param_specs()))
