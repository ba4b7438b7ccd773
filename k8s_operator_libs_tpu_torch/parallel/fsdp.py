"""The training step: causal-LM loss, gradients, clipped AdamW, on one
device or sharded over a mesh's ``fsdp`` axis (ZeRO-3).

Port of the JAX package's ``parallel/fsdp.py``. The step is eager
PyTorch (``jax.jit`` has no counterpart the port needs): autograd through
the loss, whose attention runs in the flash kernels on the card.
:func:`make_train_step_from_loss` wraps any ``loss(params, tokens)`` (the
MoE family's :func:`..parallel.expert.moe_reference_loss`, the
sequence-parallel loss of :mod:`.long_context`);
:func:`make_train_step` is it around the Llama causal-LM loss
(:func:`fsdp_loss`; on one rank it computes :func:`causal_lm_loss`, which
stays for references that pass a plain attention).

With a mesh (the reference's ``make_train_step(cfg, mesh=...)``,
``_state_shardings`` :71, ``init_train_state`` :102, :202-238), what XLA
derives from the sharding annotations is written out: each rank keeps its
slice of every parameter and of both moments (:func:`..mesh.param_specs`:
the norms are replicated); a layer's weights are all-gathered where the
layer uses them, inside its checkpointed regions (the ``gather`` hook of
:func:`..models.llama.forward`), so under remat autograd holds shards
only; the all-gather's backward reduce-scatters the gradients, and a
replicated leaf's gradient is summed over the group. Each rank takes its
rows of the global batch and backpropagates its mean loss over n, so the
sum is the gradient of the global mean loss. The global norm sums the
shards' squares over the group (a replicated leaf counts once) before
the clip and the ``grad_norm`` metric. The optimizer runs on the shards.

:func:`default_optimizer` is written out by hand to follow optax's
``chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.95,
weight_decay=0.1))`` step by step, with its rounding order: the moments
are kept in each parameter's dtype (``mu_dtype=None``), each scalar
constant is rounded to that dtype as JAX's weakly typed Python floats
are, and the update is ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``,
``p += -lr * u``. It updates parameters and moments in place (JAX returns
new arrays), which saves a copy of each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.llama import (LlamaConfig, Params, forward, init_params,
                            param_leaves)
from ..utils.device import DeviceLike
from . import comm
from .mesh import Mesh, local_mesh, param_specs, shard, shard_dim, spec_axes


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the first and
    second moments, trees shaped like the parameters."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    """Parameters + optimizer state + step."""

    params: Params
    opt_state: AdamWState
    step: int


def _const(x: float, dtype: torch.dtype) -> float:
    """A Python float as JAX uses it against an array of ``dtype``:
    rounded to that dtype."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _squares(leaves) -> torch.Tensor:
    return sum(torch.sum(g.float() * g.float()) for g in leaves)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(_squares(param_leaves(tree)))


def sharded_global_norm(mesh: Mesh, specs) -> Callable:
    """``grad_norm(grads)`` of a tree sharded by ``specs`` over the mesh:
    each leaf's squares summed over exactly the axes that split it (one
    all-reduce per set of axes, over each of its axes in turn), so a leaf
    replicated on an axis counts once."""

    def grad_norm(grads: Params) -> torch.Tensor:
        by_axes: Dict[Tuple[str, ...], list] = {}
        _tree_map(lambda g, spec: by_axes.setdefault(spec_axes(spec), [])
                  .append(g), grads, specs)
        total = 0.0
        # every rank holds the same spec tree: the same sets, one order
        for axes in sorted(by_axes):
            part = _squares(by_axes[axes])
            for axis in axes:
                part = comm.all_reduce_(part, mesh.groups[axis])
            total = total + part
        return torch.sqrt(total)

    return grad_norm


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.95,
    eps=1e-8, weight_decay=0.1))``."""

    b1, b2, eps, weight_decay, max_norm = 0.9, 0.95, 1e-8, 0.1, 1.0

    def __init__(self, lr: float = 3e-4):
        self.lr = lr

    def init(self, params: Params) -> AdamWState:
        return AdamWState(count=0,
                          mu=_tree_map(torch.zeros_like, params),
                          nu=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               g_norm: torch.Tensor) -> AdamWState:
        """One step: clip ``grads`` by their global norm ``g_norm``
        (optax's rule: unchanged when the norm is below ``max_norm``, else
        ``g / norm * max_norm``), then AdamW. Updates ``params`` and the
        moments in place and returns the state with the count advanced."""
        keep = g_norm < self.max_norm        # on the device: no host sync
        count = state.count + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = one - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = one - torch.tensor(self.b2, dtype=torch.float32) ** count

        def leaf(p, g, mu, nu):
            dt = p.dtype
            g = torch.where(keep, g, (g / g_norm.to(dt))
                            * _const(self.max_norm, dt))
            mu.copy_(_const(1 - self.b1, dt) * g + _const(self.b1, dt) * mu)
            nu.copy_(_const(1 - self.b2, dt) * (g * g)
                     + _const(self.b2, dt) * nu)
            u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt))
                                     + _const(self.eps, dt))
            u = u + _const(self.weight_decay, dt) * p
            p.add_(_const(-self.lr, dt) * u)

        _tree_map(leaf, params, grads, state.mu, state.nu)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


def default_optimizer(lr: float = 3e-4) -> ClippedAdamW:
    """Global-norm-clipped AdamW (clip 1.0, b1 0.9, b2 0.95, eps 1e-8,
    weight decay 0.1 on every leaf)."""
    return ClippedAdamW(lr)


def causal_lm_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy; fp32 logits, mean over all positions."""
    logits = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0].mean()


def _split_axes(spec):
    """(dim, axis) for every axis a spec splits a dim over, in the order
    :func:`..mesh.shard` slices them."""
    return [(d, axis) for d, entry in enumerate(spec)
            for axis in (entry if isinstance(entry, tuple) else (entry,))
            if axis is not None]


def full_shape(x: torch.Tensor, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from this rank's slice of it."""
    shape = list(x.shape)
    for d, axis in _split_axes(spec):
        shape[d] *= mesh.size(axis)
    return tuple(shape)


@torch.no_grad()
def full_leaf(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf, all-gathered from the ranks' slices over every axis
    that splits it, the last-sliced first (every rank of those groups must
    call it)."""
    for d, axis in reversed(_split_axes(spec)):
        x = comm.all_gather(x, mesh.groups[axis], d)
    return x


def replicated(params: Params, specs, mesh: Mesh, axes) -> Params:
    """Each leaf as an input replicated over those of ``axes`` its spec
    does not split (:func:`.comm.replicate`: the identity, whose backward
    sums the leaf's gradient over the axis): what ``shard_map``'s
    transpose adds for a ``P()`` input that meets per-rank data."""
    def leaf(p, spec):
        held = spec_axes(spec)
        for axis in axes:
            if axis not in held:
                p = comm.replicate(p, mesh.groups[axis])
        return p
    return _tree_map(leaf, params, specs)


def init_train_state(cfg: LlamaConfig, seed: int = 0,
                     optimizer: Optional[ClippedAdamW] = None,
                     device: DeviceLike = "cuda",
                     mesh: Optional[Mesh] = None, pspecs=None,
                     params_init: Optional[Callable] = None) -> TrainState:
    """Seeded parameters and zero moments on ``device``, step 0. With a
    mesh, each rank keeps its slices of the one-rank ``params_init(cfg,
    seed)`` (whole for a moment, one tree of parameters) by the spec tree
    ``pspecs`` (default the FSDP rule :func:`..mesh.param_specs`) and
    makes its moments from the slices: no rank holds the whole moments.
    ``params_init`` defaults to the Llama ``init_params`` (the MoE family
    passes its own)."""
    optimizer = optimizer or default_optimizer()
    params = (params_init or init_params)(cfg, seed=seed, device=device)
    if mesh is not None:
        specs = param_specs(params) if pspecs is None else pspecs
        params = _tree_map(lambda p, s: shard(p, s, mesh), params, specs)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def value_and_grad(loss_fn: Callable, params: Params, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients) of ``loss_fn(params, tokens)``, the gradients a
    tree shaped like ``params``."""
    traced = _tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(traced, tokens)
    grads = iter(torch.autograd.grad(loss, list(param_leaves(traced))))
    return loss.detach(), _tree_map(lambda _: next(grads), params)


def make_train_step_from_loss(loss_fn: Callable,
                              optimizer: Optional[ClippedAdamW] = None,
                              grad_accum: int = 1,
                              grad_norm: Callable = global_norm
                              ) -> Callable:
    """``train_step(state, tokens) -> (state, metrics)`` around any
    ``loss_fn(params, tokens)``, with metrics ``{loss, grad_norm, step}``
    (``grad_norm(grads)`` before clipping: :func:`sharded_global_norm`
    for a sharded tree).

    ``grad_accum=A`` splits the batch's leading dim into A equal
    microbatches run one after another: activation memory is one
    microbatch's; gradients accumulate in fp32 and their mean is cast to
    each parameter's dtype, equal to the full-batch mean because the
    microbatches are equal-sized. One optimizer update per step. The
    state is updated in place and returned."""
    optimizer = optimizer or default_optimizer()

    def compute_grads(params, tokens):
        if grad_accum == 1:
            return value_and_grad(loss_fn, params, tokens)
        if tokens.shape[0] % grad_accum:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"grad_accum={grad_accum}")
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = _tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for mb in tokens.chunk(grad_accum, dim=0):
            loss, grads = value_and_grad(loss_fn, params, mb)
            _tree_map(lambda a, g: a.add_(g.float()), grad_sum, grads)
            loss_sum += loss.float()
        scale = 1.0 / grad_accum
        grads = _tree_map(lambda g, p: (g * scale).to(p.dtype), grad_sum,
                          params)
        return loss_sum * scale, grads

    def train_step(state: TrainState, tokens: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = compute_grads(state.params, tokens)
        g_norm = grad_norm(grads)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     g_norm)
        step = state.step + 1
        return (TrainState(params=state.params, opt_state=opt_state,
                           step=step),
                {"loss": loss, "grad_norm": g_norm, "step": step})

    return train_step


def fsdp_gather(mesh: Mesh, specs) -> Callable:
    """The ``gather`` hook of :func:`..models.llama.forward` for a tree
    sharded by ``specs`` over the fsdp axis: a split leaf is all-gathered
    (its gradient reduce-scattered), a replicated one passes through (its
    gradient summed over the group). A stacked leaf arrives one layer at a
    time, its layer dim gone."""
    group = mesh.groups["fsdp"]
    dims = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            dims.update({n: (None if shard_dim(sp, "fsdp") is None
                             else shard_dim(sp, "fsdp") - 1)
                         for n, sp in spec.items()})
        else:
            dims[name] = shard_dim(spec, "fsdp")

    def gather(name: str, w: torch.Tensor) -> torch.Tensor:
        d = dims[name]
        if d is None:
            return comm.replicate(w, group)
        return comm.all_gather(w, group, d)

    return gather


def _check_fsdp_mesh(mesh: Mesh) -> None:
    others = {a: n for a, n in mesh.shape.items() if a != "fsdp" and n > 1}
    if others:
        raise ValueError(f"the FSDP step shards over the fsdp axis only; "
                         f"mesh axes {others} have no counterpart yet")


def fsdp_loss(cfg: LlamaConfig, mesh: Mesh, specs) -> Callable:
    """``loss(shards, tokens [B, T + 1])`` of the global batch: this rank
    runs its B/n rows on the gathered weights; the loss is the mean over
    the whole batch, on every rank. Backpropagating it gives each rank
    its rows' share, which the all-gathers' backward sums."""
    _check_fsdp_mesh(mesh)
    n, r = mesh.size("fsdp"), mesh.coords["fsdp"]
    group, gather = mesh.groups["fsdp"], fsdp_gather(mesh, specs)

    def loss(params, tokens):
        B = tokens.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by the {n}-way fsdp "
                             f"axis")
        rows = tokens[r * (B // n):(r + 1) * (B // n)]
        logits = forward(params, rows[:, :-1], cfg, gather=gather)
        targets = rows[:, 1:].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return comm.psum(nll.mean(), group) / n

    return loss


def make_train_step(cfg: LlamaConfig,
                    optimizer: Optional[ClippedAdamW] = None,
                    grad_accum: int = 1,
                    mesh: Optional[Mesh] = None) -> Callable:
    """:func:`make_train_step_from_loss` around the Llama causal-LM loss,
    the FSDP step over ``mesh``'s fsdp axis (the state from
    :func:`init_train_state` with the same mesh, tokens the global
    batch). Without a mesh, one rank's: every collective is the identity,
    and the step is the one-device step."""
    if mesh is None:
        mesh = local_mesh()
    specs = param_specs()
    return make_train_step_from_loss(
        fsdp_loss(cfg, mesh, specs), optimizer, grad_accum,
        sharded_global_norm(mesh, specs))
