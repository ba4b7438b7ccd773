"""The training step on one device: causal-LM loss, gradients, clipped
AdamW.

Port of ``k8s_operator_libs_tpu/parallel/fsdp.py`` for a SINGLE device:
meshes and sharding belong to the multi-GPU slice. The step is eager
PyTorch (``jax.jit`` has no counterpart the port needs): autograd through
the loss, whose attention runs in the flash kernels on the card.
:func:`make_train_step_from_loss` wraps any ``loss(params, tokens)`` (the
MoE family's :func:`..parallel.expert.moe_reference_loss`);
:func:`make_train_step` is it around the Llama :func:`causal_lm_loss`.

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


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in param_leaves(tree)))


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


def init_train_state(cfg: LlamaConfig, seed: int = 0,
                     optimizer: Optional[ClippedAdamW] = None,
                     device: DeviceLike = "cuda") -> TrainState:
    """Seeded parameters and zero moments on ``device``, step 0."""
    optimizer = optimizer or default_optimizer()
    params = init_params(cfg, seed=seed, device=device)
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
                              grad_accum: int = 1) -> Callable:
    """``train_step(state, tokens) -> (state, metrics)`` around any
    ``loss_fn(params, tokens)``, with metrics ``{loss, grad_norm, step}``
    (``grad_norm`` before clipping).

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
        g_norm = global_norm(grads)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     g_norm)
        step = state.step + 1
        return (TrainState(params=state.params, opt_state=opt_state,
                           step=step),
                {"loss": loss, "grad_norm": g_norm, "step": step})

    return train_step


def make_train_step(cfg: LlamaConfig,
                    optimizer: Optional[ClippedAdamW] = None,
                    grad_accum: int = 1) -> Callable:
    """:func:`make_train_step_from_loss` around the Llama causal-LM
    loss."""
    return make_train_step_from_loss(
        lambda params, tokens: causal_lm_loss(params, tokens, cfg),
        optimizer, grad_accum)
