"""Mixture-of-Experts Llama variant (Mixtral-style): the second model family.

Port of the JAX package's ``models/moe.py``: the dense SwiGLU MLP
becomes a top-k routed expert layer. Expert weights are STACKED ``[L, E,
...]`` beside the other per-layer weights; the router is fp32 ``[L, D,
E]``. :func:`moe_ffn` is the reference's dense "dropless" dispatch: every
expert runs on every token and the renormalized top-k gate zeroes the
rest, plus the Switch-style load-balance aux term.

Expert parallelism (:mod:`..parallel.expert`). ``experts_slice=(start,
count)`` with ``ep_group`` (the tensor axis's process group) computes only
the rank's contiguous experts on the replicated token stream and sums
their outputs over the group inside the layer (:func:`.comm.psum`), as
the reference's :104-141 does; the aux term stays partial (the caller
sums it). What ``shard_map``'s transpose adds there is written out with
:func:`.comm.replicate`: on ``h`` entering the local experts and on the
routing weights and ``mean_prob`` before the local experts' columns are
cut from them, so each rank's gradient of them is the sum over the
group. :func:`moe_ffn_a2a` is the capacity-bounded all-to-all dispatch
(:144-203), for tokens sharded over the group.

The expert products are plain ``torch.mm`` (cuBLAS on the card), one
expert at a time, each reading its ``[D, F]`` slab in place: no einsum
permutes or copies an expert weight. Gate and up are delivered in fp32
from the operands' dtype with no rounding in between, as the reference's
``preferred_element_type=jnp.float32`` products are (:func:`f32_product`).

The training :func:`forward` shares the Llama block's attention half
(:func:`.llama._qkv`, the flash kernels: A-K1 forward, A-K2/A-K3
backward on the card) and its remat split: under ``cfg.remat`` only the
flash call's out and lse are kept, the halves before and after it run
under ``torch.utils.checkpoint`` (the routed half returns ``(x, aux)``),
so the backward recomputes the fp32 gate/up products instead of saving
them. The decoding half (:func:`moe_paged_forward`,
:func:`moe_generate`) rides the ``ffn`` hooks of the contiguous and paged
forwards, and so the paged-decode kernel (A-K4) on the batcher.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import comm
from ..utils.device import DeviceLike, resolve_device
from .generate import _forward_cached, init_cache, scan_decode
from .llama import (LlamaConfig, Params, _default_attn, _init_dense, _qkv,
                    rms_norm)
from .paged import _forward_paged


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    router_aux_coef: float = 0.01

    @classmethod
    def tiny(cls, **overrides) -> "MoEConfig":
        base = cls(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=256, max_seq_len=256, remat=False,
                   n_experts=4, top_k=2)
        return dataclasses.replace(base, **overrides)


def init_params(cfg: MoEConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Seeded random parameters in the reference layout. Every stacked
    weight is drawn one (layer, expert) slab at a time into a
    preallocated ``cfg.dtype`` tensor, so the fp32 temporary never
    exceeds one ``[D, F]`` slab."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, H, KV, Dh, F, E = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                             cfg.n_experts)
    dt = cfg.dtype

    def stack(shape, fan_in, dtype=dt, experts=False):
        lead = (L, E) if experts else (L,)
        out = torch.empty((*lead, *shape), dtype=dtype, device=dev)
        for idx in itertools.product(*(range(n) for n in lead)):
            out[idx] = _init_dense(gen, shape, fan_in, dtype, dev)
        return out

    return {
        "embed": _init_dense(gen, (cfg.vocab_size, D), D, dt, dev),
        "blocks": {
            "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "wq": stack((D, H * Dh), D),
            "wk": stack((D, KV * Dh), D),
            "wv": stack((D, KV * Dh), D),
            "wo": stack((H * Dh, D), H * Dh),
            "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            # router in fp32 for a stable top-k
            "router": stack((D, E), D, dtype=torch.float32),
            "w_gate": stack((D, F), D, experts=True),
            "w_up": stack((D, F), D, experts=True),
            "w_down": stack((F, D), F, experts=True),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": _init_dense(gen, (D, cfg.vocab_size), D, dt, dev),
    }


# ---------------------------------------------------------------- ops

class _F32Product(torch.autograd.Function):
    """``a @ b`` with an fp32 result and no rounding to the operands'
    dtype in between (the reference's ``preferred_element_type=
    jnp.float32``). bf16/fp16 on the card: cuBLAS's fp32-output product
    (``torch.mm(..., out_dtype=torch.float32)``); elsewhere the operands
    upcast, whose exact products and fp32 sums are the same arithmetic.
    The backward rounds the fp32 cotangent to the operands' dtype before
    its two products, as a TPU's default-precision matmul pass rounds an
    fp32 operand to bf16; in fp32 it is the ordinary backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = g.to(a.dtype) @ b.t()
        if ctx.needs_input_grad[1]:
            db = a.t() @ g.to(b.dtype)
        return da, db


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [K, M] -> fp32 [N, M] (see :class:`_F32Product`)."""
    return _F32Product.apply(a, b)


def router_weights(h: torch.Tensor, router: torch.Tensor, top_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gate. h [..., D], router [D, E] -> (weights [..., E] with
    zeros off the top-k and the renormalized softmax mass on it, probs
    [..., E]). The reference's threshold rule: every expert whose prob is
    ``>=`` the k-th value is kept, so a tie admits more than ``top_k``."""
    probs = torch.softmax(h.float() @ router, dim=-1)
    thresh = torch.topk(probs.detach(), top_k, dim=-1).values[..., -1:]
    weights = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, probs


def _experts(h: torch.Tensor, weights: torch.Tensor,
             layer: Params) -> torch.Tensor:
    """Every expert on every token, combined by the gate ``weights``.
    Per expert e: ``silu(h W_gate[e])`` and ``h W_up[e]`` in fp32, their
    product cast to h's dtype, times ``W_down[e]``; the outputs combined
    with the weights (cast to h's dtype) in fp32 and cast once, as the
    reference's combine einsum accumulates."""
    x = h.reshape(-1, h.shape[-1])
    w = weights.reshape(-1, weights.shape[-1]).to(h.dtype).float()
    out = None
    # unbind once per stack: its backward stacks the experts' gradients
    # once, where indexing each expert would add a zero-filled full-size
    # gradient per expert
    experts = zip(layer["w_gate"].unbind(0), layer["w_up"].unbind(0),
                  layer["w_down"].unbind(0))
    for e, (w_gate, w_up, w_down) in enumerate(experts):
        gate = torch.nn.functional.silu(f32_product(x, w_gate))
        up = f32_product(x, w_up)
        y = (gate * up).to(h.dtype) @ w_down
        term = w[:, e:e + 1] * y.float()
        out = term if out is None else out + term
    return out.to(h.dtype).reshape(h.shape)


def _local_experts(t: torch.Tensor, start: int, count: int,
                   group) -> torch.Tensor:
    """The local experts' columns of a routing tensor every rank computes
    whole (the gate weights, ``mean_prob``): replicated over the group
    first, so the gradient of the whole sums every rank's columns."""
    return comm.replicate(t, group).narrow(-1, start, count)


def moe_ffn(h: torch.Tensor, layer: Params, cfg: MoEConfig,
            experts_slice: Optional[Tuple[int, int]] = None,
            ep_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch expert layer: h [..., D] -> (out [..., D], aux []).
    aux is ``E * sum_e frac_e * mean_prob_e``; ``frac`` (from
    ``weights > 0``) carries no gradient, ``mean_prob`` does.

    ``experts_slice=(start, count)`` computes that contiguous expert range
    only (the layer's expert stacks hold it, or all E, which are then
    cut); with ``ep_group`` the partial outputs are summed over the group
    here, and aux covers the local experts only."""
    weights, probs = router_weights(h, layer["router"], cfg.top_k)
    lead = tuple(range(probs.dim() - 1))
    mean_prob = probs.mean(dim=lead)
    if experts_slice is not None:
        start, count = experts_slice
        if layer["w_gate"].shape[0] != count:
            layer = {k: layer[k].narrow(0, start, count)
                     for k in ("w_gate", "w_up", "w_down")}
        weights = _local_experts(weights, start, count, ep_group)
        mean_prob = _local_experts(mean_prob, start, count, ep_group)
        h = comm.replicate(h, ep_group)
    out = _experts(h, weights, layer)
    frac = (weights > 0).float().mean(dim=lead)
    aux = cfg.n_experts * torch.sum(frac * mean_prob)
    return comm.psum(out, ep_group), aux


def moe_ffn_a2a(h: torch.Tensor, layer: Params, cfg: MoEConfig, group,
                capacity: int, record: Optional[list] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded all-to-all dispatch (GShard/Switch): h [B/n, T,
    D] is this rank's batch shard, the expert stacks its E/n experts.
    Each token's routed experts take it in token order (a cumsum over G =
    B/n * T rows, row-major, as the reference's): the first ``capacity``
    tokens routed to an expert fill its buffer and the rest are dropped
    for it. The [G, E, C] one-hot dispatch packs the buffers [E, C, D],
    an all-to-all sends each expert's buffers to its rank, the local
    experts run on [E/n, n * C, D], the reverse all-to-all brings the
    outputs home and the gate-weighted one-hot combine puts them back in
    token order (accumulated in fp32, rounded once). Returns (out [B/n,
    T, D], aux): aux is the full-E term on the local shard (the caller
    averages it over the group). ``record`` gets the [G, E] masks of the
    routed and of the kept (token, expert) pairs of each call."""
    Bl, T, D = h.shape
    E = cfg.n_experts
    n = comm.size(group)
    El, C, G = E // n, capacity, Bl * T
    weights, probs = router_weights(h, layer["router"], cfg.top_k)
    w = weights.reshape(G, E)
    mask = w > 0
    # each token's place in its expert's buffer; past the capacity: dropped
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1            # [G, E]
    keep = mask & (pos < C)
    if record is not None:
        record.append((mask.detach(), keep.detach()))
    slots = torch.arange(C, device=h.device)
    dispatch = (keep[..., None] & (pos[..., None] == slots)
                ).to(h.dtype).reshape(G, E * C)
    # one token per buffer slot: the product's sums have one term
    xs = (dispatch.t() @ h.reshape(G, D)).reshape(n, El, C, D)
    # after the all-to-all, dim 0 is the source rank
    xs = comm.all_to_all(xs, group, 0, 0)
    xin = xs.transpose(0, 1).reshape(El, n * C, D)
    outs = []
    for x, w_gate, w_up, w_down in zip(xin.unbind(0),
                                       layer["w_gate"].unbind(0),
                                       layer["w_up"].unbind(0),
                                       layer["w_down"].unbind(0)):
        gate = torch.nn.functional.silu(f32_product(x, w_gate))
        outs.append((gate * f32_product(x, w_up)).to(h.dtype) @ w_down)
    out = torch.stack(outs).reshape(El, n, C, D).transpose(0, 1)
    out = comm.all_to_all(out.contiguous(), group, 0, 0).reshape(E * C, D)
    combine = dispatch * w.to(h.dtype).repeat_interleave(C, dim=1)
    y = f32_product(combine, out).to(h.dtype).reshape(Bl, T, D)
    frac = mask.float().mean(dim=0)
    mean_prob = probs.reshape(G, E).mean(dim=0)
    return y, cfg.n_experts * torch.sum(frac * mean_prob)


# ---------------------------------------------------------------- training

def _post(cfg: MoEConfig, x: torch.Tensor, attn: torch.Tensor, wo,
          mlp_norm, router, w_gate, w_up, w_down, ffn: Callable
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block after attention: O-projection and residual, then the
    routed expert FFN ``ffn(h, layer) -> (out, aux)`` and its residual.
    Returns (x, aux)."""
    B, T, _ = x.shape
    x = x + attn.reshape(B, T, -1) @ wo
    out, aux = ffn(rms_norm(x, mlp_norm),
                   {"router": router, "w_gate": w_gate, "w_up": w_up,
                    "w_down": w_down})
    return x + out, aux


def moe_block(x: torch.Tensor, layer: Params, cfg: MoEConfig,
              positions: torch.Tensor, attn_fn: Optional[Callable] = None,
              experts_slice: Optional[Tuple[int, int]] = None,
              ep_group=None, ffn_fn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE decoder block (pre-norm attention + routed expert FFN),
    shared by :func:`forward` and the composed pipeline x expert path.
    ``experts_slice``/``ep_group`` as in :func:`moe_ffn`; ``ffn_fn(h,
    layer) -> (out, aux)`` replaces the expert layer (the all-to-all
    dispatch). Returns (x, aux)."""
    fn = attn_fn or _default_attn
    ffn = ffn_fn or partial(moe_ffn, cfg=cfg, experts_slice=experts_slice,
                            ep_group=ep_group)
    pre = (x, layer["attn_norm"], layer["wq"], layer["wk"], layer["wv"])
    post = (layer["wo"], layer["mlp_norm"], layer["router"],
            layer["w_gate"], layer["w_up"], layer["w_down"], ffn)
    if not cfg.remat:
        q, k, v = _qkv(cfg, *pre, positions)
        return _post(cfg, x, fn(q, k, v), *post)
    q, k, v = checkpoint(_qkv, cfg, *pre, positions, use_reentrant=False)
    attn = fn(q, k, v)
    return checkpoint(_post, cfg, x, attn, *post, use_reentrant=False)


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            attn_fn: Optional[Callable] = None,
            experts_slice: Optional[Tuple[int, int]] = None,
            ep_group=None, ffn_fn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, vocab] fp32, summed aux []),
    differentiable. ``attn_fn`` as in :func:`.llama.forward`; the expert
    arguments as in :func:`moe_block` (under expert parallelism the aux is
    the local experts' part)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = torch.nn.functional.embedding(tokens.long(), params["embed"])
    blocks = params["blocks"]
    names = list(blocks)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for weights in zip(*(blocks[n].unbind(0) for n in names)):
        x, aux = moe_block(x, dict(zip(names, weights)), cfg, positions,
                           attn_fn, experts_slice, ep_group, ffn_fn)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), aux_total


# ---------------------------------------------------------------- decoding

def _expert_ffn(cfg: MoEConfig):
    """The forwards' ``ffn`` hook: the routed FFN without its aux term
    (decode does not train, and eager PyTorch would still compute it)."""
    def ffn(h2, layer):
        weights, _ = router_weights(h2, layer["router"], cfg.top_k)
        return _experts(h2, weights, layer)
    return ffn


def _forward_cached_moe(params: Params, tokens: torch.Tensor, cache,
                        cfg: MoEConfig):
    """KV-cached MoE forward: :func:`.generate._forward_cached` with the
    routed FFN in place of the dense MLP. Dense dispatch streams every
    expert's weights once per step whatever the routing."""
    return _forward_cached(params, tokens, cache, cfg,
                           ffn=_expert_ffn(cfg))


def moe_paged_forward(params: Params, tokens: torch.Tensor, cache,
                      cfg: MoEConfig, decode_attn=None):
    """Paged-cache MoE forward: :func:`.paged._forward_paged` with the
    routed FFN hooked in, the batcher's ``forward=`` hook for the MoE
    family. ``decode_attn`` as in ``_forward_paged``."""
    return _forward_paged(params, tokens, cache, cfg, ffn=_expert_ffn(cfg),
                          decode_attn=decode_attn)


@torch.no_grad()
def moe_generate(params: Params, prompt: torch.Tensor, cfg: MoEConfig,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy/sampled KV-cached decoding for the MoE family: the loop and
    sampling order of :func:`.generate.generate`. prompt [B, Tp] ->
    [B, Tp + max_new_tokens]."""
    device = params["embed"].device
    prompt = prompt.to(device)
    B, Tp = prompt.shape
    cache = init_cache(cfg, B, Tp + max_new_tokens, device=device)
    logits, cache = _forward_cached_moe(params, prompt, cache, cfg)
    return scan_decode(partial(_forward_cached_moe, cfg=cfg), params, prompt,
                       cache, logits[:, -1], max_new_tokens, temperature,
                       generator, top_k=top_k, top_p=top_p)
