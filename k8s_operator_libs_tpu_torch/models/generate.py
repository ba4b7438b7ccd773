"""Autoregressive decoding over a contiguous KV cache.

Port of the JAX package's ``models/generate.py``: one device
(:func:`generate`) and tensor-parallel over a mesh's ``tensor`` axis
(:func:`make_tp_generate`). The contiguous :func:`generate` is the plain
oracle the paged paths are held against. ``lax.scan`` becomes a Python
loop; sampling draws from an explicit ``torch.Generator``, which cannot
match ``jax.random``, so only greedy decoding compares token by token.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel import comm
from ..parallel.mesh import Mesh
from ..utils.device import DeviceLike, resolve_device
from .llama import LlamaConfig, identity, rms_norm, rope, swiglu
from .llama import matmul as _plain_matmul

Params = Dict[str, Any]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, max_len, KV, Dh]
    v: torch.Tensor  # [L, B, max_len, KV, Dh]
    length: int      # valid prefix length (host int)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda") -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=0)


def _attend_cached(cfg: LlamaConfig, q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, q_pos: torch.Tensor
                   ) -> torch.Tensor:
    """q [B, Tq, H, Dh] against cache [B, max_len, KV, Dh]; key visible
    iff its position <= the query's. Grouped GQA; scores in fp32."""
    B, Tq, H, Dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q_g = q.reshape(B, Tq, KV, G, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q_g.float(),
                          k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]                 # [Tq, max_len]
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, Tq, H, Dh)


@torch.no_grad()
def _forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                    cfg: LlamaConfig, matmul=None, ffn=None,
                    lm_head_fn=None, tp_out=identity
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Forward [B, T] starting at ``cache.length``; appends K/V to the
    cache in place. Prefill (T = prompt length) and decode (T = 1).
    Every contiguous-cache variant shares it through the reference's
    three hooks: ``matmul(x, layer, name)`` (default ``x @ layer[name]``;
    int8 weights swap in ``quant._qmat``), ``ffn(h, layer)`` (the MLP)
    and ``lm_head_fn(x, params)``. Head counts come from the product
    shapes, so ``{"q", "s"}`` weight dicts and a tensor-parallel rank's
    column and row slices work unchanged. ``tp_out`` is the reference's
    ``tp_axis`` psum: it sums the attention output after ``wo`` and the
    MLP's after ``w_down`` over the tensor group, restoring the whole
    residual stream on every rank (the identity on one rank)."""
    mm = matmul or _plain_matmul
    lm = lm_head_fn or _plain_lm_head
    B, T = tokens.shape
    Dh = cfg.head_dim
    start = cache.length
    positions = torch.arange(start, start + T, device=tokens.device)
    pos_b = positions[None, :].expand(B, T)
    x = params["embed"][tokens.long()]
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        layer = layer_weights(blocks, i)
        h = rms_norm(x, layer["attn_norm"])
        q = mm(h, layer, "wq")
        H = q.shape[-1] // Dh
        q = q.reshape(B, T, H, Dh)
        k = mm(h, layer, "wk")
        KV = k.shape[-1] // Dh
        k = k.reshape(B, T, KV, Dh)
        v = mm(h, layer, "wv").reshape(B, T, KV, Dh)
        q = rope(q, pos_b, cfg.rope_theta)
        k = rope(k, pos_b, cfg.rope_theta)
        cache.k[i, :, start:start + T] = k.to(cache.k.dtype)
        cache.v[i, :, start:start + T] = v.to(cache.v.dtype)
        attn = _attend_cached(cfg, q, cache.k[i], cache.v[i], positions)
        x = x + tp_out(mm(attn.reshape(B, T, H * Dh), layer, "wo"))
        h2 = rms_norm(x, layer["mlp_norm"])
        x = x + tp_out(ffn(h2, layer) if ffn is not None
                       else swiglu(h2, layer, mm))
    x = rms_norm(x, params["final_norm"])
    logits = lm(x, params).float()
    return logits, dataclasses.replace(cache, length=start + T)


def _plain_lm_head(x: torch.Tensor, params: Params) -> torch.Tensor:
    return x @ params["lm_head"]


def layer_weights(blocks: Params, i: int) -> Params:
    """Layer ``i`` of the stacked blocks; a quantized ``{"q", "s"}`` mat
    yields ``{"q": q[i], "s": s[i]}``."""
    return {name: ({k: t[i] for k, t in w.items()} if isinstance(w, dict)
                   else w[i]) for name, w in blocks.items()}


def filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k / nucleus filtering on [B, V] logits; dropped entries become
    -inf. Both filters cut at a VALUE threshold with a strict ``<``, so
    every logit equal to the k-th value (or to the nucleus boundary
    value) survives — the reference's documented tie rule."""
    if top_k is None and top_p is None:
        return logits
    desc = torch.sort(logits, dim=-1, descending=True).values
    ninf = torch.tensor(float("-inf"), device=logits.device,
                        dtype=logits.dtype)
    if top_k is not None:
        kth = desc[:, top_k - 1:top_k]
        logits = torch.where(logits < kth, ninf, logits)
        rank = torch.arange(desc.shape[-1], device=logits.device)
        desc = torch.where(rank < top_k, desc, ninf)
    if top_p is not None:
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token iff the mass BEFORE it is < p
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, desc, -ninf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, ninf, logits)
    return logits


def scan_decode(forward_fn, params: Params, prompt: torch.Tensor, cache,
                last_logits: torch.Tensor, max_new_tokens: int,
                temperature: float,
                generator: Optional[torch.Generator] = None,
                top_k: Optional[int] = None,
                top_p: Optional[float] = None) -> torch.Tensor:
    """The decode tail every cache layout shares: sample the first token
    from the prefill's last logits, then ``max_new_tokens - 1``
    single-token ``forward_fn(params, tok[:, None], cache)`` steps.
    Sampling order: temperature, then top-k/top-p, then a categorical
    draw. ``argmax`` keeps the first maximum on ties."""
    def sample(logits_last):
        if temperature == 0.0:
            return torch.argmax(logits_last, dim=-1)
        scaled = filter_logits(logits_last / temperature, top_k, top_p)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    tok = sample(last_logits)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_fn(params, tok[:, None], cache)
        tok = sample(logits[:, -1])
        out.append(tok)
    generated = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, generated], dim=1)


def _decode_loop(forward_fn, params: Params, prompt: torch.Tensor,
                 cache: KVCache, max_new_tokens: int, temperature: float,
                 generator: Optional[torch.Generator] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """Prefill + :func:`scan_decode` for the contiguous cache (one device
    and tensor-parallel: only the cache's heads and the sums differ)."""
    logits, cache = forward_fn(params, prompt, cache)
    return scan_decode(forward_fn, params, prompt, cache, logits[:, -1],
                       max_new_tokens, temperature, generator, top_k=top_k,
                       top_p=top_p)


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, cfg: LlamaConfig,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None,
             top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled decoding on the parameters'
    device. prompt [B, Tp] -> [B, Tp + max_new_tokens]."""
    device = params["embed"].device
    prompt = prompt.to(device)
    B, Tp = prompt.shape
    cache = init_cache(cfg, B, Tp + max_new_tokens, device=device)
    return _decode_loop(partial(_forward_cached, cfg=cfg), params, prompt,
                        cache, max_new_tokens, temperature, generator,
                        top_k=top_k, top_p=top_p)


def tp_generate_param_specs() -> Params:
    """The specs of tensor-parallel decode (``parallel/mesh.py``'s
    PartitionSpec tuples): Megatron column-split wq/wk/wv/w_gate/w_up,
    row-split wo/w_down; embed, the norms and lm_head replicated (every
    rank samples from the whole logits)."""
    col, row = (None, None, "tensor"), (None, "tensor", None)
    return {"embed": (None, None),
            "blocks": {"attn_norm": (None, None), "wq": col, "wk": col,
                       "wv": col, "wo": row, "mlp_norm": (None, None),
                       "w_gate": col, "w_up": col, "w_down": row},
            "final_norm": (None,), "lm_head": (None, None)}


def make_tp_generate(cfg: LlamaConfig, mesh: Mesh, max_new_tokens: int = 32,
                     temperature: float = 0.0):
    """Tensor-parallel ``generate(params, prompt, generator=None) ->
    tokens`` on every rank of ``mesh``'s ``tensor`` axis. ``params`` are
    the rank's slices by :func:`tp_generate_param_specs`
    (``parallel/mesh.py:shard`` of each whole leaf): its H/tp heads and
    d_ff/tp FFN columns, and a KV cache of KV/tp heads, so each rank
    streams 1/tp of the blocks' weights and of the cache per step. Two
    sums per block over the tensor group (``comm.psum``) give every rank
    the whole residual stream, hence the same logits and tokens; a
    sampled decode needs the same seeded ``generator`` on every rank."""
    tp = mesh.size("tensor")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads {cfg.n_heads}/kv {cfg.n_kv_heads} not "
                         f"divisible by {tp}-way tensor parallelism")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by {tp}")
    local_cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp)
    forward = partial(_forward_cached, cfg=cfg,
                      tp_out=partial(comm.psum, group=mesh.groups["tensor"]))

    @torch.no_grad()
    def generate_fn(params: Params, prompt: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        device = params["embed"].device
        prompt = prompt.to(device)
        B, Tp = prompt.shape
        cache = init_cache(local_cfg, B, Tp + max_new_tokens, device=device)
        return _decode_loop(forward, params, prompt, cache, max_new_tokens,
                            temperature, generator)

    return generate_fn
