"""Weight-only int8 quantization for the decode path.

Port of the JAX package's ``models/quant.py``. For each 2-D weight
slab ``w[in, out]`` (stacked ``[L, in, out]`` for the blocks) the scale is
``s[out] = max(|w[:, out]|) / 127`` and ``q = round(w / s)`` in int8.
Per-output-channel scales commute with the contraction, so the dequant is
one row-scale after the product: ``x @ w ~= (x @ q) * s``. Embeddings and
norms stay in the float dtype.

The dtype sequence is the reference's, so the int8 tensors and the scales
are bit-identical to JAX's: with a bf16 tree ``max|w| / 127`` and
``w / s`` are computed in bf16, rounded half to even, clipped to +-127 and
cast; ``s`` becomes fp32 only at the end. :func:`_qmat` casts ``q`` to the
activation dtype for the product and multiplies by ``s`` in that dtype
after it. Eager PyTorch materializes that cast (the reference's XLA fuses
it into the dot's operand read), so an int8 product here moves more bytes
than a bf16 one; a kernel that dequantizes in its operand load is later
work.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch

from .generate import _forward_cached, init_cache, scan_decode
from .llama import LlamaConfig, param_leaves
from .paged import (DEFAULT_BLOCK_SIZE, _forward_paged,
                    _paged_generate_impl)

Params = Dict[str, Any]

# block weights that get quantized (2-D per layer, stacked on L)
_BLOCK_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_mat(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., in, out] -> (q int8 [..., in, out], s fp32 [..., out]),
    computed in w's dtype. A stacked ``[L, in, out]`` slab goes one layer
    at a time: the columns are per layer, so the bits are the same and
    the temporaries stay one layer in size."""
    if w.dim() == 3:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            q[i], s[i] = _quantize_mat(w[i])
        return q, s
    s = torch.amax(torch.abs(w), dim=-2) / 127.0          # [..., out]
    s = torch.clamp_min(s, 1e-12)                          # all-zero columns
    q = torch.clamp(torch.round(w / s[..., None, :]), -127, 127)
    return q.to(torch.int8), s.float()


def quantize_params(params: Params) -> Params:
    """Float parameters -> int8 tree: each quantized mat becomes
    ``{"q": int8, "s": scale}``; the embedding and norms are kept (shared
    with the float tree, not copied)."""
    blocks = dict(params["blocks"])
    for name in _BLOCK_MATS:
        q, s = _quantize_mat(blocks[name])
        blocks[name] = {"q": q, "s": s}
    lm_q, lm_s = _quantize_mat(params["lm_head"])
    return {**params, "blocks": blocks, "lm_head": {"q": lm_q, "s": lm_s}}


def dequantize_params(params: Params) -> Params:
    """The inverse transform up to rounding (for test bounds): each mat
    comes back as ``q * s`` in the scale's dtype, fp32."""
    blocks = dict(params["blocks"])
    for name in _BLOCK_MATS:
        qs = blocks[name]
        blocks[name] = qs["q"].to(qs["s"].dtype) * qs["s"][..., None, :]
    lm = params["lm_head"]
    return {**params, "blocks": blocks,
            "lm_head": lm["q"].to(lm["s"].dtype) * lm["s"][..., None, :]}


def _qmat(x: torch.Tensor, qs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x @ w for a quantized mat: the product over q cast to x's dtype,
    then one row-scale by s in x's dtype."""
    y = x @ qs["q"].to(x.dtype)
    return y * qs["s"].to(x.dtype)


def quantized_size_bytes(params: Params) -> int:
    """Total bytes of the parameters as stored, float or quantized."""
    return sum(p.numel() * p.element_size() for p in param_leaves(params))


def stream_bytes(params: Params) -> int:
    """Bytes a decode step streams: every leaf except the embedding table,
    whose per-token row gather reads B rows, not the table. Works on float
    and quantized trees alike."""
    embed = params["embed"]
    return quantized_size_bytes(params) - embed.numel() * embed.element_size()


def expected_speedup(params: Params, qparams: Params,
                     kv_bytes_per_seq: float = 0.0,
                     batch: int = 1) -> float:
    """The bytes-per-token ratio float/int8, the ceiling of the int8 decode
    speedup when both paths are bound by weight streaming:
    ``(stream_bytes(f) + B kv) / (stream_bytes(q) + B kv)``. The KV term is
    the same on both sides (weight-only quantization)."""
    kv = float(batch) * float(kv_bytes_per_seq)
    return (stream_bytes(params) + kv) / (stream_bytes(qparams) + kv)


def _qmatmul(x: torch.Tensor, layer: Params, name: str) -> torch.Tensor:
    return _qmat(x, layer[name])


def _qlm_head(x: torch.Tensor, params: Params) -> torch.Tensor:
    return _qmat(x, params["lm_head"])


def _forward_quant(params: Params, tokens: torch.Tensor, cache,
                   cfg: LlamaConfig):
    """:func:`~.generate._forward_cached` with :func:`_qmat` in every
    quantized product."""
    return _forward_cached(params, tokens, cache, cfg, matmul=_qmatmul,
                           lm_head_fn=_qlm_head)


def _forward_paged_quant(params: Params, tokens: torch.Tensor, cache,
                         cfg: LlamaConfig, decode_attn=None):
    """:func:`~.paged._forward_paged` with :func:`_qmat` in every
    quantized product: the forward of the paged + int8 serving
    configuration and of the batcher's self-int8 draft."""
    return _forward_paged(params, tokens, cache, cfg, matmul=_qmatmul,
                          lm_head_fn=_qlm_head, decode_attn=decode_attn)


@torch.no_grad()
def paged_quantized_generate(params: Params, prompt: torch.Tensor,
                             cfg: LlamaConfig, max_new_tokens: int = 32,
                             temperature: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             prompt_lengths: Optional[torch.Tensor] = None,
                             block_size: Optional[int] = None,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             kv_int8: bool = False,
                             decode_attn=None) -> torch.Tensor:
    """Greedy/sampled decode over the paged cache with int8 WEIGHTS (a
    :func:`quantize_params` tree); ``kv_int8=True`` adds int8 KV pools,
    the reference's full int8 serving configuration, whose decode steps
    run A-K5 on the card. ``decode_attn`` as in
    :func:`~.paged.paged_generate`."""
    return _paged_generate_impl(
        partial(_forward_paged_quant, decode_attn=decode_attn), params,
        prompt, cfg, max_new_tokens, temperature, generator, prompt_lengths,
        block_size if block_size is not None else DEFAULT_BLOCK_SIZE,
        top_k, top_p, kv_int8)


@torch.no_grad()
def quantized_generate(params: Params, prompt: torch.Tensor,
                       cfg: LlamaConfig, max_new_tokens: int = 32,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy/sampled decode over int8 weights on the contiguous cache;
    the loop of :func:`~.generate.generate`."""
    device = params["embed"].device
    prompt = prompt.to(device)
    B, Tp = prompt.shape
    cache = init_cache(cfg, B, Tp + max_new_tokens, device=device)
    logits, cache = _forward_quant(params, prompt, cache, cfg)
    return scan_decode(partial(_forward_quant, cfg=cfg), params, prompt,
                       cache, logits[:, -1], max_new_tokens, temperature,
                       generator, top_k=top_k, top_p=top_p)
