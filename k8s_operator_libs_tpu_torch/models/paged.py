"""Paged (block) KV cache for the decode path.

Port of the JAX package's ``models/paged.py``. One shared block pool
per layer ``[L, NB, BS, KV, Dh]``, a block table ``[B, MB]`` int32 mapping
each sequence's logical blocks to pool blocks, and per-sequence lengths
``[B]`` int32. Block planning is a host-side numpy plan, identical to the
reference's, including the SCRATCH block at pool index ``NB - 1`` that
backs unused table slots and that no live read ever sees.

Where the reference donated the pools to a jitted call and got new ones
back, this port updates them IN PLACE (``index_put_``): the returned
cache holds the same pool tensors. Decode steps (one query token) go
through the paged-decode kernel (:mod:`..ops.paged_attention`); prefill
gathers each sequence's view and attends with plain PyTorch.

The KV migration payload (``export_slot_kv`` ... ``kv_payload_nbytes``) is
wire-identical to the reference: the same version, keys, dtype strings
and bytes, so a payload exported by either package is adopted by the
other.
"""

from __future__ import annotations

import base64
import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import (dtype_name, tensor_bytes, tensor_from_bytes,
                       tensor_from_numpy)
from ..ops.paged_attention import paged_decode
from ..utils.device import DeviceLike, resolve_device
from .generate import _plain_lm_head, layer_weights, scan_decode
from .llama import LlamaConfig, rms_norm, rope, swiglu
from .llama import matmul as _plain_matmul

Params = Dict[str, Any]

DEFAULT_BLOCK_SIZE = 16


@dataclasses.dataclass
class PagedKVCache:
    """``k_scale``/``v_scale`` present (int8 mode): the pools hold per-row
    symmetric int8 with one fp32 scale per (block row, KV head)."""

    k: torch.Tensor        # [L, NB, BS, KV, Dh] shared block pool
    v: torch.Tensor        # [L, NB, BS, KV, Dh]
    table: torch.Tensor    # [B, MB] int32 — pool block id per logical block
    lengths: torch.Tensor  # [B] int32 — valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None   # [L, NB, BS, KV] fp32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def plan_blocks(seq_capacities: Sequence[int],
                block_size: int = DEFAULT_BLOCK_SIZE
                ) -> Tuple[np.ndarray, int]:
    """Host-side allocation plan: per-sequence capacities -> (block table
    [B, MB], pool size NB). Each sequence gets ``ceil(cap / block_size)``
    blocks; unused table slots route to the scratch block at NB - 1."""
    n_blocks = [max(1, -(-int(c) // block_size)) for c in seq_capacities]
    mb = max(n_blocks)
    nxt = 0
    spans = []
    for n in n_blocks:
        spans.append((nxt, n))
        nxt += n
    scratch = nxt
    table = np.full((len(seq_capacities), mb), scratch, dtype=np.int32)
    for b, (start, n) in enumerate(spans):
        table[b, :n] = np.arange(start, start + n, dtype=np.int32)
    return table, scratch + 1


def init_paged_cache(cfg: LlamaConfig, seq_capacities: Sequence[int],
                     block_size: int = DEFAULT_BLOCK_SIZE,
                     dtype: Optional[torch.dtype] = None,
                     kv_int8: bool = False,
                     device: DeviceLike = "cuda") -> PagedKVCache:
    """Pools sized to the SUM of per-sequence capacities (plus scratch).
    ``kv_int8=True`` stores per-row symmetric int8 with fp32 scales."""
    dev = resolve_device(device)
    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dtype = dtype or cfg.dtype
    table, nb = plan_blocks(seq_capacities, block_size)
    shape = (L, nb, block_size, KV, Dh)
    table_t = torch.as_tensor(table, device=dev)
    lengths = torch.zeros((len(seq_capacities),), dtype=torch.int32,
                          device=dev)
    if kv_int8:
        sshape = (L, nb, block_size, KV)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            table=table_t, lengths=lengths,
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev),
                        table=table_t, lengths=lengths)


def _quantize_rows(vals: torch.Tensor):
    """[B, T, KV, Dh] -> (int8 rows, fp32 scales [B, T, KV]): symmetric
    per-(token, head) row quantization, round half to even like jnp."""
    f = vals.float()
    s = torch.amax(torch.abs(f), dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(f / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _paged_write(pool: torch.Tensor, table: torch.Tensor,
                 lengths: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scatter new rows into one layer's pool IN PLACE. pool [NB, BS, ...],
    vals [B, T, ...] written at logical positions ``lengths[b] + t``.

    The reference's scatter DROPS a write whose logical block lies past
    the table row; torch indexing would assert on the device instead. So
    the mask is explicit: such writes are routed to the scratch block
    (pool index NB - 1, reserved by every pool of the port), which no live
    read sees — the same observable result, with no host sync."""
    B, T = vals.shape[0], vals.shape[1]
    nb, bs = pool.shape[0], pool.shape[1]
    mb = table.shape[1]
    pos = (lengths.long()[:, None]
           + torch.arange(T, device=pool.device)[None, :])       # [B, T]
    logical = pos // bs
    in_row = logical < mb
    blocks = torch.gather(table.long(), 1, logical.clamp(max=mb - 1))
    blocks = torch.where(in_row, blocks, nb - 1)
    pool[blocks, pos % bs] = vals.to(pool.dtype)
    return pool


def _paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each sequence's blocks as a contiguous view [B, MB*BS, ...]."""
    B, mb = table.shape
    bs = pool.shape[1]
    return pool[table.long()].reshape(B, mb * bs, *pool.shape[2:])


def _attend_paged(cfg: LlamaConfig, q: torch.Tensor, k_view: torch.Tensor,
                  v_view: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """q [B, Tq, H, Dh] over gathered views [B, cap, KV, Dh]; q_pos [B, Tq]
    absolute positions. Key visible iff k_pos <= q_pos[b, t]. Grouped GQA
    (the cache is never repeated); scores in fp32."""
    B, Tq, H, Dh = q.shape
    KV = k_view.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q_g = q.reshape(B, Tq, KV, G, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q_g.float(),
                          k_view.float()) * scale
    cap = k_view.shape[1]
    k_pos = torch.arange(cap, device=q.device)
    mask = k_pos[None, None, :] <= q_pos.long()[:, :, None]   # [B, Tq, cap]
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_view.to(q.dtype))
    return out.reshape(B, Tq, H, Dh)


def _dequant_view(pool_l, scale_l, table, dtype):
    view = _paged_view(pool_l, table).float()
    return (view * _paged_view(scale_l, table)[..., None]).to(dtype)


@torch.no_grad()
def _forward_paged(params: Params, tokens: torch.Tensor,
                   cache: PagedKVCache, cfg: LlamaConfig, matmul=None,
                   ffn=None, lm_head_fn=None,
                   decode_attn=None) -> Tuple[torch.Tensor, PagedKVCache]:
    """Forward [B, T] starting at per-sequence ``cache.lengths``; writes
    this step's K/V into the pools (in place) BEFORE attending, so the
    new token sees itself. A Python loop over the stacked layers; the
    reference's optimization-barrier weight prefetch is XLA scheduling
    with no semantics and has no counterpart here yet. Every decode step
    takes the kernel on the card: the reference's size crossover for its
    kernel was a TPU measurement and is not carried over.

    The reference's hooks: ``matmul(x, layer, name)``, ``ffn(h, layer)``
    and ``lm_head_fn(x, params)`` (see :func:`~.generate._forward_cached`;
    the int8-weight forward of :mod:`.quant` rides them). Head counts
    come from the product shapes. ``decode_attn`` overrides the
    single-token attention (default
    :func:`~..ops.paged_attention.paged_decode`: the kernel on CUDA, its
    plain version on the CPU); ``chip_smoke.py`` passes the plain version
    to hold the kernel against it on the card."""
    mm = matmul or _plain_matmul
    lm = lm_head_fn or _plain_lm_head
    attn_fn = decode_attn or paged_decode
    quant = cache.quantized
    B, T = tokens.shape
    Dh = cfg.head_dim
    table, lengths = cache.table, cache.lengths
    pos = lengths[:, None] + torch.arange(T, dtype=torch.int32,
                                          device=tokens.device)[None, :]
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
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        k_pool, v_pool = cache.k[i], cache.v[i]
        ks = vs = None
        if quant:
            ks, vs = cache.k_scale[i], cache.v_scale[i]
            kq, ks_rows = _quantize_rows(k)
            vq, vs_rows = _quantize_rows(v)
            _paged_write(k_pool, table, lengths, kq)
            _paged_write(v_pool, table, lengths, vq)
            _paged_write(ks, table, lengths, ks_rows)
            _paged_write(vs, table, lengths, vs_rows)
        else:
            _paged_write(k_pool, table, lengths, k)
            _paged_write(v_pool, table, lengths, v)
        if T == 1:
            # decode: walk the block table (no gathered copy on the card)
            attn = attn_fn(q, k_pool, v_pool, table, lengths, ks, vs)
        else:
            # prefill and speculative verify: gather view + masked
            # attention; int8 dequantizes the gathered view
            if quant:
                k_view = _dequant_view(k_pool, ks, table, q.dtype)
                v_view = _dequant_view(v_pool, vs, table, q.dtype)
            else:
                k_view = _paged_view(k_pool, table)
                v_view = _paged_view(v_pool, table)
            attn = _attend_paged(cfg, q, k_view, v_view, pos)
        x = x + mm(attn.reshape(B, T, H * Dh), layer, "wo")
        h2 = rms_norm(x, layer["mlp_norm"])
        x = x + (ffn(h2, layer) if ffn is not None
                 else swiglu(h2, layer, mm))
    x = rms_norm(x, params["final_norm"])
    logits = lm(x, params).float()
    new_cache = dataclasses.replace(cache, lengths=lengths + T)
    return logits, new_cache


def _paged_generate_impl(forward, params: Params, prompt: torch.Tensor,
                         cfg: LlamaConfig, max_new_tokens: int,
                         temperature: float,
                         generator: Optional[torch.Generator],
                         prompt_lengths: Optional[torch.Tensor],
                         block_size: int, top_k: Optional[int],
                         top_p: Optional[float],
                         kv_int8: bool) -> torch.Tensor:
    """Shared body of :func:`paged_generate` and the int8-weight twin
    (:func:`~.quant.paged_quantized_generate`): ``forward(params, tokens,
    cache, cfg)`` is the paged forward pass, :func:`_forward_paged` or a
    hooked variant of it."""
    device = params["embed"].device
    prompt = prompt.to(device)
    B, Tp = prompt.shape
    cache = init_paged_cache(cfg, [Tp + max_new_tokens] * B, block_size,
                             kv_int8=kv_int8, device=device)
    if prompt_lengths is None:
        prompt_lengths = torch.full((B,), Tp, dtype=torch.int32)
    prompt_lengths = prompt_lengths.to(device=device, dtype=torch.int32)
    fwd = partial(forward, cfg=cfg)
    logits, cache = fwd(params, prompt, cache)
    last = logits[torch.arange(B, device=device),
                  (prompt_lengths - 1).long()]
    # shorter sequences wrote padding rows past their length; rewind so
    # decode continues from each prompt's true end (replace() keeps the
    # int8 scale pools)
    cache = dataclasses.replace(cache, lengths=prompt_lengths)
    return scan_decode(fwd, params, prompt, cache, last, max_new_tokens,
                       temperature, generator, top_k=top_k, top_p=top_p)


@torch.no_grad()
def paged_generate(params: Params, prompt: torch.Tensor, cfg: LlamaConfig,
                   max_new_tokens: int = 32, temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   prompt_lengths: Optional[torch.Tensor] = None,
                   block_size: int = DEFAULT_BLOCK_SIZE,
                   top_k: Optional[int] = None,
                   top_p: Optional[float] = None,
                   kv_int8: bool = False,
                   decode_attn=None) -> torch.Tensor:
    """Greedy/sampled decode over the paged cache on the parameters'
    device. prompt [B, Tp] int (right-padded when ragged; pass
    ``prompt_lengths`` [B] so each sequence decodes from its own offset)
    -> [B, Tp + max_new_tokens]. ``kv_int8=True`` stores int8 pools."""
    return _paged_generate_impl(
        partial(_forward_paged, decode_attn=decode_attn), params, prompt,
        cfg, max_new_tokens, temperature, generator, prompt_lengths,
        block_size, top_k, top_p, kv_int8)


# ------------------------------------------------------- KV migration

KV_WIRE_VERSION = 1


class KVPayloadError(ValueError):
    """A KV wire payload cannot be produced or adopted here: version or
    geometry mismatch, unaligned start, or not enough free pages."""


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return tensor_from_numpy(x, device)


def export_slot_kv(k_pool, v_pool, table_row, length: int, *,
                   start: int = 0, k_scale=None, v_scale=None) -> dict:
    """One sequence's used KV blocks as a versioned payload. Pools are
    ``[L, NB, BS, KV, Dh]``; ``table_row`` ``[MB]``; ``length`` the
    absolute valid length; ``start`` the aligned shared-prefix length
    (shared blocks are not exported). Arrays come back as CPU tensors."""
    bs = int(k_pool.shape[2])
    if start % bs:
        raise KVPayloadError(f"start {start} not aligned to block size "
                             f"{bs}")
    first = start // bs
    n = max(0, -(-int(length) // bs) - first)
    row = np.asarray(table_row, np.int32)
    if first + n > len(row):
        raise KVPayloadError(f"length {length} spans {first + n} blocks "
                             f"but the table row holds {len(row)}")
    blocks = torch.as_tensor(row[first:first + n], dtype=torch.long,
                             device=k_pool.device)
    k_b = k_pool.index_select(1, blocks).cpu()
    payload = {
        "version": KV_WIRE_VERSION,
        "block_size": bs,
        "start": int(start),
        "length": int(length),
        "quantized": k_scale is not None,
        "dtype": dtype_name(k_b.dtype),
        "k": k_b,
        "v": v_pool.index_select(1, blocks).cpu(),
    }
    if k_scale is not None:
        payload["k_scale"] = k_scale.index_select(1, blocks).cpu()
        payload["v_scale"] = v_scale.index_select(1, blocks).cpu()
    return payload


def import_slot_kv(k_pool, v_pool, table_row, payload: dict, *,
                   start: int = 0, k_scale=None, v_scale=None):
    """Restore an :func:`export_slot_kv` payload into the blocks behind
    ``table_row``, IN PLACE. Returns ``(k_pool, v_pool, k_scale, v_scale,
    length)``. Raises :class:`KVPayloadError` on any mismatch the pool
    cannot absorb: wire version, block size, start, quantization mode,
    pool dtype, or a table row too short for the payload."""
    version = payload.get("version")
    if version != KV_WIRE_VERSION:
        raise KVPayloadError(f"payload wire version {version!r}; this "
                             f"replica speaks {KV_WIRE_VERSION}")
    bs = int(k_pool.shape[2])
    if int(payload["block_size"]) != bs:
        raise KVPayloadError(f"payload block size {payload['block_size']}"
                             f" != pool block size {bs}")
    if int(payload["start"]) != int(start):
        raise KVPayloadError(f"payload start {payload['start']} != this "
                             f"replica's aligned prefix {start}")
    quant = k_scale is not None
    if bool(payload["quantized"]) != quant:
        raise KVPayloadError(
            f"payload is {'int8' if payload['quantized'] else 'plain'} "
            f"but this pool is {'int8' if quant else 'plain'}")
    if str(payload["dtype"]) != dtype_name(k_pool.dtype):
        raise KVPayloadError(f"payload dtype {payload['dtype']} != pool "
                             f"dtype {dtype_name(k_pool.dtype)}")
    dev = k_pool.device
    k_new = _as_tensor(payload["k"], dev)
    n = k_new.shape[1]
    first = int(start) // bs
    row = np.asarray(table_row, np.int32)
    if first + n > len(row):
        raise KVPayloadError(f"payload spans {n} blocks past position "
                             f"{start} but the slot's table row holds "
                             f"{len(row) - first} (no free pages)")
    blocks = torch.as_tensor(row[first:first + n], dtype=torch.long,
                             device=dev)
    k_pool.index_copy_(1, blocks, k_new)
    v_pool.index_copy_(1, blocks, _as_tensor(payload["v"], dev))
    if quant:
        k_scale.index_copy_(1, blocks, _as_tensor(payload["k_scale"], dev))
        v_scale.index_copy_(1, blocks, _as_tensor(payload["v_scale"], dev))
    return k_pool, v_pool, k_scale, v_scale, int(payload["length"])


_ARRAY_KEYS = ("k", "v", "k_scale", "v_scale")


def _wire_dtype(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return dtype_name(arr.dtype)
    return str(np.asarray(arr).dtype)


def _raw(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        return tensor_bytes(arr)
    return np.asarray(arr).tobytes()


def encode_kv_payload(payload: dict) -> dict:
    """JSON-safe wire form: each array becomes ``{"shape", "dtype",
    "b64"}`` (raw little-endian bytes, base64) — the reference's format."""
    out = {key: val for key, val in payload.items()
           if key not in _ARRAY_KEYS}
    for key in _ARRAY_KEYS:
        arr = payload.get(key)
        if arr is None:
            continue
        out[key] = {"shape": list(arr.shape), "dtype": _wire_dtype(arr),
                    "b64": base64.b64encode(_raw(arr)).decode()}
    return out


def decode_kv_payload(obj: dict) -> dict:
    """The inverse of :func:`encode_kv_payload`; arrays become CPU
    tensors."""
    out = {key: val for key, val in obj.items()
           if key not in _ARRAY_KEYS}
    for key in _ARRAY_KEYS:
        enc = obj.get(key)
        if enc is None:
            continue
        out[key] = tensor_from_bytes(base64.b64decode(enc["b64"]),
                                     enc["dtype"], enc["shape"])
    return out


def kv_payload_nbytes(payload: dict) -> int:
    """Transfer size of the payload's array data."""
    total = 0
    for key in _ARRAY_KEYS:
        arr = payload.get(key)
        if arr is None:
            continue
        if isinstance(arr, torch.Tensor):
            total += arr.numel() * arr.element_size()
        else:
            total += np.asarray(arr).nbytes
    return total
