"""Operations and bytes a piece of work needs, from its shapes, and the
chip's peaks: the arithmetic behind every roofline and MFU metric.

Counts are of what the model's work needs, whatever an implementation
does: a decode step counts the ``top_k`` experts each token is routed to,
not every expert a dense dispatch runs; attention counts the (query, key)
pairs a causal mask leaves visible; each input byte is read once and each
output byte written once. A least time is the larger of operations over
the peak rate and bytes over the peak bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from ..models import Dims, leaf_specs

PEAKS = Path(__file__).with_name("peaks.json")
_BYTES = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> Dict[str, float]:
    table = json.loads(PEAKS.read_text())
    if device_name not in table:
        raise KeyError(f"no published peaks for {device_name!r}")
    return table[device_name]


def least_time(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    return max(flops / peak["bf16_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])


def causal_pairs(T: int) -> int:
    """Visible (query, key) pairs of one causal sequence of T."""
    return T * (T + 1) // 2


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ------------------------------------------------------------- training

def matmul_params(d: Dims) -> int:
    """Every parameter but the embedding table (the table is a lookup)."""
    total = 0
    for name, shape, _, _ in leaf_specs(d):
        n = _numel(shape)
        total += n * d.n_layers if name.startswith("blocks.") else n
    return total - d.vocab * d.d_model


def train_step_flops(d: Dims, batch: int, seq: int) -> float:
    """Model operations of one dense training step: 6 per matmul
    parameter per token (forward and backward), plus attention's 12 per
    visible pair per head dimension; remat's recompute not counted."""
    tokens = batch * seq
    attn = (12 * d.n_layers * batch * d.n_heads * d.head_dim
            * causal_pairs(seq))
    return 6.0 * matmul_params(d) * tokens + attn


def flash_train_cost(d: Dims, batch: int, seq: int) -> Dict[str, float]:
    """Operations and bytes the three flash kernels need for one step of
    every layer: the forward's two products (4 per visible pair per head
    dimension) and the backward's five (S recomputed, dP, dV, dQ, dK: 10).
    Bytes: q, k, v, out, lse read or written once by the forward; q, k,
    v, out, dout, lse read and dq, dk, dv written once by the backward."""
    pairs = batch * d.n_heads * d.head_dim * causal_pairs(seq)
    q = batch * seq * d.n_heads * d.head_dim * 2
    kv = batch * seq * d.n_kv_heads * d.head_dim * 2
    lse = batch * seq * d.n_heads * 4
    fwd_bytes = q + 2 * kv + q + lse
    bwd_bytes = (q + 2 * kv + 2 * q + lse) + (q + 2 * kv)
    return {"flops": 14.0 * pairs * d.n_layers,
            "bytes": float((fwd_bytes + bwd_bytes) * d.n_layers)}


# -------------------------------------------------------------- serving

def kv_row_bytes(d: Dims) -> int:
    """Bytes of one position's keys and values in one layer."""
    return 2 * d.n_kv_heads * d.head_dim * _BYTES[d.dtype]


def experts_touched(d: Dims, tokens: float) -> float:
    """Expected distinct experts that ``tokens`` tokens route to when each
    picks ``top_k`` of ``n_experts`` uniformly: E (1 - (1 - k/E)^tokens);
    at 16 tokens or more that is 99% of Mixtral's 8."""
    if d.family != "moe":
        return 0.0
    E, k = d.n_experts, d.top_k
    return E * (1.0 - (1.0 - k / E) ** tokens)


def decode_weight_bytes(d: Dims, tokens_per_step: float) -> float:
    """Weight bytes one decode step reads: every non-embedding weight once,
    an expert only if a running token routes to it, and the embedding
    rows of the running tokens."""
    total = 0.0
    for name, shape, _, kind in leaf_specs(d):
        size = _numel(shape) * (_BYTES[d.dtype] if kind == "dense" else 4)
        if name == "embed":
            total += tokens_per_step * d.d_model * _BYTES[d.dtype]
        elif name in ("blocks.w_gate", "blocks.w_up", "blocks.w_down") \
                and d.family == "moe":
            per_expert = size / d.n_experts
            total += (per_expert * experts_touched(d, tokens_per_step)
                      * d.n_layers)
        elif name.startswith("blocks."):
            total += size * d.n_layers
        else:
            total += size
    return total


def token_flops(d: Dims) -> float:
    """Matmul operations of one token through every layer and the head,
    with the ``top_k`` experts it is routed to (attention's scores not
    included)."""
    D, F = d.d_model, d.d_ff
    attn = D * (d.n_heads + 2 * d.n_kv_heads) * d.head_dim \
        + d.n_heads * d.head_dim * D
    if d.family == "moe":
        ffn = D * d.n_experts + d.top_k * 3 * D * F
    else:
        ffn = 3 * D * F
    return 2.0 * ((attn + ffn) * d.n_layers + D * d.vocab)


def decode_cost(d: Dims, steps: int, token_steps: int, visible: int
                ) -> Dict[str, float]:
    """Operations and bytes of ``steps`` decode steps that advanced
    ``token_steps`` running sequences by one token in all, whose
    attention saw ``visible`` cached positions in all (each counted at
    every step). Weights are read once per step."""
    per_step = token_steps / steps if steps else 0.0
    attn_flops = 4.0 * visible * d.n_heads * d.head_dim * d.n_layers
    kv = kv_row_bytes(d) * d.n_layers * (visible + token_steps)
    return {"flops": token_flops(d) * token_steps + attn_flops,
            "bytes": steps * decode_weight_bytes(d, per_step) + kv}


def paged_decode_bytes(d: Dims, token_steps: int, visible: int) -> float:
    """Bytes the paged-decode kernel needs over every layer: each running
    sequence's visible K and V rows read once, its query read and its
    output written."""
    qo = 2 * d.n_heads * d.head_dim * _BYTES[d.dtype]
    return float(d.n_layers * (kv_row_bytes(d) * visible + qo * token_steps))
