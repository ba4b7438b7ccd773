"""Weight-size accounting (from ``k8s_operator_libs_tpu/models/quant.py``).

Only what the batcher's ``weight_stream_gbs`` gauge needs; int8 weight
quantization waits for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

from .llama import param_leaves

Params = Dict[str, Any]


def quantized_size_bytes(params: Params) -> int:
    """Total bytes of the parameters as stored."""
    return sum(p.numel() * p.element_size() for p in param_leaves(params))


def stream_bytes(params: Params) -> int:
    """Bytes a decode step streams: every leaf except the embedding table,
    whose per-token row gather reads B rows, not the table."""
    embed = params["embed"]
    return quantized_size_bytes(params) - embed.numel() * embed.element_size()
