"""Ulysses sequence parallelism: two all-to-alls reshard heads and
sequence around one full-sequence flash attention.

Port of the JAX package's ``parallel/ulysses.py`` (:40-77)::

    [B, T/n, H, Dh]  --all_to_all(split heads, concat seq)-->  [B, T, H/n, Dh]
    flash attention over the whole sequence, H/n heads (A-K1, A-K2, A-K3)
    [B, T, H/n, Dh]  --all_to_all(split seq, concat heads)-->  [B, T/n, H, Dh]

One launch of each flash kernel per call and rank, at full T. The group's
size must divide H; with fewer K/V heads than ranks, K/V are repeated up
to exactly n heads (factor n/KV) and the kernel takes the remaining
H/n : 1 grouping. The ring (:mod:`.ring_attention`) has no head limit.
"""

from __future__ import annotations

import torch

from ..ops.attention import flash_attention
from ..utils import comm


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = True) -> torch.Tensor:
    """Per-rank body: q [B, Tl, H, Dh], k/v [B, Tl, KV, Dh], this rank's
    chunks of a sequence split over ``group`` in rank order."""
    n = comm.size(group)
    H, KV = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs head count {H} divisible by "
                         f"seq-axis size {n}")
    if KV < n:
        if n % KV:
            raise ValueError(f"ulysses needs K/V head count {KV} to divide "
                             f"the seq-axis size {n}")
        k = k.repeat_interleave(n // KV, dim=2)
        v = v.repeat_interleave(n // KV, dim=2)
    elif KV % n:
        raise ValueError(f"ulysses needs K/V head count {KV} divisible by "
                         f"seq-axis size {n}")

    def to_heads(x):
        return comm.all_to_all(x, group, split_axis=2, concat_axis=1)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal)
    return comm.all_to_all(out, group, split_axis=1, concat_axis=2)
