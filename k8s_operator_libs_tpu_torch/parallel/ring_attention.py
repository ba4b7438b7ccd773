"""Ring attention: sequence parallelism over a mesh's ``seq`` axis.

Port of the JAX package's ``parallel/ring_attention.py`` (:33-99).
Each rank holds a chunk [B, Tl, H, Dh] of q and [B, Tl, KV, Dh] of k and
v; the K/V chunks travel the ring (:func:`.comm.ppermute`, k and v in one
message) and at step s a rank attends its q chunk against the chunk that
started s ranks back, through :func:`..ops.attention.
flash_attention_with_lse` (A-K1 on the card). The partial (out, lse)
pairs merge in fp32 with the logsumexp reweighting, in the reference's
expressions and order, and the result is cast to q's dtype once.

Causality is resolved per chunk pair: an earlier chunk is fully visible
(``causal=False``), the diagonal chunk takes the triangular mask
(``causal=True``), and a later chunk contributes out 0 and lse -1e30
without a launch. So rank r of n launches each flash kernel r + 1 times
per call, forward and backward. The backward is autograd through the
merge, through each block's lse (A-K2/A-K3 take delta - dlse) and through
the ppermutes, whose backward sends the K/V gradient back along the ring.
A masked step keeps the chunk it received in the graph at a zero
cotangent (:func:`.comm.tie`), so every rank runs every ppermute's
backward. The reference's last hop, which returns each chunk home unused,
is not made.
"""

from __future__ import annotations

import torch

from ..ops.attention import NEG_INF, flash_attention_with_lse
from . import comm


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Per-rank body: q [B, Tl, H, Dh], k/v [B, Tl, KV, Dh], this rank's
    chunks of a sequence split over ``group`` in rank order."""
    n, my = comm.size(group), comm.rank(group)
    B, Tl, H, Dh = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = torch.zeros((B, Tl, H, Dh), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Tl, 1), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack((k, v))
    for s in range(n):
        src = (my - s) % n                  # which chunk this rank holds
        kc, vc = kv.unbind(0)
        if causal and src > my:
            o_s = comm.tie(torch.zeros((B, Tl, H, Dh), dtype=q.dtype,
                                       device=q.device), kv)
            lse_s = torch.full((B, H, Tl, 1), NEG_INF, dtype=torch.float32,
                               device=q.device)
        else:
            o_s, lse_s = flash_attention_with_lse(
                q, kc, vc, causal=causal and src == my)
        # merge normalized partials: o = sum o_i exp(lse_i - lse_new)
        lse_new = torch.logaddexp(lse, lse_s)
        w_old = torch.exp(lse - lse_new)
        w_new = torch.exp(lse_s - lse_new)
        acc = (acc * w_old.transpose(1, 2)
               + o_s.float() * w_new.transpose(1, 2))
        lse = lse_new
        if s + 1 < n:
            kv = comm.ppermute(kv, group, perm)
    return acc.to(q.dtype)
