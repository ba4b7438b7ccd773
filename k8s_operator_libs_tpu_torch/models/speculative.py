"""Speculative decoding over the contiguous cache.

Port of the JAX package's ``models/speculative.py``. A draft model
proposes ``k`` tokens one at a time; the target verifies all of them in
one (k+1)-token forward, and a rejection is a rewind of the cache length.

- ``temperature == 0``: accept while the draft token equals the target's
  argmax, then emit the target's own token at the first mismatch. The
  output is token-identical to greedy :func:`~.generate.generate` of the
  target, up to argmax ties: the verify pass evaluates the target at
  T = k+1 where plain decode evaluates T = 1, and in bf16 the two round
  differently. fp32 on the CPU is exact.
- ``temperature > 0``: rejection sampling (Leviathan et al.). The draft
  samples its proposals from p_d, the target accepts x with probability
  min(1, p_t(x) / p_d(x)), and a rejection at position i draws from the
  normalized residual max(p_t - p_d, 0). top-k / top-p filter both
  distributions. The output is distributed as target-only sampling.

Rounds are synchronized to the batch-minimum acceptance (the contiguous
cache has one length); in sampled mode the token emitted at the sync
point is per sequence. The reference's ``lax.while_loop`` becomes a
Python loop with host-side counts, and ``jax.random`` keys an explicit
``torch.Generator``, so sampled outputs compare with the reference by
distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .generate import _forward_cached, filter_logits, init_cache
from .llama import LlamaConfig

Params = Dict[str, Any]


def accept_counts(match: torch.Tensor) -> torch.Tensor:
    """Leading-True run length per row of a [B, k] accept matrix: how many
    draft tokens are confirmed before the first rejection."""
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)


def _draw(probs: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of [B, V] non-negative weights."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def speculative_generate(target_params: Params, draft_params: Params,
                         prompt: torch.Tensor, target_cfg: LlamaConfig,
                         draft_cfg: LlamaConfig, max_new_tokens: int = 32,
                         k: int = 4, draft_forward=None,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Decode of the TARGET model, accelerated by a draft model. prompt
    [B, Tp] -> [B, Tp + max_new_tokens] on the target parameters' device.
    Each round costs k + 1 draft steps (the last one only writes the
    draft cache row of the final proposal) and one (k+1)-token target
    verify, and emits 1..k+1 tokens. ``draft_forward(params, tokens,
    cache, cfg)`` overrides the draft's cached forward (default
    :func:`~.generate._forward_cached`); :func:`quantized_self_draft`
    supplies the int8 self-draft."""
    if k < 1:
        raise ValueError("speculation depth k must be >= 1")
    d_fwd = draft_forward or _forward_cached
    sampled = temperature != 0.0
    device = target_params["embed"].device
    prompt = prompt.to(device)
    B, Tp = prompt.shape
    cap = Tp + max_new_tokens + k + 1   # rounds may overhang; trimmed below
    t_cache = init_cache(target_cfg, B, cap, device=device)
    d_cache = init_cache(draft_cfg, B, cap, device=device)

    def dist(logits):
        return torch.softmax(filter_logits(logits / temperature, top_k,
                                           top_p), dim=-1)

    t_logits, t_cache = _forward_cached(target_params, prompt, t_cache,
                                        target_cfg)
    _, d_cache = d_fwd(draft_params, prompt, d_cache, draft_cfg)
    if sampled:
        last = _draw(dist(t_logits[:, -1]), generator)
    else:
        last = torch.argmax(t_logits[:, -1], dim=-1)
    out = torch.zeros((B, max_new_tokens + k + 1), dtype=torch.long,
                      device=device)
    out[:, 0] = last
    n = 1
    rows = torch.arange(B, device=device)
    while n < max_new_tokens:
        # the draft proposes: k + 1 steps, the last proposal discarded
        tok = last
        proposals, d_dists = [], []
        for _ in range(k + 1):
            logits, d_cache = d_fwd(draft_params, tok[:, None], d_cache,
                                    draft_cfg)
            logits = logits[:, -1]
            if sampled:
                p = dist(logits)
                tok = _draw(p, generator)
                d_dists.append(p)
            else:
                tok = torch.argmax(logits, dim=-1)
            proposals.append(tok)
        drafts = torch.stack(proposals[:k], dim=1)               # [B, k]

        # the target verifies the window in one forward
        window = torch.cat([last[:, None], drafts], dim=1)       # [B, k+1]
        t_len0 = t_cache.length
        v_logits, t_cache = _forward_cached(target_params, window, t_cache,
                                            target_cfg)
        if sampled:
            t_probs = dist(v_logits.reshape(B * (k + 1), -1)).reshape(
                B, k + 1, -1)
            d_probs = torch.stack(d_dists[:k], dim=1)            # [B, k, V]
            p_t_at = torch.gather(t_probs[:, :k], 2, drafts[..., None])[..., 0]
            p_d_at = torch.gather(d_probs, 2, drafts[..., None])[..., 0]
            u = torch.rand(p_t_at.shape, generator=generator,
                           device=device)
            match = u * p_d_at < p_t_at                          # [B, k]
        else:
            greedy = torch.argmax(v_logits, dim=-1)              # [B, k+1]
            match = drafts == greedy[:, :k]
        a = min(int(accept_counts(match).min()), k)   # batch-synchronized

        if sampled:
            # the token at the sync point: this sequence's accepted draft
            # where its own test passed at position a, else a residual
            # draw (position k: residual = p_t, an unconditional draw)
            t_a = t_probs[:, a]
            d_a = d_probs[:, a] if a < k else torch.zeros_like(t_a)
            r = torch.clamp_min(t_a - d_a, 0.0)
            r = torch.where(r.sum(-1, keepdim=True) > 0, r, t_a)
            res_draw = _draw(r, generator)
            if a < k:
                corr = torch.where(match[:, a], drafts[:, a], res_draw)
            else:
                corr = res_draw
        else:
            corr = greedy[:, a]
        out[:, n:n + a] = drafts[:, :a]
        out[rows, n + a] = corr
        # rewind: confirmed rows = old length + last token + a accepted
        new_len = t_len0 + 1 + a
        t_cache = dataclasses.replace(t_cache, length=new_len)
        d_cache = dataclasses.replace(d_cache, length=new_len)
        last = corr
        n += 1 + a
    generated = out[:, :max_new_tokens].to(prompt.dtype)
    return torch.cat([prompt, generated], dim=1)


def quantized_self_draft(target_params: Params):
    """(draft_params, draft_forward) for speculation without a second
    model: the target's own weights in int8 propose. Pass both to
    :func:`speculative_generate` with the target's config as
    ``draft_cfg``. Acceptance is how often int8 and the float weights
    agree on the argmax; on seeded random weights the top-2 margins are
    small and acceptance is low."""
    from .quant import _forward_quant, quantize_params
    return quantize_params(target_params), _forward_quant
