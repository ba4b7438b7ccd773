"""The MoE family's training loss on one device.

Port of ``moe_reference_loss`` from the JAX package's ``parallel/
expert.py`` (:139-149): the dense-dispatch forward's mean next-token NLL
plus ``router_aux_coef`` times the summed load-balance aux term. Expert
parallelism (``make_ep_loss``, ``make_ep_a2a_loss``) shards the experts
over devices and waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.moe import MoEConfig, forward


def moe_reference_loss(cfg: MoEConfig,
                       attn_fn: Optional[Callable] = None) -> Callable:
    """``loss(params, tokens [B, T + 1])``; ``attn_fn`` overrides the
    attention primitive as in :func:`..models.moe.forward`."""

    def loss(params, tokens):
        logits, aux = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
        logp = torch.log_softmax(logits, dim=-1)
        targets = tokens[:, 1:].long()
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll.mean() + cfg.router_aux_coef * aux

    return loss
