"""Llama-3-style decoder: config, parameters and the shared block ops.

Port of the JAX package's ``models/llama.py``. Parameters are a plain
dict of tensors with the reference layout: per-layer weights STACKED on
axis 0 (``[n_layers, ...]``), matrices stored ``[in, out]`` and applied as
``x @ W``, norm weights in fp32, everything else in ``cfg.dtype``. That is
the layout ``convert.py`` carries JAX parameters into, so the port runs on
the very weights the reference was tested with.

:func:`forward` is the training forward (``_block`` and ``forward``,
``models/llama.py:179-233``): a Python loop over the stacked layers with
attention through :func:`..ops.attention.flash_attention` (A-K1 forward,
A-K2/A-K3 backward on the card). Under ``cfg.remat`` each block is
recomputed in the backward except the flash call's ``out`` and ``lse``,
which is what the reference's ``remat_block`` policy saves: the parts
before and after attention run under ``torch.utils.checkpoint`` and the
attention Function between them does not, so the backward never re-runs
the forward kernel. The ``gather`` hook turns each leaf as a rank holds
it into the whole leaf where it is used (FSDP's all-gather, inside the
checkpointed regions); by default the identity. The tensor-parallel
hooks of :func:`_block` (the reference's ``tp_block``,
``parallel/composed.py:108-128``) run inside the same regions: a rank
holding the column-parallel wq/wk/wv/w_gate/w_up and row-parallel
wo/w_down slices computes its H/tp heads and d_ff/tp columns (head counts
follow the slices' widths), ``tp_in`` marks the normed input of the
column-parallel matmuls (replicated over the tensor axis: its gradient is
summed there) and ``tp_out`` sums each row-parallel output over the
axis; both are the identity by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention
from ..utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **overrides) -> "LlamaConfig":
        """The Llama-3-8B shape."""
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        """Test shape: same topology, toy widths."""
        base = cls(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=256, max_seq_len=256, remat=False)
        return dataclasses.replace(base, **overrides)

    @classmethod
    def small(cls, **overrides) -> "LlamaConfig":
        """~125M shape."""
        base = cls(vocab_size=32000, d_model=768, n_layers=12, n_heads=12,
                   n_kv_heads=4, d_ff=2048, max_seq_len=2048, remat=False)
        return dataclasses.replace(base, **overrides)

    @classmethod
    def bench_mfu(cls, **overrides) -> "LlamaConfig":
        """~760M shape."""
        base = cls(vocab_size=32000, d_model=2048, n_layers=10, n_heads=16,
                   n_kv_heads=8, d_ff=8192, max_seq_len=1024, remat=False)
        return dataclasses.replace(base, **overrides)


# ---------------------------------------------------------------- init

def _init_dense(gen: torch.Generator, shape, fan_in: int, dtype,
                device) -> torch.Tensor:
    """fp32 ``normal * 1/sqrt(fan_in)``, then the cast — the reference's
    scheme. Values come from ``gen`` and so differ from ``jax.random``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Seeded random parameters in the reference layout. Stacked weights
    are drawn one layer at a time into a preallocated ``cfg.dtype``
    tensor, so the fp32 temporary never exceeds one layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, H, KV, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype

    def stack(shape, fan_in):
        out = torch.empty((L, *shape), dtype=dt, device=dev)
        for i in range(L):
            out[i] = _init_dense(gen, shape, fan_in, dt, dev)
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
            "w_gate": stack((D, F), D),
            "w_up": stack((D, F), D),
            "w_down": stack((F, D), F),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": _init_dense(gen, (D, cfg.vocab_size), D, dt, dev),
    }


def param_leaves(params: Params):
    for value in params.values():
        if isinstance(value, dict):
            yield from param_leaves(value)
        else:
            yield value


# ---------------------------------------------------------------- ops

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in the reference's rounding order: normalize in fp32, cast
    to ``x.dtype``, then multiply by the weight cast to ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim, half-split rotation in fp32.
    x [B, T, H, Dh]; positions [B, T]. Frequencies use the reference's
    ``exp(-log(theta) * i / half)`` form (``theta ** (-2i/d)`` differs in
    the last bits)."""
    half = x.shape[-1] // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * idx / half)
    angles = positions[..., None].float() * freqs        # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def matmul(x: torch.Tensor, layer: Params, name: str) -> torch.Tensor:
    """``x @ layer[name]``: the default of the forwards' ``matmul`` hook."""
    return x @ layer[name]


def swiglu(h: torch.Tensor, layer: Params, mm=matmul) -> torch.Tensor:
    """The block's MLP: silu(h W_gate) in fp32, cast back, times h W_up,
    then W_down (the reference computes the gate's silu in fp32). ``mm``
    is the forwards' ``matmul`` hook (int8 weights pass theirs)."""
    gate = torch.nn.functional.silu(mm(h, layer, "w_gate").float()
                                    ).to(h.dtype)
    return mm(gate * mm(h, layer, "w_up"), layer, "w_down")


def param_count(params: Params) -> int:
    return sum(p.numel() for p in param_leaves(params))


# ---------------------------------------------------------------- training

def no_gather(name: str, w: torch.Tensor) -> torch.Tensor:
    """The default ``gather`` hook: every rank holds the whole leaf."""
    return w


def identity(x: torch.Tensor) -> torch.Tensor:
    """The default tensor-parallel hook: one rank holds every head."""
    return x


def _qkv(cfg: LlamaConfig, x: torch.Tensor, attn_norm, wq, wk, wv,
         positions: torch.Tensor, gather: Callable = no_gather,
         tp_in: Callable = identity):
    """The block before attention: RMSNorm, the Q/K/V projections, RoPE.
    K/V stay at their KV heads (the flash kernels take GQA natively); the
    head counts are the projections' widths over Dh, the rank's local
    heads under tensor parallelism."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    attn_norm, wq, wk, wv = (gather(n, w) for n, w in (
        ("attn_norm", attn_norm), ("wq", wq), ("wk", wk), ("wv", wv)))
    h = tp_in(rms_norm(x, attn_norm))
    q = rope((h @ wq).reshape(B, T, -1, Dh), positions, cfg.rope_theta)
    k = rope((h @ wk).reshape(B, T, -1, Dh), positions, cfg.rope_theta)
    v = (h @ wv).reshape(B, T, -1, Dh)
    return q, k, v


def _post(x: torch.Tensor, attn: torch.Tensor, wo, mlp_norm, w_gate, w_up,
          w_down, gather: Callable = no_gather, tp_in: Callable = identity,
          tp_out: Callable = identity) -> torch.Tensor:
    """The block after attention: O-projection and residual, then the
    SwiGLU MLP and its residual."""
    B, T, _ = x.shape
    wo, mlp_norm, w_gate, w_up, w_down = (gather(n, w) for n, w in (
        ("wo", wo), ("mlp_norm", mlp_norm), ("w_gate", w_gate),
        ("w_up", w_up), ("w_down", w_down)))
    x = x + tp_out(attn.reshape(B, T, -1) @ wo)
    return x + tp_out(swiglu(tp_in(rms_norm(x, mlp_norm)),
                             {"w_gate": w_gate, "w_up": w_up,
                              "w_down": w_down}))


def _block(cfg: LlamaConfig, attn_fn: Callable, x: torch.Tensor,
           layer: Params, positions: torch.Tensor,
           gather: Callable = no_gather, tp_in: Callable = identity,
           tp_out: Callable = identity) -> torch.Tensor:
    """One decoder block (pre-norm attention + SwiGLU MLP). ``gather``
    and the tensor-parallel hooks run inside the checkpointed regions, so
    under remat autograd keeps the layer's shards, not what the hook
    gathered from them, and only the flash call's out and lse."""
    pre = (x, layer["attn_norm"], layer["wq"], layer["wk"], layer["wv"])
    post = (layer["wo"], layer["mlp_norm"], layer["w_gate"], layer["w_up"],
            layer["w_down"])
    if not cfg.remat:
        q, k, v = _qkv(cfg, *pre, positions, gather, tp_in)
        return _post(x, attn_fn(q, k, v), *post, gather, tp_in, tp_out)
    q, k, v = checkpoint(_qkv, cfg, *pre, positions, gather, tp_in,
                         use_reentrant=False)
    attn = attn_fn(q, k, v)
    return checkpoint(_post, x, attn, *post, gather, tp_in, tp_out,
                      use_reentrant=False)


def _default_attn(q, k, v):
    return flash_attention(q, k, v, causal=True)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None,
            attn_fn: Optional[Callable] = None,
            gather: Callable = no_gather) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, vocab] in fp32, differentiable.
    ``attn_fn(q, k, v)`` overrides the attention primitive (default the
    flash kernels; ``ops.attention.reference_attention`` is the plain
    one); ``positions`` [B, T] overrides the absolute positions.
    ``gather(name, w)`` turns each leaf as held (one layer's slice of a
    stacked leaf) into the whole leaf where it is used: FSDP's all-gather
    (``parallel/fsdp.py``), the identity by default."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    # F.embedding: its backward sums repeated tokens in a fixed order
    x = torch.nn.functional.embedding(tokens.long(),
                                      gather("embed", params["embed"]))
    blocks = params["blocks"]
    names = list(blocks)
    # one unbind per leaf: its backward stacks the per-layer gradients
    # once, where indexing each layer would add a zero-filled full-size
    # gradient per layer
    per_layer = zip(*(blocks[n].unbind(0) for n in names))
    fn = attn_fn or _default_attn
    for weights in per_layer:
        x = _block(cfg, fn, x, dict(zip(names, weights)), positions,
                   gather)
    x = rms_norm(x, gather("final_norm", params["final_norm"]))
    return (x @ gather("lm_head", params["lm_head"])).float()
