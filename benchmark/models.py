"""A configuration file's sizes, and the parameter layout both sides use.

A configuration file holds a model's published ``config.json`` keys as
they are run (``configs/<name>.json``). :class:`Dims` reads the sizes the
benchmark needs from it; :func:`port_config` turns them into the port's
config object. The leaves listed by :func:`leaf_specs` are the port's
parameter layout (per-layer weights stacked on axis 0, matrices
``[in, out]``), which the benchmark's weights and the plain references
share.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

ARCHITECTURES = {"MistralForCausalLM": "dense", "MixtralForCausalLM": "moe"}
# the port's RMSNorm has this epsilon built in
PORT_RMS_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str             # "dense" or "moe"
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    rope_theta: float
    rms_eps: float
    n_experts: int = 0
    top_k: int = 0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def dims(config: dict) -> Dims:
    """The sizes of a configuration file; raises on a model the port
    cannot run as stated."""
    arch = config["architectures"][0]
    if arch not in ARCHITECTURES:
        raise ValueError(f"no port family runs {arch}")
    if config.get("sliding_window") not in (None, 0):
        raise ValueError("the port has no sliding-window attention")
    if config.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU")
    if config.get("tie_word_embeddings"):
        raise ValueError("the port keeps separate embedding and output head")
    family = ARCHITECTURES[arch]
    moe = family == "moe"
    return Dims(family=family, vocab=int(config["vocab_size"]),
                d_model=int(config["hidden_size"]),
                n_layers=int(config["num_hidden_layers"]),
                n_heads=int(config["num_attention_heads"]),
                n_kv_heads=int(config["num_key_value_heads"]),
                d_ff=int(config["intermediate_size"]),
                rope_theta=float(config["rope_theta"]),
                rms_eps=float(config["rms_norm_eps"]),
                n_experts=int(config["num_local_experts"]) if moe else 0,
                top_k=int(config["num_experts_per_tok"]) if moe else 0,
                dtype=config.get("torch_dtype", "bfloat16"))


def port_config(d: Dims, remat: bool = True):
    """The port's ``LlamaConfig`` or ``MoEConfig`` for these sizes."""
    import torch

    from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
    from k8s_operator_libs_tpu_torch.models.moe import MoEConfig

    if d.rms_eps != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm epsilon is {PORT_RMS_EPS}, "
                         f"the configuration states {d.rms_eps}")
    common = dict(vocab_size=d.vocab, d_model=d.d_model,
                  n_layers=d.n_layers, n_heads=d.n_heads,
                  n_kv_heads=d.n_kv_heads, d_ff=d.d_ff,
                  rope_theta=d.rope_theta, dtype=getattr(torch, d.dtype),
                  remat=remat)
    if d.family == "moe":
        return MoEConfig(n_experts=d.n_experts, top_k=d.top_k, **common)
    return LlamaConfig(**common)


def leaf_specs(d: Dims) -> List[Tuple[str, Tuple[int, ...], int, str]]:
    """(name, per-layer shape, fan-in, kind) of every leaf. ``kind`` is
    ``"dense"`` (normal / sqrt(fan-in) in the served dtype), ``"router"``
    (the same in float32) or ``"ones"`` (a norm weight, float32). Names
    under ``blocks.`` are stacked over the layers."""
    D, H, KV, Dh, F = d.d_model, d.n_heads, d.n_kv_heads, d.head_dim, d.d_ff
    E = (d.n_experts,) if d.family == "moe" else ()
    specs = [("embed", (d.vocab, D), D, "dense"),
             ("blocks.attn_norm", (D,), 0, "ones"),
             ("blocks.wq", (D, H * Dh), D, "dense"),
             ("blocks.wk", (D, KV * Dh), D, "dense"),
             ("blocks.wv", (D, KV * Dh), D, "dense"),
             ("blocks.wo", (H * Dh, D), H * Dh, "dense"),
             ("blocks.mlp_norm", (D,), 0, "ones")]
    if E:
        specs.append(("blocks.router", (D, d.n_experts), D, "router"))
    specs += [("blocks.w_gate", (*E, D, F), D, "dense"),
              ("blocks.w_up", (*E, D, F), D, "dense"),
              ("blocks.w_down", (*E, F, D), F, "dense"),
              ("final_norm", (D,), 0, "ones"),
              ("lm_head", (D, d.vocab), D, "dense")]
    return specs


def leaf_names(d: Dims) -> List[str]:
    """Every compared leaf: a stacked leaf once per layer
    (``blocks.wq.7``), the others by name."""
    out = []
    for name, _, _, _ in leaf_specs(d):
        if name.startswith("blocks."):
            out += [f"{name}.{i}" for i in range(d.n_layers)]
        else:
            out.append(name)
    return out


def param_count(d: Dims) -> Dict[str, int]:
    """Parameters by part: ``embed``, ``layers`` (every stacked leaf of
    every layer), ``lm_head``, ``final_norm``, and ``total``."""
    out = {"embed": 0, "layers": 0, "lm_head": 0, "final_norm": 0}
    for name, shape, _, _ in leaf_specs(d):
        n = 1
        for s in shape:
            n *= s
        if name.startswith("blocks."):
            out["layers"] += n * d.n_layers
        else:
            out[name] += n
    out["total"] = sum(out.values())
    return out
