"""Plain float32 decoder: the reference the benchmark holds the port to.

Written from the published description of Mistral-7B and Mixtral-8x7B
(pre-norm RMSNorm blocks, rotary embedding over the half-split head dim,
grouped-query causal attention, SwiGLU feed-forward; Mixtral's block
routes each token to the top-2 of 8 SwiGLU experts by a softmax over the
router's logits, renormalised over the two). It imports nothing of the
program: torch, and the benchmark's own sizes and seeded weights.

Every product goes through a :class:`Matmul`. ``"fp32"`` is the
reference (float32 operands and sums, TF32 off). ``"fp8"`` is the
control: each operand is rounded to float8 (e4m3 in the forward, e5m2 for
a gradient) under a power-of-two scale per row or column before a
float32 product, the next precision below the bfloat16 the configurations
state. A rounded operand holds at most four significant bits, so its
products are exact in TF32, which the control therefore allows.
``"bf16"`` rounds each operand to bfloat16 the same way: a witness of
what the configurations' own precision moves, never a limit.

Attention is computed per (sequence, KV head) so that its scores stay
small, with its backward written out (:class:`_Attention`), and the
routed layer computes only the experts each token is routed to.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch

F8_FWD, F8_BWD = torch.float8_e4m3fn, torch.float8_e5m2


@contextlib.contextmanager
def tf32(allowed: bool):
    """TF32 for float32 products on the card, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_f8(x: torch.Tensor, fmt: torch.dtype, dim: Optional[int]
             ) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under a power-of-two scale per slice along
    ``dim`` (None: one scale for the tensor), returned in float32."""
    x = x.float()
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    top = torch.finfo(fmt).max
    scale = torch.exp2(torch.ceil(torch.log2(amax.clamp_min(1e-30) / top)))
    return (x / scale).to(fmt).float() * scale


class _F8Product(torch.autograd.Function):
    """a [..., N, K] @ b [..., K, M] with both operands in e4m3 (a by row,
    b by column); the backward's incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_f8(a, F8_FWD, -1), round_f8(b, F8_FWD, -2)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_f8(g, F8_BWD, None)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Matmul:
    """``mm(a, b)`` -> float32 ``a @ b`` at the named precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            with tf32(True):
                return _F8Product.apply(a, b)
        if self.precision == "bf16":
            # bf16 values are exact in TF32: the products are exact
            with tf32(True):
                return (a.to(torch.bfloat16).float()
                        @ b.to(torch.bfloat16).float())
        with tf32(False):
            return a.float() @ b.float()

    def grad(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product in a written-out backward; ``a`` is the gradient."""
        if self.precision == "fp8":
            with tf32(True):
                return round_f8(a, F8_BWD, None) @ round_f8(b, F8_FWD, -2)
        with tf32(False):
            return a.float() @ b.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_tables(T: int, Dh: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [T, Dh/2] of angle ``t * theta ** (-2i / Dh)`` (worked out
    in float64, kept in float32)."""
    i = torch.arange(Dh // 2, dtype=torch.float64, device=device)
    t = torch.arange(T, dtype=torch.float64, device=device)
    ang = t[:, None] * theta ** (-2.0 * i / Dh)[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., T, heads, Dh]: the half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


class _Attention(torch.autograd.Function):
    """Causal grouped-query attention of one sequence. q [T, H, Dh], k and
    v [T, KV, Dh] -> [T, H, Dh], one KV head's group at a time; the
    backward recomputes each group's probabilities from the saved
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, mm):
        T, H, Dh = q.shape
        KV = k.shape[1]
        G = H // KV
        scale = 1.0 / math.sqrt(Dh)
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        out = torch.empty_like(q)
        lse = torch.empty(KV, G, T, device=q.device)
        for j in range(KV):
            qj = q[:, j * G:(j + 1) * G].transpose(0, 1)        # [G, T, Dh]
            s = mm(qj, k[:, j].t()) * scale                       # [G, T, T]
            s = s.masked_fill(~mask, float("-inf"))
            lse[j] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[j][..., None])
            out[:, j * G:(j + 1) * G] = mm(p, v[:, j]).transpose(0, 1)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mm = mm
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mm = ctx.mm
        T, H, Dh = q.shape
        KV = k.shape[1]
        G = H // KV
        scale = 1.0 / math.sqrt(Dh)
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        for j in range(KV):
            sl = slice(j * G, (j + 1) * G)
            qj = q[:, sl].transpose(0, 1)                         # [G, T, Dh]
            doj = dout[:, sl].transpose(0, 1)
            s = mm(qj, k[:, j].t()) * scale
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.exp(s - lse[j][..., None])                  # [G, T, T]
            dv[:, j] = mm.grad(_flat(doj).t(), _flat(p)).t()
            dp = mm.grad(doj, v[:, j].t())                        # [G, T, T]
            delta = (doj * out[:, sl].transpose(0, 1)).sum(-1, keepdim=True)
            ds = p * (dp - delta) * scale
            dq[:, sl] = mm.grad(ds, k[:, j]).transpose(0, 1)
            dk[:, j] = mm.grad(_flat(ds).t(), _flat(qj))
        return dq, dk, dv, None


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[G, T, n] -> [G * T, n]: the group and query dims as one."""
    return x.reshape(-1, x.shape[-1])


def attention(q, k, v, mm: Matmul) -> torch.Tensor:
    return _Attention.apply(q, k, v, mm)


def swiglu(h: torch.Tensor, w_gate, w_up, w_down, mm: Matmul
           ) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(h, w_gate)) * mm(h, w_up), w_down)


def routed_experts(h: torch.Tensor, w: Dict[str, torch.Tensor], top_k: int,
                   mm: Matmul) -> torch.Tensor:
    """h [N, D] through the top-k of the layer's experts: softmax over the
    router's logits, the k largest kept and renormalised, each expert run
    on the tokens routed to it."""
    probs = torch.softmax(mm(h, w["router"]), dim=-1)               # [N, E]
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(w["w_gate"].shape[0]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e], mm)
        out = out.index_add(0, rows, y * top_p[rows, slot][:, None])
    return out


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], d, cos, sin,
          mm: Matmul) -> torch.Tensor:
    """One decoder block over x [B, T, D] (each row a sequence)."""
    B, T, D = x.shape
    Dh = d.head_dim
    h = rms_norm(x, w["attn_norm"], d.rms_eps)
    q = apply_rope(mm(h, w["wq"]).reshape(B, T, -1, Dh), cos, sin)
    k = apply_rope(mm(h, w["wk"]).reshape(B, T, -1, Dh), cos, sin)
    v = mm(h, w["wv"]).reshape(B, T, -1, Dh)
    att = torch.stack([attention(q[b], k[b], v[b], mm) for b in range(B)])
    x = x + mm(att.reshape(B, T, -1), w["wo"])
    h = rms_norm(x, w["mlp_norm"], d.rms_eps)
    if d.family == "moe":
        ffn = routed_experts(h.reshape(B * T, D), w, d.top_k,
                             mm).reshape(B, T, D)
    else:
        ffn = swiglu(h, w["w_gate"], w["w_up"], w["w_down"], mm)
    return x + ffn


def sequence_logits(d, layer: Callable[[int], Dict[str, torch.Tensor]],
                    head: Dict[str, torch.Tensor], tokens: list,
                    starts: list, mm: Matmul) -> list:
    """For each sequence ``tokens[i]`` (a 1-D LongTensor), the logits
    [T_i - 1 - start_i, V] that predict its tokens ``start_i + 1`` on,
    from one causal forward over the sequence. ``layer(l)`` gives layer
    l's float32 weights, ``head`` the float32 ``embed``, ``final_norm`` and
    ``lm_head``. Layer by layer over every sequence, so one layer's
    weights are resident at a time."""
    device = head["embed"].device
    with torch.no_grad():
        xs = [head["embed"][t[:-1].to(device)][None] for t in tokens]
        tabs = {}
        for x in xs:
            T = x.shape[1]
            if T not in tabs:
                tabs[T] = rope_tables(T, d.head_dim, d.rope_theta, device)
        for i in range(d.n_layers):
            w = layer(i)
            xs = [block(x, w, d, *tabs[x.shape[1]], mm) for x in xs]
            del w
        return [mm(rms_norm(x[0, s:], head["final_norm"], d.rms_eps),
                   head["lm_head"]) for x, s in zip(xs, starts)]
