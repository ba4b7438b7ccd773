"""Causal GQA flash attention for training: the CUDA kernels, their plain
PyTorch versions, the dispatch between them and the autograd Function.

Port of the JAX package's ``ops/attention.py:1-720, 914-941``: the
flash forward (A-K1, ``_flash_kernel``), the dq backward (A-K2,
``_flash_bwd_dq_kernel``) and the dk/dv backward (A-K3,
``_flash_bwd_dkv_kernel``), joined by the custom VJP of
``flash_attention``. The kernels are CUDA C++ for ``sm_90a``, built at
first use by :mod:`.build` and called through ``ctypes`` on PyTorch's
current stream: bf16 and fp16 on the tensor cores (``wgmma``) in
``csrc/flash_attention_tc.cu``, fp32 on the FMA units in
``csrc/flash_attention.cu``. :func:`kernel_route` picks the source of
both directions by dtype: TF32, the tensor cores' fp32, would not hold
fp32 parity.

Dispatch: :func:`flash_forward` and :func:`flash_backward` launch the
kernels for CUDA tensors (or raise: there is no fallback) and take the
plain versions, :func:`reference_attention_with_lse` and
:func:`flash_backward_plain`, only for tensors on the CPU. Each kernel
launch adds one to :data:`LAUNCHES`; each plain call in their place adds
one to :data:`PLAIN_CALLS`, so a run can show which path it took and how
often (remat must not re-run the forward).

Layouts are the reference's: q ``[B, T, H, Dh]``, k/v ``[B, T, KV, Dh]``
with KV dividing H (head ``h = kv * G + g``, ``G = H // KV``), and the
logsumexp fp32 ``[B * KV, G, T]`` in base e.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

LOG2E = 1.4426950408889634
NEG_INF = -1e30

# launches per kernel since the last reset (A-K1, A-K2, A-K3 in PERF.md),
# those of them without the causal mask (a ring's earlier key chunks), the
# same launches by route (see kernel_route), and the plain versions' calls
# that stand in for the kernels on the CPU
LAUNCHES = {"flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
FULL_LAUNCHES = dict(LAUNCHES)
ROUTE_LAUNCHES = {"wgmma": 0, "fma": 0}
PLAIN_CALLS = {"flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 64          # query heads per K/V head: the kernels' 64-row tile

_fns = {}


# route -> (CUDA source, suffix of its entry points)
_ROUTE_SOURCES = {"fma": ("flash_attention", ""),
                  "wgmma": ("flash_attention_tc", "_tc")}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FULL_LAUNCHES, ROUTE_LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels, forward and backward, that take q of ``dtype`` and
    ``head_dim``: "wgmma" (``csrc/flash_attention_tc.cu``, the tensor
    cores) for bf16 and fp16, "fma" (``csrc/flash_attention.cu``) for fp32,
    whose parity TF32 would break. Raises ValueError for what neither
    takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"dtype {dtype}: the flash kernels take fp32, bf16 "
                     f"or fp16")


def _launcher(name: str, route: str):
    source, suffix = _ROUTE_SOURCES[route]
    key = name + suffix
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(build.load(source), f"{key}_launch")
        fn.restype = ctypes.c_int
        n_ptr = {"flash_forward": 5, "flash_bwd_dq": 7,
                 "flash_bwd_dkv": 8}[name]
        scalars = [ctypes.c_int] * 6 + [ctypes.c_float]
        if name != "flash_forward":
            scalars.append(ctypes.c_float)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr + scalars
                       + [ctypes.c_void_p])
        _fns[key] = fn
    return fn


def _shape(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int, int,
                                                      int, int]:
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    return B, T, H, KV, H // KV, Dh


def _grouped(x: torch.Tensor, KV: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, KV, G, T, Dh] in fp32 (head h = kv * G + g)."""
    B, T, H, Dh = x.shape
    return x.float().reshape(B, T, KV, H // KV, Dh).permute(0, 2, 3, 1, 4)


def _visible(T: int, causal: bool, device) -> torch.Tensor:
    if not causal:
        return torch.ones((T, T), dtype=torch.bool, device=device)
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


# ------------------------------------------------------------ plain versions

def reference_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A-K1's function in plain PyTorch, as the reference's
    ``reference_attention_with_lse``: fp32 scores, softmax normalised
    before the cast to q's dtype. Returns (out [B, T, H, Dh] in q's dtype,
    lse fp32 [B * KV, G, T], base e). Differentiable by autograd."""
    B, T, H, KV, G, Dh = _shape(q, k)
    scale = 1.0 / math.sqrt(Dh)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # [B,KV,1,T,Dh]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (_grouped(q, KV) @ kf.transpose(-1, -2)) * scale    # [B,KV,G,T,T]
    s = torch.where(_visible(T, causal, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = (p / l).to(q.dtype).float()
    out = (probs @ vf).permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)
    lse = (m + torch.log(l))[..., 0].reshape(B * KV, G, T)
    return out.to(q.dtype), lse


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain softmax attention (the reference's ``reference_attention``),
    differentiable by autograd: the model's plain ``attn_fn``."""
    return reference_attention_with_lse(q, k, v, causal)[0]


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    KV: int) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, laid out like lse [B * KV, G, T]
    (the reference computes it outside the kernels, ``:630``)."""
    B, T, H, _ = out.shape
    d = (dout.float() * out.float()).sum(dim=-1)             # [B, T, H]
    return d.permute(0, 2, 1).reshape(B * KV, H // KV, T).contiguous()


def _delta_minus_dlse(delta: torch.Tensor,
                      dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """The delta the backward kernels take when lse has a cotangent too:
    dS = P (dP - delta) + P dlse = P (dP - (delta - dlse))."""
    if dlse is None:
        return delta
    return (delta - dlse.reshape(delta.shape).float()).contiguous()


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, causal: bool = True,
                         dlse: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A-K2 and A-K3 in plain PyTorch: recompute P = exp(S - lse) from the
    forward's logsumexp, dS = P (dP - (delta - dlse)), then dq = scale dS
    K, dk = scale dS^T q summed over the G heads of each group, dv = P^T
    dO. ``dlse`` [B * KV, G, T] is the cotangent of lse (d lse / d S = P),
    None for zero. fp32 throughout; outputs in the inputs' dtypes."""
    B, T, H, KV, G, Dh = _shape(q, k)
    scale = 1.0 / math.sqrt(Dh)
    qg = _grouped(q, KV)                                     # [B,KV,G,T,Dh]
    dog = _grouped(dout, KV)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]           # [B,KV,1,T,Dh]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qg @ kf.transpose(-1, -2)) * scale                  # [B,KV,G,T,T]
    p = torch.exp(s - lse.reshape(B, KV, G, T, 1))
    p = torch.where(_visible(T, causal, q.device), p, 0.0)
    delta = _delta_minus_dlse(attention_delta(out, dout, KV), dlse)
    ds = p * ((dog @ vf.transpose(-1, -2)) - delta.reshape(B, KV, G, T, 1))
    dq = (ds @ kf) * scale                                   # [B,KV,G,T,Dh]
    dk = (ds.transpose(-1, -2) @ qg).sum(dim=2) * scale      # [B,KV,T,Dh]
    dv = (p.transpose(-1, -2) @ dog).sum(dim=2)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ------------------------------------------------------------ CUDA kernels

def _q_multiplier(dtype: torch.dtype, Dh: int) -> float:
    """scale * log2e rounded to the storage dtype, as the reference's
    weakly typed ``q * (scale * LOG2E)`` rounds it before the product."""
    c = torch.tensor(LOG2E / math.sqrt(Dh), dtype=torch.float64)
    return float(c.to(dtype))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *extra: torch.Tensor) -> None:
    for t in (q, k, v, *extra):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash attention kernels need CUDA tensors on "
                             f"one device, got {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention: every input must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash attention: inputs must be 16-byte "
                             "aligned")
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         f"kernels take one of fp32, bf16, fp16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, T, H, Dh] and k, v [B, T, KV, Dh]")
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, T) or k.shape[3] != Dh or H % KV:
        raise ValueError(f"q {tuple(q.shape)} vs k/v {tuple(k.shape)}: need "
                         f"the same B, T, Dh and KV dividing H")
    if H // KV > MAX_GROUP or Dh not in HEAD_DIMS:
        raise ValueError(f"group H/KV = {H // KV} (<= {MAX_GROUP}) and "
                         f"head_dim {Dh} (in {HEAD_DIMS}) not supported")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch A-K1 on the current stream, on the kernel
    :func:`kernel_route` names: (out like q, lse fp32 [B * KV, G, T])."""
    _check(q, k, v)
    B, T, H, KV, G, Dh = _shape(q, k)
    route = kernel_route(q.dtype, Dh)
    out = torch.empty_like(q)
    lse = torch.empty((B * KV, G, T), dtype=torch.float32, device=q.device)
    fn = _launcher("flash_forward", route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, T, H, KV, Dh, int(causal),
                _q_multiplier(q.dtype, Dh), stream)
    _raise_on(rc, "flash_forward")
    LAUNCHES["flash_forward"] += 1
    FULL_LAUNCHES["flash_forward"] += not causal
    ROUTE_LAUNCHES[route] += 1
    return out, lse


def _check_residuals(q, lse, delta, dout):
    B, T, H, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.numel() != B * H * T:
            raise ValueError("lse and delta must be fp32 [B * KV, G, T]")


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal=True):
    """Launch A-K2 on the current stream, on the kernel
    :func:`kernel_route` names: dq like q."""
    _check(q, k, v, dout, lse, delta)
    _check_residuals(q, lse, delta, dout)
    B, T, H, KV, _, Dh = _shape(q, k)
    route = kernel_route(q.dtype, Dh)
    dq = torch.empty_like(q)
    fn = _launcher("flash_bwd_dq", route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), B, T, H, KV, Dh, int(causal),
                _q_multiplier(q.dtype, Dh), 1.0 / math.sqrt(Dh), stream)
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    FULL_LAUNCHES["flash_bwd_dq"] += not causal
    ROUTE_LAUNCHES[route] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal=True):
    """Launch A-K3 on the current stream, on the kernel
    :func:`kernel_route` names: (dk like k, dv like v)."""
    _check(q, k, v, dout, lse, delta)
    _check_residuals(q, lse, delta, dout)
    B, T, H, KV, _, Dh = _shape(q, k)
    route = kernel_route(q.dtype, Dh)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _launcher("flash_bwd_dkv", route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, H, KV, Dh, int(causal),
                _q_multiplier(q.dtype, Dh), 1.0 / math.sqrt(Dh), stream)
    _raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    FULL_LAUNCHES["flash_bwd_dkv"] += not causal
    ROUTE_LAUNCHES[route] += 1
    return dk, dv


# ------------------------------------------------------------ dispatch

def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B * KV, G, T]): A-K1 for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        PLAIN_CALLS["flash_forward"] += 1
        return reference_attention_with_lse(q, k, v, causal)
    return flash_forward_cuda(q, k, v, causal)


def flash_backward(q, k, v, out, lse, dout, causal=True, dlse=None):
    """(dq, dk, dv): delta = rowsum(dO * O) in fp32, less ``dlse`` (the
    cotangent of lse, [B * KV, G, T], None for zero), then A-K2 and A-K3
    for CUDA tensors; the plain version for CPU tensors."""
    if q.device.type == "cpu":
        PLAIN_CALLS["flash_bwd_dq"] += 1
        PLAIN_CALLS["flash_bwd_dkv"] += 1
        return flash_backward_plain(q, k, v, out, lse, dout, causal, dlse)
    delta = _delta_minus_dlse(attention_delta(out, dout, k.shape[2]), dlse)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the reference's ``_flash_attention``, in both
    outputs: the forward saves (q, k, v, out, lse), the backward recomputes
    P from lse and folds lse's cotangent into delta. A consumer that uses
    only ``out`` gives a zero ``dlse`` (None), the plain delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        # an unused output's cotangent arrives as None, not zeros: the
        # plain training path pays no delta - 0 pass
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.contiguous(),
                                    ctx.causal, dlse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q [B, T, H, Dh] against k/v [B, T, KV, Dh] (KV
    dividing H), differentiable through the flash backward. GQA is handled
    inside the kernels: pass the projections without repeating K/V."""
    return _FlashAttention.apply(q, k, v, causal)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B, H, T, 1]): the pair a consumer needs to merge partial
    attentions over key chunks (ring attention). Differentiable in both,
    as the reference's is."""
    B, T, H, _ = q.shape
    out, lse = _FlashAttention.apply(q, k, v, causal)
    return out, lse.reshape(B, H, T, 1)
