"""Single-token paged decode attention: the CUDA kernels, their plain
PyTorch versions, and the dispatch between them.

Port of the paged half of ``k8s_operator_libs_tpu/ops/attention.py``
(``paged_decode_kernel`` :734 and ``paged_decode_kernel_q`` :828, launched
by ``models/paged.py:_attend_paged_kernel``). The kernels live in
``csrc/paged_decode.cu`` (CUDA C++ for ``sm_90a``), built at first use by
:mod:`.build` and called through ``ctypes`` on PyTorch's current stream.

Dispatch: :func:`paged_decode` launches the kernel for CUDA tensors (or
raises — there is no fallback) and takes :func:`paged_decode_plain` only
for tensors on the CPU. Each launch adds one to :data:`LAUNCHES`, so a run
can show that its path went through the kernels.

Layouts are the reference's: q ``[B, 1, H, Dh]``, pools ``[NB, BS, KV,
Dh]``, scales ``[NB, BS, KV]`` fp32, table ``[B, MB]`` int32, lengths
``[B]`` int32 holding each sequence's position (its pre-write length);
keys at positions ``<= lengths[b]`` are visible.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

# launches per kernel since the last reset (A-K4, A-K5 in PERF.md)
LAUNCHES = {"paged_decode": 0, "paged_decode_int8": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
         torch.int8: 3}
BLOCK_SIZES = (8, 16, 32)

_fn = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_decode").paged_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def paged_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each sequence's
    table row into a contiguous view, mask keys past its position, softmax
    in fp32. int8 pools fold the k scale into the score columns and the v
    scale into the probability columns, as the kernel does. Invisible rows
    are zeroed before they meet a zero weight, so dead blocks may hold NaN
    here too. q [B, 1, H, Dh] -> [B, 1, H, Dh] in q's dtype."""
    B, _, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    MB = table.shape[1]
    G = H // KV
    cap = MB * BS
    idx = table.long()
    visible = (torch.arange(cap, device=q.device)[None, :]
               <= lengths.long()[:, None])                      # [B, cap]
    rows = visible[:, :, None, None]
    k_view = k_pool[idx].reshape(B, cap, KV, Dh).float()
    v_view = v_pool[idx].reshape(B, cap, KV, Dh).float()
    k_view = torch.where(rows, k_view, 0.0)
    v_view = torch.where(rows, v_view, 0.0)
    qg = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_view)            # [B,KV,G,cap]
    if k_scale is not None:
        ks = torch.where(visible[:, :, None],
                         k_scale[idx].reshape(B, cap, KV), 0.0)
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    s = s * (1.0 / math.sqrt(Dh))
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        vs = torch.where(visible[:, :, None],
                         v_scale[idx].reshape(B, cap, KV), 0.0)
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v_view)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _check(q, k_pool, v_pool, table, lengths, k_scale, v_scale):
    dev = q.device
    quant = k_scale is not None
    tensors = [q, k_pool, v_pool, table, lengths]
    if quant:
        if v_scale is None:
            raise ValueError("int8 pools need both k_scale and v_scale")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"paged_decode: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("paged_decode: every input must be contiguous")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode takes q [B, 1, H, Dh], got "
                         f"{tuple(q.shape)}")
    B, _, H, Dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must both be [NB, BS, KV, Dh]")
    NB, BS, KV, pDh = k_pool.shape
    if pDh != Dh or H % KV or H // KV > 32:
        raise ValueError(f"heads H={H}, KV={KV}, Dh={Dh} vs pool Dh={pDh}: "
                         f"need KV | H, H/KV <= 32")
    if Dh % 32 or Dh > 256:
        raise ValueError(f"head_dim {Dh} must be a multiple of 32, <= 256")
    if BS not in BLOCK_SIZES:
        raise ValueError(f"block size {BS} not in {BLOCK_SIZES}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("table and lengths must be int32")
    if table.dim() != 2 or table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("table must be [B, MB] and lengths [B]")
    if quant:
        if k_pool.dtype != torch.int8:
            raise ValueError("scale pools given but the pools are not int8")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (NB, BS, KV):
                raise ValueError("scales must be fp32 [NB, BS, KV]")
        if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"q dtype {q.dtype} not supported")
    elif k_pool.dtype != q.dtype or k_pool.dtype not in (
            torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"pool dtype {k_pool.dtype} with q {q.dtype}: the "
                         f"kernel takes matching fp32/bf16/fp16, or int8 "
                         f"pools with scales")
    if (Dh * k_pool.element_size()) % 16:
        raise ValueError("a K/V row must be a multiple of 16 bytes")
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")


def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table: torch.Tensor,
                      lengths: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the CUDA kernel (A-K4, or A-K5 with scale pools) on the
    current stream. Raises on anything the kernel does not take and on a
    non-zero ``cudaGetLastError`` after the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_cuda needs CUDA tensors, got "
                         f"{q.device}")
    _check(q, k_pool, v_pool, table, lengths, k_scale, v_scale)
    B, _, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    quant = k_scale is not None
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KIND[k_pool.dtype], _KIND[q.dtype], q.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, H, KV, Dh, BS, table.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["paged_decode_int8" if quant else "paged_decode"] += 1
    return out


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, table: torch.Tensor,
                 lengths: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: CUDA tensors launch the kernel, CPU tensors take the
    plain version. q [B, 1, H, Dh] -> [B, 1, H, Dh]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, table, lengths,
                                  k_scale, v_scale)
    return paged_decode_cuda(q, k_pool, v_pool, table, lengths,
                             k_scale, v_scale)
