"""Single-token paged decode attention: the CUDA kernels, their plain
PyTorch versions, and the dispatch between them.

Port of the paged half of the JAX package's ``ops/attention.py``
(``paged_decode_kernel`` :734 and ``paged_decode_kernel_q`` :828, launched
by ``models/paged.py:_attend_paged_kernel``). The kernels live in
``csrc/paged_decode.cu`` (CUDA C++ for ``sm_90a``), built at first use by
:mod:`.build` and called through ``ctypes`` on PyTorch's current stream.

Dispatch: :func:`paged_decode` launches the kernel for CUDA tensors (or
raises — there is no fallback) and takes :func:`paged_decode_plain` only
for tensors on the CPU. Each call adds one to :data:`LAUNCHES`, so a run
can show that its path went through the kernels.

The kernel splits each sequence's live blocks over several CTAs
(flash-decoding) and merges their partial softmaxes; :func:`split_plan`
picks the split on the host from the shapes and the SM count, and
:func:`paged_decode_split_plain` is the same split and merge in plain
PyTorch, for the tests.

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
# a split's scores stay in the CTA's shared memory (csrc kMaxSplitKeys)
MAX_SPLIT_KEYS = 256
# grid CTAs per SM the split aims for with every block live: live work is
# then about two per SM when sequences fill half their capacity
CTAS_PER_SM = 4

_fn = None
_sm_counts = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_decode").paged_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def split_plan(B: int, KV: int, MB: int, BS: int,
               sm_count: int) -> tuple:
    """(split_blocks, n_split) for a call over B sequences of MB table
    entries: split i takes blocks [i * split_blocks, (i + 1) *
    split_blocks). The widest split (MAX_SPLIT_KEYS keys) is halved until
    the grid of B * KV * n_split CTAs reaches CTAS_PER_SM per SM. Integers
    only: the lengths live on the card, and reading them here would put a
    host sync into every layer of a decode step."""
    for name, v in (("B", B), ("KV", KV), ("MB", MB), ("BS", BS),
                    ("sm_count", sm_count)):
        if type(v) is not int or v <= 0:
            raise TypeError(f"split_plan: {name} must be a positive int, "
                            f"got {v!r}")
    split_blocks = max(1, MAX_SPLIT_KEYS // BS)
    while (split_blocks > 1 and B * KV * -(-MB // split_blocks)
           < CTAS_PER_SM * sm_count):
        split_blocks //= 2
    split_blocks = min(split_blocks, MB)
    return split_blocks, -(-MB // split_blocks)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def paged_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each sequence's
    table row into a contiguous view, mask keys past its position, and
    take the kernel's one-split softmax in fp32: p = exp(s - max s),
    l = sum p, out = (p V) / l. int8 pools fold the k scale into the
    score columns and the v scale into the probability columns, as the
    kernel does. The weights meet V rounded as the reference kernel
    rounds them: p to the pool dtype, int8's p * vs to q's dtype (fp32
    rounds nothing). Invisible rows are zeroed before they meet a zero
    weight, so dead blocks may hold NaN here too. q [B, 1, H, Dh] ->
    [B, 1, H, Dh] in q's dtype."""
    B, _, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    MB = table.shape[1]
    G = H // KV
    cap = MB * BS
    idx = table.long()
    visible = visible_keys(lengths, MB, BS)                     # [B, cap]
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
    # key 0 is always visible, so the row max is finite
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    vs = None
    if v_scale is not None:
        vs = torch.where(visible[:, :, None],
                         v_scale[idx].reshape(B, cap, KV), 0.0)
        vs = vs.permute(0, 2, 1)[:, :, None, :]
    p = round_weights(p, vs, q.dtype, v_pool.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_view)
    out = out / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def round_weights(p: torch.Tensor, vs: Optional[torch.Tensor],
                  q_dtype: torch.dtype, pool_dtype: torch.dtype
                  ) -> torch.Tensor:
    """The P V weights as the kernels round them (the reference kernels'
    roundings, ``ops/attention.py:815`` and ``:899`` of the JAX package):
    p rounded to the pool dtype, or with int8 pools p * vs rounded to q's
    dtype; back in fp32 for the product."""
    if vs is not None:
        return (p * vs).to(q_dtype).float()
    return p.to(pool_dtype).float()


def visible_keys(lengths: torch.Tensor, MB: int, BS: int) -> torch.Tensor:
    """[B, MB * BS] bool: key t of sequence b is visible iff t <=
    lengths[b]."""
    return (torch.arange(MB * BS, device=lengths.device)[None, :]
            <= lengths.long()[:, None])


def split_partials(q: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, table: torch.Tensor,
                   visible: torch.Tensor, split_blocks: int,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> tuple:
    """The kernel's per-split partials in plain PyTorch, over the keys
    ``visible`` [B, MB * BS] marks: each split's row max m, sum l of
    p = exp(s - m) and acc = sum p (* vs) v with the weights rounded as
    :func:`round_weights` does, fp32, shaped [B, KV, G, n]
    and [B, KV, G, n, Dh] for n = ceil(MB / split_blocks) splits. A split
    with no visible key has m = -inf and l = acc = 0."""
    B, _, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    MB = table.shape[1]
    G = H // KV
    n = -(-MB // split_blocks)
    cap, span = MB * BS, n * split_blocks * BS
    idx = table.long()
    rows = visible[:, :, None, None]
    k_view = torch.where(rows, k_pool[idx].reshape(B, cap, KV, Dh).float(),
                         0.0)
    v_view = torch.where(rows, v_pool[idx].reshape(B, cap, KV, Dh).float(),
                         0.0)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KV, G, Dh),
                     k_view)                                   # [B,KV,G,cap]
    if k_scale is not None:
        ks = torch.where(visible[:, :, None],
                         k_scale[idx].reshape(B, cap, KV), 0.0)
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    s = (s * (1.0 / math.sqrt(Dh))).masked_fill(
        ~visible[:, None, None, :], float("-inf"))
    s = torch.nn.functional.pad(s, (0, span - cap), value=float("-inf"))
    s = s.reshape(B, KV, G, n, span // n)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    vs = None
    if v_scale is not None:
        vs = torch.where(visible[:, :, None],
                         v_scale[idx].reshape(B, cap, KV), 0.0)
        vs = torch.nn.functional.pad(vs.permute(0, 2, 1), (0, span - cap))
        vs = vs.reshape(B, KV, 1, n, span // n)
    p = round_weights(p, vs, q.dtype, v_pool.dtype)
    v_view = torch.nn.functional.pad(v_view, (0, 0, 0, 0, 0, span - cap))
    acc = torch.einsum("bkgis,biskd->bkgid", p,
                       v_view.reshape(B, n, span // n, KV, Dh))
    return m, l, acc


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The kernel's merge: out = sum_i e^(m_i - M) acc_i / max(sum_i
    e^(m_i - M) l_i, 1e-30), M the largest m_i, summed over the splits in
    split order; a split with m_i = -inf adds exactly 0. -> [B, KV, G,
    Dh] fp32."""
    big = m.amax(-1)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(big), 0.0,
                                              big)[..., None]))
    total = torch.zeros_like(l[..., 0])
    out = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        total = total + w[..., i] * l[..., i]
        out = out + w[..., i, None] * acc[..., i, :]
    return out / total.clamp_min(1e-30)[..., None]


def paged_decode_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, table: torch.Tensor,
                             lengths: torch.Tensor,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             split_blocks: int = 1) -> torch.Tensor:
    """:func:`paged_decode_plain`'s function computed as the kernel does:
    per-split partials of ``split_blocks`` blocks, then the merge, in the
    kernel's formula and order. For the tests; nothing on the main path
    calls it. q [B, 1, H, Dh] -> [B, 1, H, Dh] in q's dtype."""
    B, _, H, Dh = q.shape
    BS = k_pool.shape[1]
    visible = visible_keys(lengths, table.shape[1], BS)
    out = merge_partials(*split_partials(q, k_pool, v_pool, table, visible,
                                         split_blocks, k_scale, v_scale))
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
    current stream: the split kernel and, when a sequence can span
    several splits, the merge kernel, from one C call. Raises on anything
    the kernel does not take and on a non-zero ``cudaGetLastError`` after
    the launches. Reads nothing back from the card."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_cuda needs CUDA tensors, got "
                         f"{q.device}")
    _check(q, k_pool, v_pool, table, lengths, k_scale, v_scale)
    B, _, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    MB = table.shape[1]
    split_blocks, n_split = split_plan(B, KV, MB, BS, _sm_count(q.device))
    out = torch.empty_like(q)
    ws_acc = ws_ml = None
    if n_split > 1:
        ws_acc = torch.empty(B * KV * n_split * H // KV * Dh,
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty(B * KV * n_split * H // KV * 2,
                            dtype=torch.float32, device=q.device)
    quant = k_scale is not None
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KIND[k_pool.dtype], _KIND[q.dtype], q.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws_acc.data_ptr() if ws_acc is not None else None,
                ws_ml.data_ptr() if ws_ml is not None else None,
                B, H, KV, Dh, BS, MB, split_blocks, n_split, stream)
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
