"""The port's CUDA kernels against their plain PyTorch versions.

The kernel tests need an NVIDIA Hopper GPU with ``nvcc`` and skip
elsewhere (a CUDA kernel has no interpret mode); on such a machine run
``python -m pytest tests/test_torch_cuda_kernels.py``. This file imports
torch and the port only, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu_torch.models import paged as tpaged
from k8s_operator_libs_tpu_torch.models.generate import generate
from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig, init_params,
                                                      param_leaves)
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.ops import attention as fa
from k8s_operator_libs_tpu_torch.ops import build
from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
from k8s_operator_libs_tpu_torch.parallel import fsdp
from k8s_operator_libs_tpu_torch.utils.device import resolve_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["paged_decode", "flash_attention",
                                  "flash_attention_tc"])
def test_library_name_tracks_source_and_flags(name):
    path = build.library_path(name)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert build.library_path(name) == path


def test_cuda_entry_points_refuse_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tpaged.init_paged_cache(LlamaConfig.tiny(), [16])


def _case(device, pool_dtype, q_dtype, lengths, H=32, KV=8, Dh=128, BS=16,
          MB=64, seed=0, poison_tail=False):
    """Ragged lengths, a shuffled table and NaN in every dead block; with
    ``poison_tail`` also in the rows past each length inside its last live
    block (the scales of those rows for int8 pools)."""
    gen = np.random.default_rng(seed)
    B = len(lengths)
    NB = B * MB + 1
    table = gen.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    live = {int(table[b, m]) for b in range(B)
            for m in range(min(lengths[b] // BS + 1, MB))}
    dead = sorted(set(range(NB)) - live)
    tail = [(int(table[b, lengths[b] // BS]), lengths[b] % BS + 1)
            for b in range(B) if poison_tail and lengths[b] // BS < MB]
    f = torch.as_tensor(gen.standard_normal((2, NB, BS, KV, Dh)),
                        dtype=torch.float32)
    q = torch.as_tensor(gen.standard_normal((B, 1, H, Dh)),
                        dtype=torch.float32).to(device, q_dtype)
    ks = vs = None
    if pool_dtype == torch.int8:
        s = f.abs().amax(-1).clamp_min(1e-12) / 127.0
        pools = torch.clamp(torch.round(f / s[..., None]), -127, 127)
        pools = pools.to(torch.int8)
        s[:, dead] = float("nan")
        for blk, row in tail:
            s[:, blk, row:] = float("nan")
        ks, vs = (x.contiguous().to(device) for x in s)
    else:
        pools = f.to(pool_dtype)
        pools[:, dead] = float("nan")
        for blk, row in tail:
            pools[:, blk, row:] = float("nan")
    k, v = (x.contiguous().to(device) for x in pools)
    return (q, k, v, torch.as_tensor(table, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device),
            ks, vs)


@pytest.mark.parametrize("pool_dtype,q_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 1e-2),
    (torch.float16, torch.float16, 2e-3),
    (torch.int8, torch.bfloat16, 1e-2),
    (torch.int8, torch.float32, 2e-5),
])
def test_kernel_matches_plain(cuda, pool_dtype, q_dtype, tol):
    """Tolerances: fp32 is summation order only; otherwise one rounding of
    the output to the working type (2^-8 relative in bf16, 2^-11 in
    fp16), scaled by max(1, |plain|)."""
    args = _case(cuda, pool_dtype, q_dtype, [0, 17, 300, 1023])
    name = "paged_decode_int8" if pool_dtype == torch.int8 else "paged_decode"
    before = attn.LAUNCHES[name]
    got = attn.paged_decode(*args)
    torch.cuda.synchronize()
    assert attn.LAUNCHES[name] == before + 1
    ref = attn.paged_decode_plain(*args)
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs()
    assert (err <= tol * ref.float().abs().clamp_min(1.0)).all(), \
        float(err.max())


@pytest.mark.parametrize("BS,Dh,G", [(8, 64, 1), (32, 256, 8), (16, 32, 2)])
def test_kernel_other_geometries(cuda, BS, Dh, G):
    KV = 2
    args = _case(cuda, torch.float32, torch.float32, [5, 0, 200],
                 H=G * KV, KV=KV, Dh=Dh, BS=BS, MB=256 // BS)
    got = attn.paged_decode(*args)
    ref = attn.paged_decode_plain(*args)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def _hold(args, tol):
    got = attn.paged_decode(*args)
    torch.cuda.synchronize()
    ref = attn.paged_decode_plain(*args)
    assert torch.isfinite(got).all(), "a row past a length leaked"
    err = (got.float() - ref.float()).abs()
    assert (err <= tol * ref.float().abs().clamp_min(1.0)).all(), \
        float(err.max())
    return got


# (pool, q, tolerance) as in test_kernel_matches_plain
SPLIT_CASES = [(torch.float32, torch.float32, 2e-5),
               (torch.bfloat16, torch.bfloat16, 1e-2),
               (torch.int8, torch.bfloat16, 1e-2)]


@pytest.mark.parametrize("pool_dtype,q_dtype,tol", SPLIT_CASES)
def test_kernel_at_split_edges(cuda, pool_dtype, q_dtype, tol):
    """Lengths 0, one short of the first split boundary (n_live ends on
    it), on it, and the whole capacity, at the split the wrapper picks
    for this card; NaN past every length in its last live block."""
    MB, BS = 64, 16
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sb, _ = attn.split_plan(4, 8, MB, BS, sms)
    lengths = [0, sb * BS - 1, sb * BS, MB * BS - 1]
    _hold(_case(cuda, pool_dtype, q_dtype, lengths, MB=MB, BS=BS,
                poison_tail=True), tol)


@pytest.mark.parametrize("pool_dtype,q_dtype,tol", SPLIT_CASES)
def test_kernel_32_ragged_sequences(cuda, pool_dtype, q_dtype, tol):
    lengths = np.random.default_rng(11).integers(0, 1024, 32).tolist()
    _hold(_case(cuda, pool_dtype, q_dtype, lengths, poison_tail=True,
                seed=2), tol)


@pytest.mark.parametrize("pool_dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.int8, torch.float32)])
def test_kernel_is_deterministic(cuda, pool_dtype, q_dtype):
    """The merge sums the splits in order, without atomics: the same bits
    on every call."""
    args = _case(cuda, pool_dtype, q_dtype, [0, 17, 300, 1023, 511] * 4)
    assert torch.equal(attn.paged_decode(*args), attn.paged_decode(*args))


def test_wrapper_reads_nothing_back_from_the_card(cuda):
    """No host synchronisation inside a call: the split comes from the
    shapes, never from the lengths on the card."""
    args = _case(cuda, torch.bfloat16, torch.bfloat16, [0, 17, 300, 1023])
    attn.paged_decode(*args)                    # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = attn.paged_decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def test_batcher_decodes_through_the_kernel(cuda):
    """The batcher's greedy tokens, decoded through A-K4, equal the
    contiguous ``generate`` (plain attention) of each prompt."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, seed=0, device=cuda)
    gen = np.random.default_rng(3)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 19, 11)]
    attn.reset_launch_counts()
    srv = ContinuousBatcher(params, cfg, max_slots=2, capacity_per_slot=48,
                            block_size=16)
    rids = [srv.submit(p, 7) for p in prompts]
    out = {}
    while not srv.idle:
        srv.step(3)
        out.update(srv.poll())
    steps = srv.decode_steps
    assert attn.LAUNCHES["paged_decode"] == cfg.n_layers * steps > 0
    for rid, p in zip(rids, prompts):
        ref = generate(params, torch.as_tensor(p[None], device=cuda), cfg,
                       max_new_tokens=7)[0].cpu().numpy()
        np.testing.assert_array_equal(out[rid], ref)


def test_speculative_batcher_drafts_through_the_kernel(cuda):
    """Draft mode on the card: every draft step runs A-K4 (k + 1 per
    round and layer, plus any plain ticks near a slot's capacity), and
    the tokens equal the plain batcher's."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, seed=0, device=cuda)
    gen = np.random.default_rng(4)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 19, 11)]
    outs = []
    for draft in ("self-int8", None):
        attn.reset_launch_counts()
        srv = ContinuousBatcher(params, cfg, max_slots=2,
                                capacity_per_slot=48, block_size=16,
                                draft=draft, spec_k=3)
        rids = [srv.submit(p, 12) for p in prompts]
        out = {}
        while not srv.idle:
            srv.step(3)
            out.update(srv.poll())
        outs.append([out[r] for r in rids])
        if draft is not None:
            assert srv.spec_rounds > 0
            assert attn.LAUNCHES["paged_decode"] == cfg.n_layers * (
                4 * srv.spec_rounds + srv.decode_steps)
    for got, ref in zip(*outs):
        np.testing.assert_array_equal(got, ref)


def test_int8_weights_and_kv_decode_through_the_kernel(cuda):
    """``paged_quantized_generate(kv_int8=True)``: A-K5 on every decode
    step and layer, tokens equal to the same call on the plain version."""
    from k8s_operator_libs_tpu_torch.models.quant import (
        paged_quantized_generate, quantize_params)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    qparams = quantize_params(init_params(cfg, seed=1, device=cuda))
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(3, 9)), dtype=torch.int32, device=cuda)
    plens = torch.as_tensor([9, 4, 7], dtype=torch.int32)
    attn.reset_launch_counts()
    got = paged_quantized_generate(qparams, prompt, cfg, max_new_tokens=10,
                                   prompt_lengths=plens, block_size=16,
                                   kv_int8=True)
    assert attn.LAUNCHES["paged_decode_int8"] == cfg.n_layers * 9
    ref = paged_quantized_generate(qparams, prompt, cfg, max_new_tokens=10,
                                   prompt_lengths=plens, block_size=16,
                                   kv_int8=True,
                                   decode_attn=attn.paged_decode_plain)
    assert torch.equal(got, ref)


# ------------------------------------------------ flash attention (A-K1-3)

def _qkv(device, dtype, B, T, H, KV, Dh, seed=0):
    gen = np.random.default_rng(seed)
    return tuple(torch.as_tensor(gen.standard_normal(s), dtype=torch.float32
                                 ).to(device, dtype)
                 for s in ((B, T, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh),
                           (B, T, H, Dh)))


def _reading(got, ref, rtol, atol):
    """The largest share of its tolerance an element uses: |got - plain| <=
    atol * row + rtol * |plain|, row the RMS of the plain row (the last
    dim), floored at 1e-2 of the tensor's RMS for rows that vanish (dq's
    first causal row). At most 1 passes."""
    ref = ref.float()
    row = ref.square().mean(-1, keepdim=True).sqrt()
    row = row.clamp_min(1e-2 * float(ref.square().mean().sqrt()))
    err = (got.float() - ref).abs()
    return float((err / (atol * row + rtol * ref.abs())).max())


# (rtol, atol, lse in nats), per element as in ``_reading``: fp32 is
# summation order over up to T terms and exp2f's 2 ulp; bf16/fp16 add the
# kernels' own roundings, which the plain version does not make: q * scale
# * log2e rounded to the storage type (the constant itself is rounded,
# 2^-9 relative in bf16), P rounded before P V and dS before dS K, and the
# output's rounding.
FLASH_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
             torch.bfloat16: (4e-2, 4e-2, 2.5e-2),
             torch.float16: (5e-3, 5e-3, 5e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,T,H,KV,Dh,causal", [
    (1, 256, 8, 2, 128, True),
    (2, 1000, 4, 4, 64, False),        # ragged T, G = 1
    (1, 333, 12, 4, 64, True),         # G = 3, ragged
    (1, 200, 16, 2, 32, True),         # G = 8, Dh 32
    (2, 130, 4, 2, 128, False),
])
def test_flash_kernels_match_plain(cuda, dtype, B, T, H, KV, Dh, causal):
    _hold_both_directions(cuda, dtype, B, T, H, KV, Dh, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_at_a_tensor_parallel_rank_shape(cuda, dtype):
    """A tensor-parallel rank's attention at Llama-3-8B width (tensor 2):
    B 1, T 2048, its H/2 = 16 query and KV/2 = 4 K/V heads, Dh 128,
    causal; the forward and both backward kernels against plain."""
    _hold_both_directions(cuda, dtype, 1, 2048, 16, 4, 128, True)


def _hold_both_directions(cuda, dtype, B, T, H, KV, Dh, causal):
    q, k, v, do = _qkv(cuda, dtype, B, T, H, KV, Dh)
    fa.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, causal)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_forward": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    ref_out, ref_lse = fa.reference_attention_with_lse(q, k, v, causal)
    # the backward is held on the forward's own out and lse, so each
    # kernel is checked on its own
    ref_grads = fa.flash_backward_plain(q, k, v, out, lse, do, causal)
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    for got in (out, lse, dq, dk, dv):
        assert torch.isfinite(got).all()
    assert float((lse - ref_lse).abs().max()) <= lse_tol
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                              (ref_out, *ref_grads)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        reading = _reading(got, ref, rtol, atol)
        assert reading <= 1.0, (name, reading)


def _hold_forward(q, k, v, causal, dtype):
    out, lse = fa.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.reference_attention_with_lse(q, k, v, causal)
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    assert out.shape == ref_out.shape and out.dtype == ref_out.dtype
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float((lse - ref_lse).abs().max()) <= lse_tol
    reading = _reading(out, ref_out, rtol, atol)
    assert reading <= 1.0, reading


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("T", [1, 63, 65, 129])
def test_tensor_core_forward_at_tile_edges(cuda, dtype, causal, Dh, G, T):
    """The wgmma forward at the edges of its 64-key tiles and 64-row
    q-tiles: one row, one short of a tile, one past, two tiles and one; G 8
    folds 8 positions per tile. out and lse against the plain version."""
    KV = 2
    q, k, v, _ = _qkv(cuda, dtype, 1, T, G * KV, KV, Dh, seed=T)
    _hold_forward(q, k, v, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("G,Dh", [(64, 64), (2, 32)])
def test_tensor_core_forward_group_of_64_and_head_dim_32(cuda, dtype, G, Dh):
    """G = 64: each position is a whole 64-row tile (BQ 1); Dh 32 runs as
    Dh 64 with zero columns."""
    q, k, v, _ = _qkv(cuda, dtype, 1, 70, G, 1, Dh, seed=6)
    _hold_forward(q, k, v, True, dtype)


def _hold_backward(q, k, v, do, causal, dtype):
    out, lse = fa.flash_forward(q, k, v, causal)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    ref = fa.flash_backward_plain(q, k, v, out, lse, do, causal)
    rtol, atol, _ = FLASH_TOL[dtype]
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.isfinite(got).all(), name
        if q.shape[1] == 1 and name != "dv":
            # one row: p = 1 and dP = delta, so dq and dk vanish but for
            # delta's fp32 rounding (~1e-7 of |dO| |out| = Dh^0.5)
            assert float(got.float().abs().max()) <= 1e-4, name
            continue
        reading = _reading(got, want, rtol, atol)
        assert reading <= 1.0, (name, reading)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("T", [1, 63, 65, 129])
def test_tensor_core_backward_at_tile_edges(cuda, dtype, causal, Dh, G, T):
    """The wgmma backward at the edges of its tiles (64 rows or keys, 32-row
    A-K3 chunks): one row, one short of a tile, one past, two tiles and
    one; G 8 folds 8 positions per A-K2 tile."""
    KV = 2
    _hold_backward(*_qkv(cuda, dtype, 1, T, G * KV, KV, Dh, seed=T), causal,
                   dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_with_an_lse_cotangent_matches_plain(cuda, dtype):
    """Ring attention's merge differentiates lse: A-K2/A-K3 take delta -
    dlse. At phase 2's training shape (B 2, T 2048, H 32, KV 8, Dh 128,
    causal), a nonzero dlse through ``flash_backward`` against
    ``flash_backward_plain`` with the same dlse; and dlse must move dq
    and dk (a kernel that ignored it would pass the plain check without
    it only if dlse did nothing)."""
    q, k, v, do = _qkv(cuda, dtype, 2, 2048, 32, 8, 128, seed=9)
    out, lse = fa.flash_forward(q, k, v, True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dlse = torch.randn(lse.shape, generator=gen, device=cuda)
    fa.reset_launch_counts()
    got = fa.flash_backward(q, k, v, out, lse, do, True, dlse)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_forward": 0, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    ref = fa.flash_backward_plain(q, k, v, out, lse, do, True, dlse)
    without = fa.flash_backward_plain(q, k, v, out, lse, do, True)
    rtol, atol, _ = FLASH_TOL[dtype]
    for name, g, want, w0 in zip(("dq", "dk", "dv"), got, ref, without):
        assert torch.isfinite(g).all(), name
        reading = _reading(g, want, rtol, atol)
        assert reading <= 1.0, (name, reading)
        if name != "dv":            # dv = P^T dO takes no dlse
            assert _reading(w0, want, rtol, atol) > 1.0, name
    del ref, without


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_backward_group_of_64(cuda, dtype):
    """G = 64: each position is a whole 64-row A-K2 tile."""
    _hold_backward(*_qkv(cuda, dtype, 1, 70, 64, 1, 64, seed=5), True, dtype)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float16, "wgmma"),
                                         (torch.float32, "fma")])
def test_backward_takes_the_route_of_its_dtype(cuda, dtype, route):
    """bf16/fp16 launches, forward and backward, go to
    flash_attention_tc.cu's entry points, fp32 ones to flash_attention.cu's
    FMA kernels."""
    q, k, v, do = _qkv(cuda, dtype, 1, 96, 8, 2, 64)
    fa.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {"wgmma": 0, "fma": 0, route: 1}
    assert fa.LAUNCHES == {"flash_forward": 1, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}
    fa.reset_launch_counts()
    fa.flash_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {"wgmma": 0, "fma": 0, route: 2}
    assert fa.LAUNCHES == {"flash_forward": 0, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


def test_flash_kernels_are_deterministic(cuda):
    q, k, v, do = _qkv(cuda, torch.bfloat16, 1, 300, 8, 2, 128, seed=1)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, True)
        runs.append((out, lse, *fa.flash_backward(q, k, v, out, lse, do)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _qkv(cuda, torch.bfloat16, 1, 64, 4, 2, 128)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward_cuda(q[..., :96].contiguous(),
                              k[..., :96].contiguous(),
                              v[..., :96].contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_forward_cuda(q, k.float(), v)


def test_training_through_the_kernels_matches_plain(cuda):
    """One step's loss and gradients on ``tiny`` (Dh 32, G 2) with remat:
    through A-K1/A-K2/A-K3 (each launched once per layer) against the
    plain attention, fp32 with TF32 off: summation order only, 1e-5 of
    the loss and 1e-3 of each leaf's largest gradient."""
    cfg = LlamaConfig.tiny(dtype=torch.float32, remat=True)
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 65)), dtype=torch.int32, device=cuda)
    runs = {}
    for name, attn_fn in (("kernels", None), ("plain", fa.reference_attention)):
        fa.reset_launch_counts()
        runs[name] = fsdp.value_and_grad(
            lambda p, t: fsdp.causal_lm_loss(p, t, cfg, attn_fn), params,
            tokens)
        want = cfg.n_layers if attn_fn is None else 0
        assert fa.LAUNCHES == {n: want for n in fa.LAUNCHES}
    (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(param_leaves(gk), param_leaves(gp)):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_f32_product_on_the_card_keeps_fp32(cuda):
    """The MoE's fp32-output product of bf16 operands (cuBLAS's
    ``out_dtype`` path): the same fp32 sums as the upcast product, to
    fp32 summation order (1e-5 of the largest |product|), where a bf16
    result would be off by ~2^-9 relative; its backward rounds the
    cotangent to bf16 and returns bf16 gradients."""
    from k8s_operator_libs_tpu_torch.models.moe import f32_product
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(64, 4096, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(4096, 512, generator=g, device=cuda).to(torch.bfloat16)
    a.requires_grad_()
    b.requires_grad_()
    out = f32_product(a, b)
    want = a.detach().double() @ b.detach().double()
    assert out.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((out.double() - want).abs().max()) <= 1e-5 * scale
    assert float(((a @ b).double() - want).abs().max()) > 1e-3 * scale
    grad = torch.randn(64, 512, generator=g, device=cuda)
    out.backward(grad)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    torch.testing.assert_close(a.grad, grad.bfloat16() @ b.detach().t())
    torch.testing.assert_close(b.grad, a.detach().t() @ grad.bfloat16())


def test_moe_training_and_decode_run_the_kernels(cuda):
    """``MoEConfig.tiny`` in bf16 (Dh 32) with remat: one training step
    launches A-K1/A-K2/A-K3 once per layer on the tensor cores; fp32: the
    MoE batcher's greedy tokens through A-K4 (n_layers launches per
    decode step) equal ``moe_generate``'s."""
    from k8s_operator_libs_tpu_torch.models import moe
    from k8s_operator_libs_tpu_torch.parallel.expert import \
        moe_reference_loss
    cfg = moe.MoEConfig.tiny(remat=True)
    params = moe.init_params(cfg, seed=0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 129)), dtype=torch.int32, device=cuda)
    opt = fsdp.default_optimizer()
    state = fsdp.TrainState(params=params, opt_state=opt.init(params),
                            step=0)
    fa.reset_launch_counts()
    state, m = fsdp.make_train_step_from_loss(moe_reference_loss(cfg),
                                              opt)(state, tokens)
    assert np.isfinite(float(m["loss"]))
    assert fa.LAUNCHES == {n: cfg.n_layers for n in fa.LAUNCHES}
    assert fa.ROUTE_LAUNCHES == {"wgmma": 3 * cfg.n_layers, "fma": 0}

    cfg = moe.MoEConfig.tiny(dtype=torch.float32)
    params = moe.init_params(cfg, seed=1, device=cuda)
    attn.reset_launch_counts()
    srv = ContinuousBatcher(params, cfg, max_slots=2, capacity_per_slot=64,
                            block_size=8, forward=moe.moe_paged_forward)
    prompts = [np.arange(1, 1 + n, dtype=np.int32) * 7 % 512
               for n in (5, 11)]
    rids = [srv.submit(p, 8) for p in prompts]
    out = {}
    while not srv.idle:
        srv.step(3)
        out.update(srv.poll())
    assert attn.LAUNCHES["paged_decode"] == \
        cfg.n_layers * srv.decode_steps > 0
    for rid, p in zip(rids, prompts):
        solo = moe.moe_generate(params, torch.as_tensor(p[None]), cfg,
                                max_new_tokens=8)[0].cpu().numpy()
        np.testing.assert_array_equal(out[rid], solo)
