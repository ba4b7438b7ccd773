"""The port's paged decode path against the JAX reference on the CPU.

- the plain versions of the paged-decode kernels (A-K4 bf16/fp32 pools,
  A-K5 int8 pools) against the reference's Pallas kernels run in
  interpret mode, at head_dim 128, with ragged lengths and NaN in every
  dead block, and at bf16, fp16 and int8-with-bf16-q, where both round
  the P V weights the same way;
- ``paged_generate`` (ragged prompts, int8 KV) and the contiguous
  ``generate`` greedy token-identical to the reference on ``tiny`` fp32,
  from the reference's own weights carried over by ``convert.py``;
- the KV wire payload byte-identical in both directions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import generate as jgen
from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models import paged as tpaged
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.ops import paged_attention as tattn

# head_dim 128: the shape the reference's kernel dispatch accepts
KCFG = JConfig.tiny(d_model=512, n_heads=4, n_kv_heads=2, dtype=jnp.float32)
JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once: keep torch's CPU
    thread pool small so these tests do not crowd out timing-sensitive
    tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    tree = jax.device_get(init_params(jax.random.PRNGKey(0), JCFG))
    return tree, convert.to_torch(tree, device="cpu")


def _pools(rng, lengths, nb=16, bs=8, mb=4, kv=2, dh=128):
    """Random pools, a table of distinct shuffled block ids, and NaN in
    every block no sequence's live prefix reaches."""
    B = len(lengths)
    k_pool = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    table = rng.permutation(nb)[:B * mb].reshape(B, mb).astype(np.int32)
    live = {int(table[b, m]) for b in range(B)
            for m in range(int(lengths[b]) // bs + 1)}
    dead = sorted(set(range(nb)) - live)
    return k_pool, v_pool, table, dead


def _quant(pool):
    s = np.maximum(np.abs(pool).max(axis=-1) / 127.0, 1e-12)
    q8 = np.clip(np.round(pool / s[..., None]), -127, 127)
    return q8.astype(np.int8), s.astype(np.float32)


def _jax_kernel(q, k_pool, v_pool, table, lengths, ks=None, vs=None):
    jpaged.INTERPRET = True
    try:
        extra = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
        return np.asarray(jpaged._attend_paged_kernel(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(table), jnp.asarray(lengths), *extra))
    finally:
        jpaged.INTERPRET = False


@pytest.mark.parametrize("lengths", [[0, 17, 31], [3, 9, 30]])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_paged_decode_matches_reference_kernel(lengths, int8):
    rng = np.random.default_rng(sum(lengths) + int8)
    lengths = np.asarray(lengths, np.int32)
    k_pool, v_pool, table, dead = _pools(rng, lengths)
    H, Dh = KCFG.n_heads, KCFG.head_dim
    q = rng.standard_normal((len(lengths), 1, H, Dh)).astype(np.float32)
    ks = vs = None
    if int8:
        k_pool, ks = _quant(k_pool)
        v_pool, vs = _quant(v_pool)
        ks[dead] = np.nan
        vs[dead] = np.nan
    else:
        k_pool[dead] = np.nan
        v_pool[dead] = np.nan
    ref = _jax_kernel(q, k_pool, v_pool, table, lengths, ks, vs)
    t = [torch.as_tensor(a) for a in (q, k_pool, v_pool, table, lengths)]
    ts = [None, None] if ks is None else [torch.as_tensor(ks),
                                          torch.as_tensor(vs)]
    before = dict(tattn.LAUNCHES)
    got = tattn.paged_decode(*t, *ts).numpy()
    assert tattn.LAUNCHES == before        # the CPU runs no kernel
    assert np.isfinite(got).all(), "a dead block leaked into the output"
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("split_blocks", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_split_plain_matches_reference_kernel(split_blocks, int8):
    """The kernel's split and merge, in plain PyTorch, against the
    reference kernel and the unsplit plain version (2e-5, fp32 summation
    order). Lengths 0, one short of a split boundary (n_live ends exactly
    on it), on it, and the full capacity; split 4 is the whole table
    (one split), split 8 wider than it."""
    bs, mb = 8, 4
    cap = bs * mb
    lengths = np.asarray([0, min(split_blocks * bs - 1, cap - 1),
                          min(split_blocks * bs, cap - 1), cap - 1],
                         np.int32)
    rng = np.random.default_rng(10 * split_blocks + int8)
    k_pool, v_pool, table, dead = _pools(rng, lengths, nb=20, bs=bs, mb=mb)
    q = rng.standard_normal((len(lengths), 1, KCFG.n_heads,
                             KCFG.head_dim)).astype(np.float32)
    ks = vs = None
    if int8:
        k_pool, ks = _quant(k_pool)
        v_pool, vs = _quant(v_pool)
        ks[dead] = np.nan
        vs[dead] = np.nan
    else:
        k_pool[dead] = np.nan
        v_pool[dead] = np.nan
    ref = _jax_kernel(q, k_pool, v_pool, table, lengths, ks, vs)
    t = [torch.as_tensor(a) for a in (q, k_pool, v_pool, table, lengths)]
    ts = [None, None] if ks is None else [torch.as_tensor(ks),
                                          torch.as_tensor(vs)]
    got = tattn.paged_decode_split_plain(*t, *ts,
                                         split_blocks=split_blocks).numpy()
    assert np.isfinite(got).all(), "a dead block leaked into the output"
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, tattn.paged_decode_plain(*t, *ts).numpy(),
                               rtol=2e-5, atol=2e-5)


# The weights meet V rounded as the reference kernel rounds them: p to the
# pool dtype (bf16, fp16), int8's p * vs to q's dtype. The two sides still
# round p against different maxima (the reference's running max, the
# plain version's split max) and sum in different orders, then round the
# output once each: hold every element to two output ulps at |x| in
# [1, 2) (bf16 2^-6, fp16 2^-9), scaled by max(1, |reference|). With
# int8 pools the rounding of p * vs also shows as the share of outputs
# that are the reference's very bits: at least 80% on these seeds (about
# 65% without the rounding).
ROUNDING_CASES = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9,
                  "int8": 2.0 ** -6}


@pytest.mark.parametrize("split_blocks", [None, 1, 2])
@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_plain_paged_decode_rounds_like_reference_kernel(case,
                                                         split_blocks):
    lengths = np.asarray([0, 17, 31, 25], np.int32)
    rng = np.random.default_rng(len(case))
    k_pool, v_pool, table, _ = _pools(rng, lengths, nb=24)
    q = 2 * rng.standard_normal((len(lengths), 1, KCFG.n_heads,
                                 KCFG.head_dim)).astype(np.float32)
    if case == "int8":
        q = np.asarray(jnp.asarray(q, jnp.bfloat16))
        k_pool, ks = _quant(k_pool)
        v_pool, vs = _quant(v_pool)
        scales = (ks, vs)
    else:
        q, k_pool, v_pool = (np.asarray(jnp.asarray(a, jnp.dtype(case)))
                             for a in (q, k_pool, v_pool))
        scales = (None, None)
    ref = _jax_kernel(q, k_pool, v_pool, table, lengths, *scales)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    t = [convert.tensor_from_numpy(np.asarray(a))
         for a in (q, k_pool, v_pool, table, lengths)]
    ts = [None if a is None else torch.as_tensor(a) for a in scales]
    if split_blocks is None:
        got = tattn.paged_decode_plain(*t, *ts)
    else:
        got = tattn.paged_decode_split_plain(*t, *ts,
                                             split_blocks=split_blocks)
    assert got.dtype == t[0].dtype
    got = got.float().numpy()
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= ROUNDING_CASES[case], float(err.max())
    if case == "int8":
        assert (got == ref).mean() >= 0.8


@pytest.mark.parametrize("BS", [8, 16, 32])
def test_split_plan_puts_every_block_in_one_split(BS):
    """For every MB up to 256: splits of at most MAX_SPLIT_KEYS keys that
    partition the table row, none of them always empty, so every live
    block, whatever the length, lies in exactly one split."""
    for MB in range(1, 257):
        for B, KV, sms in ((1, 1, 132), (4, 8, 132), (32, 8, 132),
                           (2, 2, 1)):
            sb, n = tattn.split_plan(B, KV, MB, BS, sms)
            assert type(sb) is int and type(n) is int
            assert 1 <= sb and sb * BS <= tattn.MAX_SPLIT_KEYS
            assert (n - 1) * sb < MB <= n * sb
            owner = [m // sb for m in range(MB)]
            assert all(owner.count(i) == min(sb, MB - i * sb)
                       for i in range(n))


def test_split_plan_fills_the_card_at_the_serving_shape():
    """Llama-3-8B decode (B 4, KV 8, capacity 1024, block 16) on 132 SMs,
    lengths 0/17/300/1023: at least two live CTAs per SM."""
    sb, n = tattn.split_plan(4, 8, 64, 16, 132)
    live = sum(-(-(length // 16 + 1) // sb) for length in (0, 17, 300, 1023))
    assert (sb, n) == (2, 32)
    assert live * 8 >= 2 * 132


@pytest.mark.parametrize("bad", ["tensor", np.int64(4), 4.0, True, 0])
def test_split_plan_takes_positive_ints_only(bad):
    """A tensor (the lengths' kind) would mean a host sync per layer."""
    if isinstance(bad, str):        # made here: no tensor at collection
        bad = torch.tensor(4)
    with pytest.raises(TypeError):
        tattn.split_plan(bad, 8, 64, 16, 132)


def test_paged_decode_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(5)
    k_pool, v_pool, table, _ = _pools(rng, [3])
    q = torch.zeros((1, 1, 4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.paged_decode_cuda(q, torch.as_tensor(k_pool),
                                torch.as_tensor(v_pool),
                                torch.as_tensor(table),
                                torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("kv_int8", [False, True])
def test_paged_generate_ragged_token_identical(weights, kv_int8):
    tree, params = weights
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, JCFG.vocab_size, size=(3, 12)).astype(np.int32)
    plens = np.asarray([12, 5, 9], np.int32)
    ref = np.asarray(jpaged.paged_generate(
        tree, jnp.asarray(prompt), JCFG, max_new_tokens=10,
        prompt_lengths=jnp.asarray(plens), block_size=8, kv_int8=kv_int8))
    got = tpaged.paged_generate(
        params, torch.as_tensor(prompt), TCFG, max_new_tokens=10,
        prompt_lengths=torch.as_tensor(plens), block_size=8,
        kv_int8=kv_int8).numpy()
    np.testing.assert_array_equal(got, ref)


def test_generate_token_identical(weights):
    tree, params = weights
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, JCFG.vocab_size, size=(2, 9)).astype(np.int32)
    ref = np.asarray(jgen.generate(tree, jnp.asarray(prompt), JCFG,
                                   max_new_tokens=12))
    got = tgen.generate(params, torch.as_tensor(prompt), TCFG,
                        max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, ref)
    # the paged path agrees with its contiguous oracle
    paged = tpaged.paged_generate(params, torch.as_tensor(prompt), TCFG,
                                  max_new_tokens=12, block_size=8).numpy()
    np.testing.assert_array_equal(paged, got)


def test_filter_logits_matches_reference_tie_rule():
    logits = np.asarray([[3.0, 1.0, 3.0, 2.0, 2.0, 0.5],
                         [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]], np.float32)
    for top_k, top_p in ((2, None), (None, 0.5), (3, 0.9), (1, None)):
        ref = np.asarray(jgen.filter_logits(jnp.asarray(logits), top_k,
                                            top_p))
        got = tgen.filter_logits(torch.as_tensor(logits), top_k,
                                 top_p).numpy()
        np.testing.assert_array_equal(got, ref)


def test_sampled_generate_is_seeded_and_in_vocab(weights):
    _, params = weights
    prompt = torch.as_tensor(np.arange(6, dtype=np.int32)[None])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tpaged.paged_generate(params, prompt, TCFG, max_new_tokens=8,
                                     temperature=0.8, generator=gen,
                                     top_k=20, block_size=8)

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert a.shape == (1, 14) and int(a.max()) < TCFG.vocab_size


@pytest.mark.parametrize("quant", [False, True])
def test_kv_payload_wire_identical_both_ways(quant):
    """A payload encoded by either package decodes in the other to the
    same bytes, and re-encodes to the same JSON object."""
    rng = np.random.default_rng(9)
    L, NB, BS, KV, Dh = 2, 9, 8, 2, 32
    dtype = "int8" if quant else "bfloat16"
    f = rng.standard_normal((L, NB, BS, KV, Dh)).astype(np.float32)
    if quant:
        k_np = np.clip(np.round(f * 40), -127, 127).astype(np.int8)
        v_np = k_np[::-1].copy()
        ks_np = rng.random((L, NB, BS, KV)).astype(np.float32)
        vs_np = rng.random((L, NB, BS, KV)).astype(np.float32)
    else:
        k_np = np.asarray(jnp.asarray(f, jnp.bfloat16))
        v_np = np.asarray(jnp.asarray(f * 2, jnp.bfloat16))
        ks_np = vs_np = None
    row = np.asarray([4, 7, 1, 8], np.int32)
    jscale = {} if not quant else {"k_scale": ks_np, "v_scale": vs_np}
    jpl = jpaged.export_slot_kv(k_np, v_np, row, 27, start=8, **jscale)
    t = {n: convert.tensor_from_numpy(a) for n, a in
         (("k", k_np), ("v", v_np), ("ks", ks_np), ("vs", vs_np))
         if a is not None}
    tscale = {} if not quant else {"k_scale": t["ks"], "v_scale": t["vs"]}
    tpl = tpaged.export_slot_kv(t["k"], t["v"], row, 27, start=8, **tscale)
    assert tpl["dtype"] == dtype
    j_wire = json.loads(json.dumps(jpaged.encode_kv_payload(jpl)))
    t_wire = json.loads(json.dumps(tpaged.encode_kv_payload(tpl)))
    assert j_wire == t_wire
    assert tpaged.kv_payload_nbytes(tpl) == jpaged.kv_payload_nbytes(jpl)
    # JAX wire -> torch pools, torch wire -> JAX pools
    dst = np.asarray([2, 3, 5, 6], np.int32)
    tk = torch.zeros_like(t["k"])
    tv = torch.zeros_like(t["v"])
    tks = torch.zeros(L, NB, BS, KV) if quant else None
    tvs = torch.zeros(L, NB, BS, KV) if quant else None
    *_, length = tpaged.import_slot_kv(
        tk, tv, dst, tpaged.decode_kv_payload(j_wire), start=8,
        k_scale=tks, v_scale=tvs)
    zk = np.zeros_like(k_np)
    jk, jv, jks, _, jlen = jpaged.import_slot_kv(
        zk, np.zeros_like(v_np), dst, jpaged.decode_kv_payload(t_wire),
        start=8, k_scale=None if not quant else np.zeros_like(ks_np),
        v_scale=None if not quant else np.zeros_like(vs_np))
    assert length == jlen == 27
    assert convert.tensor_to_numpy(tk).tobytes() == \
        np.asarray(jk).tobytes()
    assert convert.tensor_to_numpy(tv).tobytes() == \
        np.asarray(jv).tobytes()
    if quant:
        assert tks.numpy().tobytes() == np.asarray(jks).tobytes()
    with pytest.raises(tpaged.KVPayloadError):
        tpaged.import_slot_kv(tk, tv, dst, dict(tpl, version=2), start=8,
                              k_scale=tks, v_scale=tvs)
