"""The port's int8 weights (``k8s_operator_libs_tpu_torch/models/quant.py``)
against the JAX reference on the CPU, on the reference's own weights
carried over by ``convert.py``:

- ``quantize_params`` bit-identical (int8 values and fp32 scales) for
  fp32 and bf16 trees;
- ``dequantize_params`` and ``_qmat`` within stated tolerances;
- greedy ``quantized_generate`` and ``paged_quantized_generate`` (float
  and int8 KV) token-identical in fp32, the int8-KV reference through its
  Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu.models import quant as jquant
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import quant as tquant
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.models.llama import param_leaves
from k8s_operator_libs_tpu_torch.ops import paged_attention as tattn

MATS = jquant._BLOCK_MATS


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _trees(dtype, seed=0, **overrides):
    jcfg = JConfig.tiny(dtype=jnp.dtype(dtype), **overrides)
    tree = jax.device_get(init_params(jax.random.PRNGKey(seed), jcfg))
    return tree, convert.to_torch(tree, device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


@pytest.fixture(scope="module")
def fp32_weights():
    tree, params = _trees("float32")
    return tree, params, jax.device_get(jquant.quantize_params(tree)), \
        tquant.quantize_params(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_identical(dtype):
    """Same int8 values and the same fp32 scale bits; the bf16 tree goes
    through the reference's bf16 max / 127 and bf16 w / s."""
    tree, params = _trees(dtype)
    ref = jax.device_get(jquant.quantize_params(tree))
    got = tquant.quantize_params(params)
    for name in MATS:
        for part, dt in (("q", torch.int8), ("s", torch.float32)):
            g = got["blocks"][name][part]
            assert g.dtype == dt, (name, part)
            np.testing.assert_array_equal(
                _bits(g.numpy()), _bits(ref["blocks"][name][part]),
                err_msg=f"{name}.{part}")
    for part in ("q", "s"):
        np.testing.assert_array_equal(_bits(got["lm_head"][part].numpy()),
                                      _bits(ref["lm_head"][part]))
    # the embedding and the norms are kept, not copied
    assert got["embed"] is params["embed"]
    assert got["blocks"]["attn_norm"] is params["blocks"]["attn_norm"]


def test_quantize_params_keeps_all_zero_columns_finite():
    w = torch.zeros((2, 8, 4))
    w[:, :, 1] = torch.linspace(-1, 1, 8)
    q, s = tquant._quantize_mat(w)
    jq, js = jquant._quantize_mat(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.isfinite(s).all() and (q[:, :, 0] == 0).all()


def test_dequantize_params_within_half_a_step(fp32_weights):
    """q * s recovers each weight to half a quantization step (s / 2,
    plus fp32 rounding), and equals JAX's dequantization to 1e-7."""
    _, params, jq, tq = fp32_weights
    ref = jax.device_get(jquant.dequantize_params(jq))
    got = tquant.dequantize_params(tq)
    for name in MATS:
        g = got["blocks"][name]
        s = tq["blocks"][name]["s"][..., None, :]
        assert (g - params["blocks"][name]).abs().le(
            0.5 * s * (1 + 1e-6)).all(), name
        np.testing.assert_allclose(g.numpy(), ref["blocks"][name],
                                   rtol=1e-7, atol=0)
    np.testing.assert_allclose(got["lm_head"].numpy(), ref["lm_head"],
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2.0 ** -7)])
def test_qmat_matches_reference(dtype, tol):
    """x @ q then the row scale, in x's dtype: fp32 summation order, or
    for bf16 the product's and the scale's roundings (one bf16 ulp each,
    2^-8 relative), relative to max |y|."""
    tree, params = _trees(dtype)
    jq = jax.device_get(jquant.quantize_params(tree))
    tq = tquant.quantize_params(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = convert.tensor_from_numpy(np.asarray(jx))
    for name in ("wq", "w_gate"):
        jm = jax.tree_util.tree_map(lambda a: a[0], jq["blocks"][name])
        tm = {k: v[0] for k, v in tq["blocks"][name].items()}
        ref = np.asarray(jquant._qmat(jx, jm).astype(jnp.float32))
        got = tquant._qmat(tx, tm)
        assert got.dtype == tx.dtype
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), (name, err)


def test_size_accounting_matches_reference(fp32_weights):
    tree, params, jq, tq = fp32_weights
    assert tquant.quantized_size_bytes(tq) == \
        jquant.quantized_size_bytes(jq)
    assert tquant.stream_bytes(tq) == jquant.stream_bytes(jq)
    assert tquant.stream_bytes(params) == jquant.stream_bytes(tree)
    for kv, batch in ((0.0, 1), (4096.0, 8)):
        assert tquant.expected_speedup(params, tq, kv, batch) == \
            pytest.approx(jquant.expected_speedup(tree, jq, kv, batch),
                          rel=1e-12)
    assert sum(1 for _ in param_leaves(tq)) == \
        len(jax.tree_util.tree_leaves(jq))


def test_quantized_generate_token_identical(fp32_weights):
    _, _, jq, tq = fp32_weights
    cfg_j, cfg_t = JConfig.tiny(dtype=jnp.float32), \
        TConfig.tiny(dtype=torch.float32)
    prompt = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, size=(2, 9)).astype(np.int32)
    ref = np.asarray(jquant.quantized_generate(jq, jnp.asarray(prompt),
                                               cfg_j, max_new_tokens=12))
    got = tquant.quantized_generate(tq, torch.as_tensor(prompt), cfg_t,
                                    max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_paged_quantized_generate_token_identical(kv_int8):
    """Ragged prompts at head_dim 128, fp32. The int8-KV reference runs
    its Pallas decode kernel (A-K5) in interpret mode; the port's
    decode steps count no kernel launch on the CPU."""
    tree, params = _trees("float32", d_model=512, n_heads=4, n_kv_heads=2)
    jq = jax.device_get(jquant.quantize_params(tree))
    tq = tquant.quantize_params(params)
    cfg_j = JConfig.tiny(dtype=jnp.float32, d_model=512, n_heads=4,
                         n_kv_heads=2)
    cfg_t = TConfig.tiny(dtype=torch.float32, d_model=512, n_heads=4,
                         n_kv_heads=2)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg_j.vocab_size, size=(3, 11)).astype(np.int32)
    plens = np.asarray([11, 4, 8], np.int32)
    jpaged.INTERPRET = kv_int8
    try:
        ref = np.asarray(jquant.paged_quantized_generate(
            jq, jnp.asarray(prompt), cfg_j, max_new_tokens=9,
            prompt_lengths=jnp.asarray(plens), block_size=8,
            kv_int8=kv_int8))
    finally:
        jpaged.INTERPRET = False
    before = dict(tattn.LAUNCHES)
    got = tquant.paged_quantized_generate(
        tq, torch.as_tensor(prompt), cfg_t, max_new_tokens=9,
        prompt_lengths=torch.as_tensor(plens), block_size=8,
        kv_int8=kv_int8).numpy()
    assert tattn.LAUNCHES == before
    np.testing.assert_array_equal(got, ref)
