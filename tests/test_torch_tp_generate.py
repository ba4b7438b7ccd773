"""The port's tensor-parallel decoding (``models/generate.py``:
``make_tp_generate``, ``tp_generate_param_specs``) against the JAX
package's on the same weights: 2 gloo ranks in fp32 must give the tokens
of JAX's ``make_tp_generate`` (2 virtual CPU devices) and of the one-rank
``generate`` of both packages, as the reference's own test requires
(``tests/test_data_and_generate.py:361-381``). The rank bodies are in
``torch_parallel_ranks.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import generate as jgen
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.parallel import launch

GROUP_TIMEOUT = 120.0
TP = 2
MAX_NEW = 16
PROMPT_SHAPE = (2, 12)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """The reference test's inputs (tiny fp32, PRNGKey 0 weights, a
    [2, 12] prompt, 16 new tokens) through JAX's one-device and
    tensor-parallel decode, the port's one-rank ``generate`` and the
    port's tensor-parallel decode on 2 gloo ranks."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), cfg))
    prompt = np.array(jax.random.randint(
        jax.random.PRNGKey(1), PROMPT_SHAPE, 0, cfg.vocab_size,
        dtype=jnp.int32))
    mesh = jmake_mesh(tensor=TP, fsdp=1, devices=jax.devices()[:TP])
    out = {
        "jax": np.asarray(jgen.generate(tree, prompt, cfg,
                                        max_new_tokens=MAX_NEW)),
        "jax_tp": np.asarray(jgen.make_tp_generate(
            cfg, mesh, max_new_tokens=MAX_NEW)(tree, prompt)),
        "port": tgen.generate(convert.to_torch(tree, device="cpu"),
                              torch.as_tensor(prompt),
                              tllama.LlamaConfig.tiny(dtype=torch.float32),
                              max_new_tokens=MAX_NEW).numpy(),
    }
    out["ranks"] = launch.run(ranks.tp_generate, TP, tree, prompt, MAX_NEW,
                              timeout=GROUP_TIMEOUT,
                              workdir=str(tmp_path_factory.mktemp("tp")))
    return out


def test_tp_decode_matches_jax_and_one_rank(decoded):
    np.testing.assert_array_equal(decoded["jax_tp"], decoded["jax"])
    np.testing.assert_array_equal(decoded["port"], decoded["jax"])
    for r, res in enumerate(decoded["ranks"]):
        np.testing.assert_array_equal(res["tokens"], decoded["jax_tp"],
                                      err_msg=f"rank {r}")


def test_tp_decode_shards_the_cache_and_sums_twice_per_block(decoded):
    """Each rank's KV cache holds KV/tp heads; every forward sums two
    [B, T, d_model] fp32 outputs per block over the tensor group (the
    prefill at T = 12, then MAX_NEW - 1 single-token steps), each
    all-reduce booked at 2 (n - 1)/n of its bytes."""
    cfg = tllama.LlamaConfig.tiny()
    B, Tp = PROMPT_SHAPE
    forwards_tokens = Tp + (MAX_NEW - 1)
    want_bytes = (2 * cfg.n_layers * B * forwards_tokens * cfg.d_model * 4
                  * 2 * (TP - 1) // TP)
    for res in decoded["ranks"]:
        assert res["cache_shape"] == (cfg.n_layers, B, Tp + MAX_NEW,
                                      cfg.n_kv_heads // TP, cfg.head_dim)
        assert res["psum_calls"] == 2 * cfg.n_layers * MAX_NEW
        assert res["psum_bytes"] == want_bytes


def test_tp_param_specs_follow_the_reference():
    """The port's specs are the reference's PartitionSpecs, entry for
    entry."""
    ref = jgen.tp_generate_param_specs()
    got = tgen.tp_generate_param_specs()
    flat = jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == 3 + len(got["blocks"])
    for path, spec in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(spec) == node, path


@pytest.mark.parametrize("sizes", [dict(n_heads=3, n_kv_heads=3),
                                   dict(n_heads=4, n_kv_heads=1),
                                   dict(d_ff=255)])
def test_tp_decode_rejects_indivisible_heads_or_ffn(sizes):
    """Both packages refuse heads, KV heads or d_ff that the tensor axis
    does not divide, with the same message."""
    mesh = jmake_mesh(tensor=TP, fsdp=1, devices=jax.devices()[:TP])
    with pytest.raises(ValueError, match="not divisible") as ref:
        jgen.make_tp_generate(jllama.LlamaConfig.tiny(**sizes), mesh)
    with pytest.raises(ValueError, match="not divisible") as got:
        tgen.make_tp_generate(tllama.LlamaConfig.tiny(**sizes),
                              ranks.fake_mesh(tensor=TP, fsdp=1))
    assert str(got.value) == str(ref.value)
