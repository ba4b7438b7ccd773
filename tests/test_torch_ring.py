"""Sequence parallelism of the port against the JAX package on the CPU:
the gradient through ``flash_attention_with_lse``'s lse (which ring
attention's merge differentiates), ring and Ulysses attention (output and
q/k/v gradients) at 2 and 4 ranks against ``make_ring_attention`` /
``make_ulysses_attention``, and the sequence-parallel loss and every
gradient of it against ``make_sp_loss``.

The port runs in gloo ranks started by ``launch.run`` (one group per rank
count for the whole file, ``GROUP_TIMEOUT`` each); the JAX side runs in
this process on the virtual CPU devices of ``tests/conftest.py``. fp32
throughout; the bound is ``tests/test_torch_train.py``'s: rtol 1e-4 and
atol 1e-5 of the tensor's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.ops import attention as jattn
from k8s_operator_libs_tpu.parallel.long_context import make_sp_loss
from k8s_operator_libs_tpu.parallel.mesh import make_mesh
from k8s_operator_libs_tpu.parallel.ring_attention import make_ring_attention
from k8s_operator_libs_tpu.parallel.ulysses import make_ulysses_attention
from k8s_operator_libs_tpu_torch.ops import attention as tattn
from k8s_operator_libs_tpu_torch.parallel import launch

GROUP_TIMEOUT = 120.0
B, T, H, KV, DH = 2, 32, 4, 2, 16
ATTN_CASES = [("ring", True), ("ring", False), ("ulysses", True)]
SP_LOCAL = 8                 # tokens per rank in the SP loss


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max(), err_msg=name)


def _attn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, DH)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, DH)).astype(np.float32)
    do = rng.standard_normal((B, T, H, DH)).astype(np.float32)
    return q, k, v, do


def _sp_setup(n):
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(3), cfg))
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, n * SP_LOCAL + 1)).astype(np.int32)
    return cfg, tree, tokens


def _group(n, tmp_path_factory):
    """One group of n ranks: the attention cases and the SP loss."""
    _, tree, tokens = _sp_setup(n)
    results = launch.run(ranks.attention_and_sp_loss, n, ATTN_CASES,
                         *_attn_inputs(), ["ring", "ulysses"], tree, tokens,
                         timeout=GROUP_TIMEOUT,
                         workdir=str(tmp_path_factory.mktemp("rdv")))
    return [r[0] for r in results], [r[1] for r in results]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {n: _group(n, tmp_path_factory) for n in (2, 4)}


# ------------------------------------------------------------ lse gradient

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("a,b", [(1.0, 1.0), (0.0, 1.0), (0.5, -2.0)])
def test_lse_gradient_matches_reference(causal, a, b):
    """d/d(q, k, v) of a * sum(out) + b * sum(lse) through the port's
    ``flash_attention_with_lse`` (plain versions on the CPU) against
    ``jax.grad`` of the reference's, GQA H 4 / KV 2. With b != 0 the
    gradient flows through lse: dS = P (dP - (delta - dlse))."""
    q, k, v, _ = _attn_inputs(1)

    def jloss(q, k, v):
        out, lse = jattn.flash_attention_with_lse(q, k, v, causal=causal)
        return a * out.sum() + b * lse.sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out, lse = tattn.flash_attention_with_lse(qt, kt, vt, causal=causal)
    assert tuple(lse.shape) == (B, H, T, 1)
    (a * out.sum() + b * lse.sum()).backward()
    for name, got, r in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        _close(got.numpy(), np.asarray(r), f"d{name}")


# ------------------------------------------------------------ attention

def _jax_attention(n, impl, causal, q, k, v, do):
    mesh = make_mesh(fsdp=1, seq=n, devices=jax.devices()[:n])
    make = make_ring_attention if impl == "ring" else make_ulysses_attention
    fn = make(mesh, causal=causal)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(do))))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl,causal", ATTN_CASES)
def test_attention_matches_reference(groups, n, impl, causal):
    """Output and q/k/v gradients of the whole sequence, assembled from
    the ranks' chunks. Ulysses at n 4 takes the KV < n path (K/V repeated
    to n heads). Each rank's flash calls: the ring's r + 1 blocks when
    causal (n when not), Ulysses one."""
    attn, _ = groups[n]
    q, k, v, do = _attn_inputs()
    ref = _jax_attention(n, impl, causal, q, k, v, do)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[(impl, causal)][name] for r in attn], axis=1)
        _close(got, ref[i], name)
    for r, res in enumerate(attn):
        calls = res[(impl, causal)]["calls"]
        want = 1 if impl == "ulysses" else (r + 1 if causal else n)
        assert calls == {"flash_forward": want, "flash_bwd_dq": want,
                         "flash_bwd_dkv": want}, (r, calls)


# ------------------------------------------------------------ SP loss

def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_loss_and_grads_match_reference(groups, n, impl):
    """The global mean NLL and every parameter's gradient (summed over
    the seq ranks, the same on each) against ``jax.value_and_grad`` of
    ``make_sp_loss`` on the same weights and tokens."""
    _, sp = groups[n]
    cfg, tree, tokens = _sp_setup(n)
    mesh = make_mesh(fsdp=1, seq=n, devices=jax.devices()[:n])
    loss, grads = jax.jit(jax.value_and_grad(
        make_sp_loss(cfg, mesh, attn_impl=impl)))(tree, jnp.asarray(tokens))
    ref = dict(_leaves(jax.device_get(grads)))
    for rank, res in enumerate(sp):
        got = res[impl]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for name, g in _leaves(got["grads"]):
            _close(g, ref[name], f"rank {rank} {name}")
