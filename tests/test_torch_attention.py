"""The port's flash attention (``k8s_operator_libs_tpu_torch/ops/
attention.py``) against the JAX reference on the CPU: the plain versions
of A-K1 (forward) and A-K2/A-K3 (backward) against JAX's
``reference_attention(_with_lse)`` and against the Pallas kernels run in
interpret mode, and the autograd Function's CPU dispatch. The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.ops import attention as jattn
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(B, T, H, KV, Dh, dtype="float32", seed=0):
    """q, k, v and a cotangent from numpy, as JAX arrays and tensors."""
    rng = np.random.default_rng(seed)
    shapes = ((B, T, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh), (B, T, H, Dh))
    jx = [jnp.asarray(rng.standard_normal(s).astype(np.float32),
                      jnp.dtype(dtype)) for s in shapes]
    tx = [convert.tensor_from_numpy(np.asarray(a)) for a in jx]
    return jx, tx


def _np(t):
    return t.detach().float().numpy()


def _scaled_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(1.0, float(np.abs(ref).max())))


def _float64_attention(q, k, v, causal):
    """out [B, T, H, Dh] and base-e lse [B, H, T] in float64 from the
    same (exactly widened) inputs: the yardstick each side is held to."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.float32), np.float64)
               for a in (q, k, v))
    B, T, H, Dh = q.shape
    G = H // k.shape[2]
    k = np.repeat(k, G, axis=2)
    v = np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p / l, v)
    return out, (m + np.log(l))[..., 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (6, 2)])
def test_plain_forward_matches_reference(dtype, causal, H, KV):
    """Each side, JAX's reference and the port's plain version, is held
    on its own to a float64 evaluation of the same inputs, so a failure
    names the side that moved. fp32: summation order only. bf16: each
    side rounds the normalised probabilities and the output to bf16 (one
    ulp, 2^-8 relative, each), so allow 2^-7 of max(1, |out|)."""
    (q, k, v, _), (tq, tk, tv, _) = _inputs(2, 37, H, KV, 32, dtype)
    ref, ref_lse = jattn.reference_attention_with_lse(q, k, v, causal)
    out, lse = tattn.reference_attention_with_lse(tq, tk, tv, causal)
    assert out.dtype == convert.torch_dtype(dtype)
    assert lse.shape == (2 * KV, H // KV, 37) and lse.dtype == torch.float32
    want, want_lse = _float64_attention(q, k, v, causal)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for side, got, got_lse in (
            ("JAX reference_attention_with_lse", np.asarray(ref, np.float32),
             np.asarray(ref_lse).reshape(2, H, 37)),
            ("port reference_attention_with_lse", _np(out),
             _np(lse).reshape(2, H, 37))):
        err = _scaled_err(got, want)
        assert err <= tol, f"{side}: out off float64 by {err:.3e} > {tol}"
        np.testing.assert_allclose(got_lse, want_lse, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{side}: lse")
    got = tattn.reference_attention(tq, tk, tv, causal)
    assert torch.equal(got, out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (6, 2)])
def test_plain_backward_matches_reference_vjp(causal, H, KV):
    """flash_backward_plain, which recomputes P from the saved lse,
    against JAX's autograd of reference_attention, fp32: the test_ops
    tolerance (summation order)."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(2, 45, H, KV, 64, seed=1)
    _, vjp = jax.vjp(lambda *a: jattn.reference_attention(*a, causal),
                     q, k, v)
    ref = vjp(g)
    out, lse = tattn.reference_attention_with_lse(tq, tk, tv, causal)
    got = tattn.flash_backward_plain(tq, tk, tv, out, lse, tg, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-5,
                                   rtol=5e-4, err_msg=name)


@pytest.fixture
def pallas_interpret():
    jattn.INTERPRET = True
    old = jattn.MAX_BLOCK
    yield
    jattn.INTERPRET = False
    jattn.MAX_BLOCK = old


# fp32: summation order (test_ops.py's own flash-vs-reference tolerance).
# bf16: the Pallas kernels round q * scale * log2e to bf16 (its constant
# too: 2^-9 relative), P before P V and dS before dS K, which the plain
# version does not: ~1-2% of P at these scores, so 2e-2 of max(1, |out|)
# forward and 5e-2 backward.
@pytest.mark.parametrize("dtype,max_block,causal", [
    ("float32", 512, True),
    ("float32", 512, False),
    ("float32", 128, True),            # two q-blocks and two k-chunks
    ("bfloat16", 512, True),
])
def test_plain_matches_pallas_kernels(pallas_interpret, dtype, max_block,
                                      causal):
    jattn.MAX_BLOCK = max_block
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(1, 256, 4, 2, 128, dtype,
                                             seed=2)
    out, lse = jattn._flash_forward(q, k, v, causal)
    dq, dk, dv = jattn._flash_backward(q, k, v, out, lse, g, causal)
    t_out, t_lse = tattn.reference_attention_with_lse(tq, tk, tv, causal)
    t_grads = tattn.flash_backward_plain(
        tq, tk, tv, convert.tensor_from_numpy(np.asarray(out)),
        convert.tensor_from_numpy(np.asarray(lse)), tg, causal)
    tol_fwd, tol_bwd = (2e-5, 5e-5) if dtype == "float32" else (2e-2, 5e-2)
    assert _scaled_err(_np(t_out), out) <= tol_fwd
    assert _scaled_err(_np(t_lse), lse) <= tol_fwd * 10
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, (dq, dk, dv)):
        assert _scaled_err(_np(a), b) <= tol_bwd, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("Dh", [64, 128])
def test_q_multiplier_rounds_like_jax(dtype, Dh):
    """The kernels scale q by ``scale * log2e`` rounded to the storage
    dtype, as a weakly typed Python float meets a JAX array."""
    c = jattn.LOG2E / math.sqrt(Dh)
    ref = float(np.asarray(jnp.ones((1,), jnp.dtype(dtype)) * c,
                           np.float32)[0])
    assert tattn._q_multiplier(convert.torch_dtype(dtype), Dh) == ref


def test_function_takes_the_plain_path_on_cpu():
    """On CPU tensors the Function runs the plain versions, counts them as
    plain calls (never as launches), and its gradients equal autograd
    through reference_attention."""
    _, (q, k, v, g) = _inputs(1, 30, 8, 2, 32, seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    tattn.reset_launch_counts()
    out = tattn.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert tattn.PLAIN_CALLS == {"flash_forward": 1, "flash_bwd_dq": 1,
                                 "flash_bwd_dkv": 1}
    assert set(tattn.LAUNCHES.values()) == {0}
    ref_out = tattn.reference_attention(q, k, v)
    ref = torch.autograd.grad(ref_out, (q, k, v), g)
    assert torch.equal(out, ref_out)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_with_lse_matches_reference_layout():
    (q, k, v, _), (tq, tk, tv, _) = _inputs(2, 20, 4, 2, 32, seed=4)
    ref, ref_lse = jattn.flash_attention_with_lse(q, k, v)
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv)
    assert tuple(lse.shape) == ref_lse.shape == (2, 4, 20, 1)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float16, "wgmma"),
                                         (torch.float32, "fma")])
def test_backward_route_by_dtype(dtype, route, Dh):
    """bf16/fp16 take the tensor-core kernels (flash_attention_tc.cu), in
    both directions; fp32 keeps the FMA kernels, whose fp32 parity TF32
    would break."""
    assert tattn.kernel_route(dtype, Dh) == route


@pytest.mark.parametrize("dtype,Dh", [(torch.float64, 128), (torch.int8, 64),
                                      (torch.bfloat16, 96),
                                      (torch.float32, 256)])
def test_backward_route_refuses_what_neither_takes(dtype, Dh):
    with pytest.raises(ValueError):
        tattn.kernel_route(dtype, Dh)


@pytest.mark.parametrize("name", ["flash_forward", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
@pytest.mark.parametrize("route,source,symbol_suffix", [
    ("wgmma", "flash_attention_tc", "_tc_launch"),
    ("fma", "flash_attention", "_launch"),
])
def test_launcher_resolves_the_route_source_and_entry_point(
        monkeypatch, name, route, source, symbol_suffix):
    """Each route's launcher loads its own source and binds the entry point
    that the source defines, with one ctypes argument per C parameter: the
    wgmma forward is ``flash_forward_tc_launch`` of flash_attention_tc.cu.
    Checked through a stand-in for the built library (no GPU, no nvcc)."""
    loaded = []

    class Library:
        def __getattr__(self, symbol):
            fn = type("Fn", (), {})()
            fn.symbol = symbol
            return fn

    def fake_load(src):
        loaded.append(src)
        return Library()

    monkeypatch.setattr(tattn.build, "load", fake_load)
    monkeypatch.setattr(tattn, "_fns", {})
    fn = tattn._launcher(name, route)
    symbol = name + symbol_suffix
    assert loaded == [source] and tattn._ROUTE_SOURCES[route][0] == source
    assert fn.symbol == symbol
    text = (tattn.build.CSRC_DIR / f"{source}.cu").read_text()
    head = f"int {symbol}(int kind,"
    assert text.count(head) == 1
    params = text[text.index(head):].split(")", 1)[0].split(",")
    assert len(fn.argtypes) == len(params)
    assert tattn._launcher(name, route) is fn          # bound once
    assert loaded == [source]


def test_paged_launcher_binds_the_c_signature(monkeypatch):
    """The paged-decode wrapper binds ``paged_decode_launch`` of
    paged_decode.cu with one ctypes argument per C parameter, pointers
    (the workspace included) as c_void_p. Checked through a stand-in for
    the built library (no GPU, no nvcc)."""
    import ctypes

    from k8s_operator_libs_tpu_torch.ops import paged_attention as pattn
    loaded = []

    class Library:
        def __getattr__(self, symbol):
            fn = type("Fn", (), {})()
            fn.symbol = symbol
            return fn

    def fake_load(src):
        loaded.append(src)
        return Library()

    monkeypatch.setattr(pattn.build, "load", fake_load)
    monkeypatch.setattr(pattn, "_fn", None)
    fn = pattn._launcher()
    assert loaded == ["paged_decode"] and fn.symbol == "paged_decode_launch"
    text = (pattn.build.CSRC_DIR / "paged_decode.cu").read_text()
    head = "int paged_decode_launch("
    assert text.count(head) == 1
    params = [p.split() for p in text[text.index(head) + len(head):]
              .split(")", 1)[0].split(",")]
    assert len(fn.argtypes) == len(params) == 21
    for (ctype, *_), argtype in zip(params, fn.argtypes):
        want = ctypes.c_int if ctype == "int" else ctypes.c_void_p
        assert argtype is want, (ctype, argtype)
    assert pattn._launcher() is fn                    # bound once
    assert loaded == ["paged_decode"]


def test_cuda_wrappers_refuse_cpu_tensors():
    _, (q, k, v, g) = _inputs(1, 16, 4, 2, 64)
    lse = torch.zeros((2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_forward_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_dq_cuda(q, k, v, g, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_dkv_cuda(q, k, v, g, lse, lse)
