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
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig, init_params
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.ops import build
from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
from k8s_operator_libs_tpu_torch.utils.device import resolve_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_library_name_tracks_source_and_flags():
    path = build.library_path("paged_decode")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libpaged_decode-") and path.suffix == ".so"
    assert build.library_path("paged_decode") == path


def test_cuda_entry_points_refuse_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tpaged.init_paged_cache(LlamaConfig.tiny(), [16])


def _case(device, pool_dtype, q_dtype, lengths, H=32, KV=8, Dh=128, BS=16,
          MB=64, seed=0):
    """Ragged lengths, a shuffled table and NaN in every dead block."""
    gen = np.random.default_rng(seed)
    B = len(lengths)
    NB = B * MB + 1
    table = gen.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    live = {int(table[b, m]) for b in range(B)
            for m in range(min(lengths[b] // BS + 1, MB))}
    dead = sorted(set(range(NB)) - live)
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
        ks, vs = (x.contiguous().to(device) for x in s)
    else:
        pools = f.to(pool_dtype)
        pools[:, dead] = float("nan")
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
