"""The PyTorch port's building blocks against the JAX reference on the CPU:
configs, the weight bridge, RMSNorm/RoPE, block planning, row
quantization and the paged write — plus the rule that the port imports
neither JAX nor the JAX package."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.models import paged as tpaged

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once: keep torch's CPU
    thread pool small so these tests do not crowd out timing-sensitive
    tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["tiny", "small", "bench_mfu", "llama3_8b"])
def test_config_fields_match_reference(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jnp.dtype(jf.pop("dtype")).name == convert.dtype_name(
        tf.pop("dtype"))
    assert jf == tf
    assert j.head_dim == t.head_dim


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trips_bit_exactly(dtype):
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.dtype(dtype))
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), cfg))
    params = convert.to_torch(tree, device="cpu")
    assert params["blocks"]["wq"].dtype == convert.torch_dtype(dtype)
    assert params["blocks"]["attn_norm"].dtype == torch.float32
    back = convert.to_numpy(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert got.tobytes() == np.asarray(leaf).tobytes(), path


def test_bridge_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        convert.to_torch({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        tllama.init_params(tllama.LlamaConfig.tiny())


def test_port_init_params_layout_matches_reference():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    ref = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    got = tllama.init_params(tcfg, seed=0, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert convert.dtype_name(t.dtype) == jnp.dtype(leaf.dtype).name
    # fp32 normal * 1/sqrt(fan_in): the spread follows fan_in
    wo = got["blocks"]["wo"].float()
    assert abs(wo.std().item() * np.sqrt(128) - 1.0) < 0.1
    again = tllama.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["lm_head"], got["lm_head"])


def _bf16_ulps(a, b):
    ia = np.asarray(a, ml_dtypes.bfloat16).view(np.int16).astype(np.int32)
    ib = np.asarray(b, ml_dtypes.bfloat16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib).max()


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 128)).astype(np.float32) * 3
    w = rng.standard_normal((128,)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = convert.tensor_from_numpy(np.asarray(jx))
    j_norm = np.asarray(jllama.rms_norm(jx, jnp.asarray(w)), np.float32)
    t_norm = tllama.rms_norm(tx, torch.as_tensor(w)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(t_norm, j_norm, rtol=1e-6, atol=1e-6)
    else:
        assert _bf16_ulps(t_norm, j_norm) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_pos", [1, 8192])
def test_rope_matches_reference(dtype, max_pos):
    """fp32 within 1e-6 and bf16 within 1 ulp, plus the one gap that is
    not the port's: XLA's CPU fp32 ``exp`` is not correctly rounded (6 of
    the 64 frequencies at Dh 128 are 1 ulp off; torch's are correctly
    rounded), so an angle may differ by position * 2^-23 and the output
    by sqrt(2) * |x| times that."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 128)).astype(np.float32) * 3
    pos = rng.integers(0, max_pos, size=(2, 5)).astype(np.int32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = convert.tensor_from_numpy(np.asarray(jx))
    ref = np.asarray(jllama.rope(jx, jnp.asarray(pos), 500000.0), np.float32)
    got = tllama.rope(tx, torch.as_tensor(pos), 500000.0).float().numpy()
    xmax = np.abs(x).max(axis=-1, keepdims=True)
    angle_gap = np.sqrt(2) * xmax * pos[..., None, None] * 2.0 ** -23
    own = 1e-6 + 1e-6 * np.abs(ref) if dtype == "float32" else _bf16_ulp(ref)
    assert (np.abs(got - ref) <= own + angle_gap).all()


@pytest.mark.parametrize("caps,bs", [([5, 17, 9], 8), ([64, 64], 16),
                                     ([1], 4), ([33, 2, 100, 16], 16)])
def test_plan_blocks_identical(caps, bs):
    jt, jnb = jpaged.plan_blocks(caps, bs)
    tt, tnb = tpaged.plan_blocks(caps, bs)
    assert jnb == tnb
    np.testing.assert_array_equal(jt, tt)


def test_quantize_rows_bit_exact():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((3, 7, 2, 32)).astype(np.float32)
    vals[0, 0, 0] = 0.0                       # all-zero row: the 1e-12 floor
    vals[1, 2, 1, :4] = [1.27, -1.27, 0.005, -0.005]   # halfway roundings
    jq, js = jpaged._quantize_rows(jnp.asarray(vals))
    tq, ts = tpaged._quantize_rows(torch.as_tensor(vals))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_paged_write_matches_reference_and_masks_past_the_row():
    """In-row writes land exactly where the reference's scatter puts
    them; writes whose logical block lies past the table row (which the
    reference drops) touch no block but the scratch block."""
    rng = np.random.default_rng(2)
    table, nb = tpaged.plan_blocks([20, 12], 8)         # MB = 3, NB = 6
    pool = rng.standard_normal((nb, 8, 2, 4)).astype(np.float32)
    lengths = np.asarray([14, 20], np.int32)            # seq 1 crosses MB*BS
    vals = rng.standard_normal((2, 6, 2, 4)).astype(np.float32)
    ref = np.asarray(jpaged._paged_write(
        jnp.asarray(pool), jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(vals)))
    got = tpaged._paged_write(torch.as_tensor(pool.copy()),
                              torch.as_tensor(table),
                              torch.as_tensor(lengths),
                              torch.as_tensor(vals)).numpy()
    scratch = nb - 1
    np.testing.assert_array_equal(got[:scratch], ref[:scratch])
    assert not np.array_equal(got[:scratch], pool[:scratch])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "k8s_operator_libs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # spawned ranks re-import their target's module: it must not pull JAX
    files.append(REPO / "tests" / "torch_parallel_ranks.py")
    names = {str(p.relative_to(REPO)) for p in files}
    assert {f"k8s_operator_libs_tpu_torch/{m}" for m in (
        "ops/attention.py", "parallel/fsdp.py", "data/loader.py",
        "train/harness.py", "train/cli.py", "train/__main__.py",
        "models/moe.py", "parallel/expert.py", "obs/goodput.py",
        "utils/comm.py", "utils/mesh.py", "parallel/distributed.py",
        "parallel/launch.py", "parallel/ring_attention.py",
        "parallel/ulysses.py", "parallel/long_context.py",
        "parallel/pipeline.py", "parallel/composed.py",
        "train/uploader.py", "train/__init__.py",
        "utils/threads.py", "obs/timeline.py", "obs/causes.py",
        "obs/reqtrace.py", "obs/metrics.py", "core/objects.py",
        "core/serde.py", "core/client.py", "core/liveclient.py",
        "wire.py", "router.py", "market/arbiter.py", "market/metrics.py",
        "market/__init__.py", "market/demand.py", "api/__init__.py",
        "api/v1alpha1.py", "core/fakecluster.py", "core/drain.py",
        "core/cachedclient.py", "obs/journey.py", "upgrade/__init__.py",
        "upgrade/consts.py", "upgrade/util.py",
        "upgrade/node_state_provider.py", "upgrade/cordon_manager.py",
        "upgrade/drain_manager.py", "upgrade/pod_manager.py",
        "upgrade/validation_manager.py",
        "upgrade/safe_driver_load_manager.py", "upgrade/groups.py",
        "upgrade/sharding.py", "upgrade/upgrade_state.py",
        "upgrade/metrics.py", "upgrade/mocks.py", "core/resilience.py",
        "obs/tsdb.py", "obs/alerts.py", "obs/slo.py", "obs/usage.py",
        "health/__init__.py", "health/consts.py", "health/probes.py",
        "health/classifier.py", "health/remediation.py",
        "health/monitor.py", "health/metrics.py", "gpu/operator.py",
        "consts.py", "core/httpapi.py", "core/leaderelection.py",
        "obs/profile.py", "obs/billing.py", "crdutil/__init__.py",
        "crdutil/crdutil.py", "apply_crds.py", "operator.py",
        "obs/attribution.py", "chaos/__init__.py", "chaos/__main__.py",
        "chaos/faults.py", "chaos/scenario.py", "chaos/injector.py",
        "chaos/invariants.py", "chaos/campaign.py",
        "chaos/crash/__init__.py", "chaos/crash/__main__.py",
        "chaos/crash/registry.py", "chaos/crash/explorer.py",
        "status.py")} <= names
    assert len(files) > 20
    banned = ("jax", "jaxlib", "ml_dtypes", "k8s_operator_libs_tpu")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports " \
                                       f"{name}"


def test_port_imports_yaml_only_inside_a_function():
    """PyYAML is not on every machine the port runs on: the live client
    imports it only to read a kubeconfig that is not JSON, so no port
    module imports it when it is imported."""
    files = sorted((REPO / "k8s_operator_libs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")

    def module_level(node):
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                yield child
                yield from module_level(child)

    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in module_level(tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert all(n.split(".")[0] != "yaml" for n in names), \
                f"{path.relative_to(REPO)} imports yaml at module level"
